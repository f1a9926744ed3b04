"""The readings that a cell's limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... [--control-seeds 1 2 3]

In one process, on the card: for each seed, the clips a run of that seed
would check (the same pool and sample), colorized by the program
(``HAVC_main``), by the reference and, for ``--control-seeds``, by the
control (the reference one precision step below the configuration,
``harness/reference.py``), judged against the reference by the run's own
comparison (``harness/cell.compare``); prints one JSON line per seed with
the program's numbers (the lower reading) and the control's (the upper
reading).  A clip's output does not depend on what
ran before it (``HAVC_main`` keeps no state between calls), so running
the sampled clips alone reads what the window's outputs read.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    for p in (HERE, os.path.join(HERE, "reference"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import cell as run
    from harness import judge, spec
    from harness.program import Program
    from harness.reference import Reference
    from harness.traffic import as_rgb, make_pool

    c = spec.load_cell(args.workload, ROOT)
    config, mix = c.config, c.mix
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    reference = Reference(config, device)
    sides = {"program": (Program(config, device), args.seeds)}
    if args.control_seeds:
        sides["control"] = (Reference(config, device, control=True), args.control_seeds)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        pool = make_pool(mix, seed, device)
        refs = [pool.refs(i) for i in range(len(pool.clips))]
        positions = judge.sample_positions(seed, refs, mix["check_among"], mix["check_clips"])
        row = {"workload": args.workload, "seed": seed, "positions": positions,
               "refs": [refs[p % len(refs)] for p in positions]}
        for side, (program, seeds) in sides.items():
            if seed not in seeds:
                continue
            outputs = []
            for pos in positions:
                n = pos % len(pool.clips)
                got = program(as_rgb(pool.clips[n]))
                outputs.append((n, got.frames, None if got.sc is None else got.sc.sc_prev))
            row[side] = run.compare(config, pool, outputs, reference)
            del outputs
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
