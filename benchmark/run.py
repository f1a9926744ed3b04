"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``benchmark/``).
The cell's configuration, traffic mix and per-layer readers are found by
the names in ``BENCHMARK.json`` (``benchmark/harness/spec.py``).  Prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last in it ``checks``, each number compared beside its
limit, which also end standard error.  Without CUDA, with fewer cards
than the cell asks for, or with a module of JAX or the JAX package loaded
when the result is due, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _paths() -> None:
    """The harness, the reference and the port importable; every build
    and kernel cache inside the checkout."""
    for p in (HERE, os.path.join(HERE, "reference"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from harness import cell as run
    from harness import spec

    c = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"benchmark: {args.workload} needs {c.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run.run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    return run.print_result(result)


if __name__ == "__main__":
    sys.exit(main())
