"""The system under test, ``havc_tpu_torch.HAVC_main``, and the one place
the benchmark touches the port: its engine registry (where the seeded
engines go), its stage timer and the caches it keeps between calls."""
from __future__ import annotations

import importlib

import torch

from . import weights

__all__ = ["Program"]

PACKAGE = "havc_tpu_torch"


class Program:
    """``HAVC_main(clip, **config["havc_main"])`` on ``device`` with the
    configuration's engines, each holding the benchmark's seeded weights."""

    def __init__(self, config: dict, device):
        self.pkg = importlib.import_module(PACKAGE)
        self.engines = importlib.import_module(f"{PACKAGE}.engines")
        self.profiling = importlib.import_module(f"{PACKAGE}.utils.profiling")
        self.device = self.profiling.resolve_device(device)
        self.kwargs = dict(config["havc_main"])
        for spec in config["engines"]:
            # the names and shapes are the reference's: the benchmark's weights
            state = weights.make_state(spec, config["weight_seed"], self.device, "havc_ref")
            module = weights.build_engine(spec, state, PACKAGE)
            self.engines.registry._cache[(spec["family"], spec["name"], self.device)] = module

    def __call__(self, frames: torch.Tensor):
        """The colorized clip (``.frames``, ``.sc``) of float32 RGB frames."""
        return self.pkg.HAVC_main(self.pkg.Clip(frames=frames), device=self.device,
                                  **self.kwargs)

    def stage_timing(self, on: bool) -> None:
        self.profiling.reset_stages()
        self.profiling.enable_profiling(on)

    def stage_times(self) -> dict:
        """{stage: seconds} since ``stage_timing(True)``."""
        return {k: v[0] for k, v in self.profiling.stage_times().items()}

    def close(self) -> None:
        """Drop every engine and cached engine state the port holds."""
        self.profiling.enable_profiling(False)
        self.engines.registry.clear()
        exemplar = importlib.import_module(f"{PACKAGE}.exemplar")
        exemplar._ENGINE_CACHE.clear()
