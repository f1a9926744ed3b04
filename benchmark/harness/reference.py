"""The plain reference (``benchmark/reference/havc_ref``, the module the
configuration names) with the same seeded weights, run at IEEE float32; as
the control, one precision step below what the configuration states; and
the FLOPs its engines compute.

The control rounds the two operands of every product inside an engine
(convolutions, linear layers, matrix products and einsums; the products
and sums stay in the engine's own type):

* engines the configuration runs in float32 (on TF32 tensor cores) to
  bfloat16;
* engines it runs in bfloat16 to float8 e4m3, with one scale per tensor
  (its largest magnitude to 448), on top of the network run in bfloat16
  (the reference module's ``dtypes``).
"""
from __future__ import annotations

import contextlib
import importlib

import torch
from torch.overrides import TorchFunctionMode

from . import weights

__all__ = ["Reference", "round_operands", "ieee_flags"]

PACKAGE = "havc_ref"
E4M3_MAX = 448.0
F = torch.nn.functional
# the products whose leading tensor arguments (how many) are rounded
_PRODUCTS = {**dict.fromkeys((F.conv1d, F.conv2d, F.conv3d, F.conv_transpose2d, F.linear,
                              torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                              torch.bmm, torch.Tensor.bmm, torch.mm, torch.Tensor.mm), 2),
             F.scaled_dot_product_attention: 3}


@contextlib.contextmanager
def ieee_flags():
    """PyTorch's float32 products and cuDNN convolutions at IEEE."""
    found = (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision = found


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to ``fmt`` and back: "bf16", or "fp8" (e4m3, one scale
    per tensor that takes its largest magnitude to 448)."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class _RoundedProducts(TorchFunctionMode):
    """Every convolution, linear layer and matrix product inside it takes
    its two operands rounded to ``fmt``."""

    def __init__(self, fmt: str):
        super().__init__()
        self.fmt = fmt

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = _PRODUCTS.get(func)
        if n is not None:
            args = tuple(_round(a, self.fmt) if i < n and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for i, a in enumerate(args))
        elif func is torch.einsum:
            ops = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) else args[1:]
            args = (args[0], *[_round(a, self.fmt) for a in ops])
        return func(*args, **kwargs)


class _ModeHooks:
    """A fresh ``make()`` mode entered around every call of the given
    modules (calls of them do not nest)."""

    def __init__(self, modules, make):
        self.make, self.mode = make, None
        for m in modules:
            m.register_forward_pre_hook(self._enter)
            m.register_forward_hook(self._exit)

    def _enter(self, mod, args):
        if self.mode is None:
            self.mode = self.make()
            self.mode.__enter__()

    def _exit(self, mod, args, out):
        if self.mode is not None:
            self.mode.__exit__(None, None, None)
            self.done(self.mode)
            self.mode = None

    def done(self, mode) -> None:
        pass


def round_operands(modules, fmt: str) -> None:
    """Every product inside a call of ``modules`` on operands rounded to
    ``fmt``."""
    _ModeHooks(modules, lambda: _RoundedProducts(fmt))


class _FlopHooks(_ModeHooks):
    """FLOPs (``FlopCounterMode``) of every call of the given modules."""

    def __init__(self, modules):
        from torch.utils.flop_counter import FlopCounterMode

        self.flops = 0
        super().__init__(modules, lambda: FlopCounterMode(display=False))

    def done(self, mode) -> None:
        self.flops += mode.get_total_flops()


class Reference:
    """The configuration's reference module (``"reference"``) with its
    ``havc_main`` keywords, the same the program gets, on the configuration's
    engines.  ``control`` computes each engine one precision step below the
    configuration's; ``count_flops`` sums each engine family's FLOPs.  An
    engine's ``calls`` says where the rounding and the counting go: on the
    module (``"whole"``) or on its direct children, the parts the path calls
    one by one (``"parts"``)."""

    def __init__(self, config: dict, device, control: bool = False, count_flops: bool = False):
        self.engines = importlib.import_module(f"{PACKAGE}.engines")
        self.module = importlib.import_module(f"{PACKAGE}.{config['reference']}")
        self.kwargs = dict(config["havc_main"])
        self.device = torch.device(device)
        self.dtypes, self.counters, self.modules = {}, {}, []
        for e in config["engines"]:
            state = weights.make_state(e, config["weight_seed"], self.device, PACKAGE)
            module = weights.build_engine(e, state, PACKAGE)
            parts = _hooked(module, e["calls"])
            lower = control and e["precision"] == "bf16"
            self.dtypes[e["family"]] = torch.bfloat16 if lower else torch.float32
            if control:
                round_operands(parts, "fp8" if lower else "bf16")
            if count_flops:
                self.counters[e["family"]] = _FlopHooks(parts)
            self.modules.append((e["family"], e["name"], module))

    def __call__(self, frames: torch.Tensor):
        clip = importlib.import_module(f"{PACKAGE}.clip").Clip(frames=frames)
        self.engines.registry.clear()  # this side's engines, not another's
        for family, name, module in self.modules:
            self.engines.registry.install(family, name, self.device, module)
        with ieee_flags():
            return self.module.havc_main(clip, dtypes=self.dtypes, **self.kwargs)

    def flops(self) -> dict:
        return {family: c.flops for family, c in self.counters.items()}

    def close(self) -> None:
        self.engines.registry.clear()
        self.modules.clear()


def _hooked(module: torch.nn.Module, calls: str) -> list:
    """The modules the hooks go on: ``module`` itself (``"whole"``) or its
    direct children (``"parts"``)."""
    if calls == "whole":
        return [module]
    if calls == "parts":
        return list(module.children())
    raise ValueError(f"an engine's \"calls\" is \"whole\" or \"parts\", not {calls!r}")
