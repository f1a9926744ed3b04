"""How the port's CUDA kernels are built: each source's nvcc command line
carries the Hopper target and its own flags, and the built library's
name changes with them.  Nothing is compiled here (no nvcc on the CPU
machine)."""
import pytest

from havc_tpu_torch import kernels

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)


@pytest.mark.parametrize("name,own,absent", [
    ("post_chain", ("-fmad=false",), ()),
    ("window_attn", (), ("-fmad=false",)),
    ("window_attn_tc", (), ("-fmad=false",)),
    ("unet_join", ("-fmad=false",), ()),
])
def test_build_command_carries_target_and_own_flags(name, own, absent):
    cmd = kernels.build_command(name, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert cmd[cmd.index("-o") + 1] == "out.so"
    assert "--use_fast_math" not in cmd
    for flag in own:
        assert flag in cmd
    for flag in absent:
        assert flag not in cmd


def test_flags_are_part_of_the_target(monkeypatch):
    before = kernels._target("window_attn")
    assert before == kernels._target("window_attn")  # deterministic
    monkeypatch.setitem(kernels.SOURCES, "window_attn",
                        kernels.SOURCES["window_attn"]._replace(flags=("-fmad=false",)))
    after = kernels._target("window_attn")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libwindow_attn-")


def test_every_source_has_entry_points():
    for name, kernel in kernels.SOURCES.items():
        assert (kernels._CSRC / f"{name}.cu").exists()
        src = (kernels._CSRC / f"{name}.cu").read_text()
        for entry in kernel.entries:
            assert f'extern "C"' in src and f" {entry}(" in src
