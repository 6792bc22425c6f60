"""``chip_smoke.py --parent`` builds and times the parent tree's wide
GraphNetBlock libraries too: each is compiled with its width's flag
(``kernel_build.FLAGS``), and the wide phases hand their library names to
the parent's turns. Runs on the CPU: nvcc is stood in for, nothing is
built."""

import subprocess
from pathlib import Path

import chip_smoke
from graph_physics_tpu_torch.ops import kernel_build

WIDE = {f"gn_{lay}_{way}{h}": h for lay in ("nk", "csr") for way in ("fwd", "bwd")
        for h in (64, 128)}


def test_parent_builds_take_each_wide_library_with_its_width(monkeypatch, tmp_path):
    calls = {}

    class FakePopen:
        def __init__(self, cmd, **kw):
            calls[Path(cmd[cmd.index("-o") + 1]).name] = cmd

    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    monkeypatch.setattr(chip_smoke, "PARENT", tmp_path / "parent")
    monkeypatch.setattr(chip_smoke, "_parent_builds", {})
    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    chip_smoke.start_parent_builds()
    for name, h in WIDE.items():
        cmd = calls[f"lib{name}.so"]
        assert chip_smoke.PARENT_LIBS[name] == ("fused_gnblock_nk" if "_nk_" in name
                                                 else "fused_gnblock_csr")
        assert f"-DGN_WIDE_H={h}" in cmd
        assert cmd[-1].endswith(kernel_build.LIBRARIES[name][0])
    for name in chip_smoke.PARENT_LIBS:  # every library with its flags
        assert all(flag in calls[f"lib{name}.so"] for flag in kernel_build.FLAGS.get(name, ()))


def test_the_wide_phases_time_the_parents_wide_libraries():
    assert chip_smoke.gn_libs("nk", 128, True) == ("gn_nk_fwd128", "gn_nk_bwd128")
    assert chip_smoke.gn_libs("csr", 64, False) == ("gn_csr_fwd64",)
    for h in (1, 16, 32):  # this tree kept the parent's kernels there
        assert chip_smoke.gn_libs("nk", h, True) == ()
    assert all(n in chip_smoke.PARENT_LIBS for h in (64, 128) for lay in ("nk", "csr")
               for n in chip_smoke.gn_libs(lay, h, True))
