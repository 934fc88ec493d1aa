"""``repro_torch.kernels._build`` without the CUDA toolkit: a stand-in
compiler takes nvcc's place, so the build's bookkeeping (the library path,
the compiler's output kept per source, ptxas's report read from it, a
failed build raising with the message) runs on any machine."""
from __future__ import annotations

import os
import stat

import pytest

from repro_torch.kernels import _build

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2wg12small_kernelILi64EEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg12small_kernelILi64EEEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2wg12large_kernelILi256EEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg12large_kernelILi256EEEvPf
    272 bytes stack frame, 308 bytes spill stores, 316 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A ``csrc/probe.cu`` and a compiler that writes the library named by
    ``-o``, prints ``PTXAS`` and exits with the code in ``$STAND_IN_RC``."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "probe.cu").write_text("// a source the stand-in compiler never reads\n")
    (tmp_path / "ptxas.txt").write_text(PTXAS)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        ': > "$out"\n'
        f'cat "{tmp_path / "ptxas.txt"}"\n'
        'exit "${STAND_IN_RC:-0}"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    return build


def test_build_keeps_the_compiler_output_and_reads_ptxas_report(stand_in):
    path = _build.build(["probe"])["probe"]
    assert os.path.dirname(path) == str(stand_in) and os.path.exists(path)
    assert "-v" in _build.NVCC_FLAGS and _build.BUILD_LOG["probe"] == PTXAS
    assert _build.ptxas_report("probe") == {
        "_ZN2wg12small_kernelILi64EEEvPf": dict(stack=0, spill_stores=0, spill_loads=0,
                                                 registers=40),
        "_ZN2wg12large_kernelILi256EEEvPf": dict(stack=272, spill_stores=308, spill_loads=316,
                                                  registers=168),
    }


def test_a_cached_library_is_not_rebuilt_and_has_no_report(stand_in):
    path = _build.build(["probe"])["probe"]
    _build.BUILD_LOG.clear()
    assert _build.build(["probe"])["probe"] == path
    assert "probe" not in _build.BUILD_LOG and _build.ptxas_report("probe") == {}


def test_a_failed_build_raises_with_the_compiler_output(stand_in, monkeypatch):
    monkeypatch.setenv("STAND_IN_RC", "2")
    with pytest.raises(RuntimeError, match="nvcc failed:\nprobe.cu:\nptxas info"):
        _build.build(["probe"])
    assert os.listdir(stand_in) == []          # no library and no temporary file left
