"""opus_tpu_torch.cuda_build without the CUDA toolkit: a stand-in nvcc
records its calls, so the build's plan is checked here (one compile per
source, then one link; the objects are removed; a failed compile raises
with its stderr and nothing is cached)."""

import os
import stat

import pytest

from opus_tpu_torch import cuda_build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
for a in "$@"; do
  case "$a" in *broken*) echo "error: broken source" >&2; exit 2;; esac
done
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "ptxas info    : Used 1 registers" >&2
: > "$out"
"""


def _fake(tmp_path, monkeypatch, names):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for n in names:
        (csrc / n).write_text(f"// {n}\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    return log


def test_torch_cuda_build_one_nvcc_per_source_then_link(tmp_path,
                                                       monkeypatch):
    log = _fake(tmp_path, monkeypatch, ["a.cu", "b.cu", "c.cu"])
    out = cuda_build.build()
    assert out.exists() and out == cuda_build.library_path()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == 3 and len(calls) == 4
    assert all("-fmad=false" in c and "sm_90a" in c for c in compiles)
    assert "-shared" in calls[-1]
    assert sorted(os.listdir(out.parent)) == [out.name]     # objects gone
    assert cuda_build.ptxas_log.count("Used 1 registers") == 3
    assert cuda_build.build() == out and len(
        log.read_text().splitlines()) == 4                 # cached by hash


def test_torch_cuda_build_failure_raises(tmp_path, monkeypatch):
    _fake(tmp_path, monkeypatch, ["a.cu", "broken.cu"])
    with pytest.raises(RuntimeError, match="broken source"):
        cuda_build.build()
    assert not cuda_build.library_path().exists()
