"""Builds the port's CUDA kernels at first use and binds them with ctypes.

``opus_tpu_torch/csrc/*.cu`` (and only those sources) are compiled by
``nvcc`` for sm_90a (one process per source, all started together) and
linked into one shared library with a plain C interface,
``.torch_build/libopus_tpu_torch.so`` at the repository root.  The file
name carries a hash of the sources, so an edit rebuilds and a fresh
checkout builds on its first call.  A failed build raises with nvcc's
stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / ".torch_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lib = None
ptxas_log = ""            # nvcc's resource report (registers, stack, spills)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libopus_tpu_torch.{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library of their hash exists yet: one
    ``nvcc -c`` per source, all started together, then one link."""
    global ptxas_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        obj = Path(f"{stem}.{src.stem}.o")
        cmd = [nvcc, *FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = [proc.communicate()[1] for _c, _o, proc in jobs]
    for (cmd, _obj, proc), err in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}")
    tmp = Path(f"{stem}.tmp")
    cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
           *(str(obj) for _c, obj, _p in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    for _c, obj, _p in jobs:
        obj.unlink()
    os.replace(tmp, out)
    ptxas_log = "".join(logs)
    return out


def bind_celt_dec_frame(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of kernel K1's entry points on ``lib`` (this
    library, or a build of ``celt_dec_frame.cu`` alone)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.opus_celt_dec_frame_launch.argtypes = [
        vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp]
    lib.opus_celt_dec_frame_launch.restype = ci
    lib.opus_celt_dec_frame_occupancy.argtypes = [ci, vp]
    lib.opus_celt_dec_frame_occupancy.restype = ci
    lib.opus_celt_dec_frame2_launch.argtypes = [
        vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.opus_celt_dec_frame2_launch.restype = ci
    lib.opus_celt_dec_frame2_occupancy.argtypes = [ci, vp]
    lib.opus_celt_dec_frame2_occupancy.restype = ci
    return lib


def bind_celt_enc_frame(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of kernel K3's entry points on ``lib`` (this
    library, or a build of ``celt_enc_frame.cu`` alone)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.opus_celt_enc_frame_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp]
    lib.opus_celt_enc_frame_launch.restype = ci
    lib.opus_celt_enc_frame_occupancy.argtypes = [ci, vp]
    lib.opus_celt_enc_frame_occupancy.restype = ci
    return lib


def bind_silk_lpc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of kernel K4's launch on ``lib`` (this library, or a
    build of a ``silk_lpc.cu`` alone)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.opus_silk_lpc_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.opus_silk_lpc_launch.restype = ci
    return lib


def library() -> ctypes.CDLL:
    """The built library, with argument types set on its entry points."""
    global _lib
    if _lib is None:
        lib = bind_silk_lpc(bind_celt_enc_frame(bind_celt_dec_frame(
            ctypes.CDLL(str(build())))))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.opus_deemphasis_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ctypes.c_float, vp]
        lib.opus_deemphasis_launch.restype = ci
        lib.opus_silk_lpc_occupancy.argtypes = [ci, vp]
        lib.opus_silk_lpc_occupancy.restype = ci
        lib.opus_kbench_launch.argtypes = [ci, vp, vp, vp, ci, ci, vp]
        lib.opus_kbench_launch.restype = ci
        lib.opus_cuda_error_string.argtypes = [ci]
        lib.opus_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def geometry(entry: str, arg: int) -> dict:
    """A kernel's launch geometry on the current card, from its
    ``opus_*_occupancy(arg, info)`` entry point: shared memory per block,
    warps per block, resident blocks and warps per SM, registers and local
    memory per thread."""
    info = (ctypes.c_int * 5)()
    check_launch(getattr(library(), entry)(arg, info), entry)
    smem, warps, blocks, regs, local = list(info)
    return dict(smem_per_block=smem, warps_per_block=warps,
                blocks_per_sm=blocks, warps_per_sm=blocks * warps,
                registers=regs, local_bytes=local)


def check_launch(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = library().opus_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} ({rc})")
