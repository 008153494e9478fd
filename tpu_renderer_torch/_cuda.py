"""Build and load the port's CUDA kernels.

The kernels (``csrc/*.cu``) are compiled at first use by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes. Each C entry
launches on the stream it is given, on the current device, and returns
``cudaGetLastError()``; every wrapper calls it through ``launch``, which
makes the tensors' card current for the call and raises when that is not
0.

- Target: ``sm_90a`` (Hopper).
- Float flags: ``-fmad=false -prec-div=true -prec-sqrt=true -ftz=false``
  and never ``--use_fast_math``. The JAX package and the NumPy golden
  spell out IEEE division and 1/sqrt; without FMA contraction each kernel
  is bit-equal to its plain-PyTorch version on the card.
- Cache: ``_build/libtr_kernels_<hash>.so``, keyed by a hash of the
  sources and the flags, so editing a kernel rebuilds it and a fresh
  checkout builds on its first call.

Nothing here runs at import time: a CPU-only machine (no nvcc, no card)
imports the package and runs the plain versions.

A launch's host work is kept small, since a small kernel's time is
mostly its launch: ``launch`` passes the current stream's raw handle
without building a ``torch.cuda.Stream`` object and switches the current
device only when the tensors lie on another card, ``check_tensor`` costs
one expression when the tensor is right, and ctypes caches each C entry
on the library after its first lookup.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_lib = None
_argtypes: dict[str, list] = {}
build_info: dict = {}  # path, seconds, ptxas log of the loaded library


def declare(name: str, argtypes: list) -> None:
    """Register a C entry's argument types (set when the library loads)."""
    _argtypes[name] = argtypes


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link them into the cached shared
    library; returns its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libtr_kernels_{_digest()}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return out
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{cu.stem}.o"
        cmd = [nvcc] + NVCC_FLAGS + ["-I", str(CSRC), "-c", "-o", str(obj),
                                     str(cu)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    text, failed = "", False
    for obj, proc in jobs:
        out_text, _ = proc.communicate(timeout=900)
        text += out_text
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                         + [str(obj) for obj, _ in jobs],
                         capture_output=True, text=True, timeout=900)
    text += res.stdout + res.stderr
    for obj, _ in jobs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{text}")
    secs = time.perf_counter() - t0
    log.write_text(text)
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs, cached=False, log=text)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device, *args) -> None:
    """Call C entry ``name`` with ``args`` and the raw handle of
    ``device``'s current stream, with ``device`` the current card; raise
    unless it returns 0.

    The C entries launch on the CUDA runtime's current device (and size
    their grids by its occupancy), while the stream and the pointers
    belong to the tensors' card. So the call runs under that card: when
    it is already current (every call on one card, every rank bound to
    its card) that costs one device query; otherwise the card is made
    current for the call and the caller's restored after."""
    fn = getattr(library(), name)
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check_launch(name, rc)


def check_tensor(name, t, device, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if (t.device == device and t.dtype is dtype and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_rows(name, t, device, dtype, shape) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` on ``device``
    whose rows are contiguous (a crop of a padded plane will do)."""
    if (t.device == device and t.dtype is dtype and t.shape == shape
            and t.stride(-1) == 1):
        return
    raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device} "
                     f"with contiguous rows, got {t.dtype} {tuple(t.shape)} "
                     f"strides {t.stride()} on {t.device}")


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
