"""ctypes binding to the native C++ golden renderer (native/golden.cpp).

The C++ renderer implements the reference's sequential stepping and
per-step renormalisation (the spec's divergences #1 and #3), so it is the
CPU baseline to time the port against, not a gate: ``cpu_reference`` is
the spec.

The library is built at the first ``render`` (never at import) with
``g++`` and the JAX package's flags (``-O3 -march=native``), so that the
two bindings' libraries agree bit for bit. It goes to the gitignored
``tpu_renderer_torch/_build/libgolden_<key>.so``, where ``<key>`` hashes
the source, the flags and the host's CPU (``platform.machine()`` and the
``model name`` and ``flags`` lines of /proc/cpuinfo): ``-march=native``
code built on one host may raise SIGILL on another, and a copy of the
checkout can carry the build directory across hosts. The build writes a
temporary name and renames it into place, so processes that build at once
each see a whole library. ``render`` raises with the compiler's output
when the build fails; ``available()`` only tells tests whether there is a
compiler to build with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "golden.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
NATIVE_VERSION = 2  # tr_native_version() of the C interface bound below

_lock = threading.Lock()
_lib = None


def cpu_info() -> dict:
    """The fields of the first processor in /proc/cpuinfo ("model name",
    "flags", ...; empty where there is none)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip() and info:
                    break
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return info


def library_path(src: Path = SRC, build_dir: Path | None = None) -> Path:
    """Where the library of ``src`` (this package's golden.cpp by default)
    for these flags and this host CPU (the machine, model name and flags)
    lives in ``build_dir`` (default ``BUILD_DIR``), built or not."""
    info = cpu_info()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(src).read_bytes())
    for part in (platform.machine(), info.get("model name", ""),
                 info.get("flags", "")):
        h.update(b"\0" + part.encode())
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    return build_dir / f"libgolden_{h.hexdigest()[:16]}.so"


def build(src: Path = SRC, build_dir: Path | None = None) -> Path:
    """Compile ``src`` into ``library_path(src, build_dir)`` unless that
    key's library is there; returns its path. g++ writes a name of this
    process and thread, renamed into place when whole, so any number of
    processes may build one key at once. Raises RuntimeError with the
    compiler's output when g++ fails."""
    out = library_path(src, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp.so")
    cmd = ["g++"] + CXX_FLAGS + ["-o", str(tmp), str(src), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def open_library(path) -> ctypes.CDLL:
    """Load a built golden.cpp and declare its C interface. Any source of
    that interface loads (this package's copy or the JAX package's
    ``tpu_renderer/native/golden.cpp``): both export ``tr_native_version()
    == 2``, checked here."""
    lib = ctypes.CDLL(str(path))
    lib.tr_native_version.argtypes = []
    lib.tr_native_version.restype = ctypes.c_int
    version = lib.tr_native_version()
    if version != NATIVE_VERSION:
        raise RuntimeError(f"{path}: tr_native_version() is {version}, "
                           f"not {NATIVE_VERSION}")
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tr_render_object.argtypes = [
        u32p, f32p, ctypes.c_int, ctypes.c_int,  # color, depth, H, W
        f32p, f32p, f32p, f32p, ctypes.c_int,  # verts..uvs, count
        f32p, f32p, f32p, ctypes.c_int, f32p,  # p, tr, amb, nl, lights
        u32p, ctypes.c_int, ctypes.c_int,  # texture, th, tw
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # phong, nt, avx
        ctypes.c_int,  # filter_bilinear
    ]
    lib.tr_render_object.restype = None
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def available() -> bool:
    """Whether a C++ compiler is on the PATH (for tests to skip without
    one). The card's smoke script never asks: it renders, and a failed
    build raises."""
    return shutil.which("g++") is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def render(scene, transform, lights, height, width, clear_color=0,
           num_threads=0, use_avx=-1, library=None):
    """Native end-to-end render; the same scene / transform / lights dicts
    as ``cpu_reference.render``. ``num_threads`` 0 is the hardware
    concurrency; ``use_avx`` -1 auto, 0 scalar (the reference's exact
    semantics), 1 force AVX; ``library`` an ``open_library`` result to
    render with (default: this package's, built at first use). Returns
    (color (H, W) u32, depth (H, W) f32).
    """
    lib = _load() if library is None else library
    color = np.full((height, width), np.uint32(clear_color), np.uint32)
    depth = np.full((height, width), np.float32(-3.4028235e38), np.float32)

    tr5 = np.array(
        [transform["distance_above_target"], transform["focal_length"],
         transform["meters_to_pixels"], transform["screen_center"][0],
         transform["screen_center"][1]], np.float32)
    ambient = np.ascontiguousarray(lights["ambient"], np.float32).reshape(4)
    lp = np.ascontiguousarray(lights["light_p"], np.float32).reshape(-1, 3)
    li = np.ascontiguousarray(
        lights["light_intensity"], np.float32).reshape(-1, 4)
    l7 = np.ascontiguousarray(np.concatenate([lp, li], axis=1), np.float32)

    for obj, cfg in scene:
        verts = np.ascontiguousarray(obj["vertices"], np.float32)
        cols = np.ascontiguousarray(obj["colors"], np.float32)
        nrms = np.ascontiguousarray(obj["normals"], np.float32)
        uvs = np.ascontiguousarray(obj["uvs"], np.float32)
        p = np.ascontiguousarray(obj["p"], np.float32).reshape(3)
        tex = cfg.get("texture")
        if tex is not None:
            tex = np.ascontiguousarray(tex, np.uint32)
            th, tw = tex.shape
            texp = _u32p(tex)
        else:
            th = tw = 0
            texp = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint32))
        lib.tr_render_object(
            _u32p(color), _f32p(depth), height, width,
            _f32p(verts), _f32p(cols), _f32p(nrms), _f32p(uvs),
            verts.shape[0], _f32p(p), _f32p(tr5), _f32p(ambient),
            lp.shape[0], _f32p(l7), texp, th, tw,
            1 if cfg.get("phong") else 0, num_threads, use_avx,
            1 if cfg.get("filter_mode", "nearest") == "bilinear" else 0,
        )
    return color, depth
