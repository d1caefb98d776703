"""ctypes bindings for the native data-loading core (`native/image_core.cpp`).

Counterpart of `magicdance_tpu.data.native`: C++ JPEG/PNG decode, crop,
resize and normalize of a whole batch on a thread pool, outside the GIL
(`md_batch_load`), and the seeded random-resized-crop of the training path
(`md_batch_load_rrc`), whose crop parameters `rrc_params` replicates bit for
bit in Python.

The port compiles the repo's `native/image_core.cpp` itself, with `g++ -O3
-fPIC -std=c++17 -shared ... -ljpeg -lpng -lpthread`, into the git-ignored
`magicdance_tpu_torch/_build/` (named by a hash of the source and flags, so
an edited source is rebuilt), under an `fcntl` lock so that parallel
processes (data-parallel ranks, test workers) never load a half-written
library; it never writes into `native/`. When the library cannot be built
or loaded, the loaders take the PIL path, which is the JAX package's own
behaviour without its library: this is host-side decoding, not a kernel.
`native_available()` and `describe()` say which path runs, and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_STATUS = {"path": "pil", "reason": "not tried", "build_seconds": None}
_LOAD_LOCK = threading.Lock()  # loader worker threads ask at the same time

log = logging.getLogger(__name__)


def compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmdimage-{h.hexdigest()[:16]}.so"


def toolchain_present() -> bool:
    """A C++ compiler that finds the jpeg and png headers."""
    cxx = compiler()
    if cxx is None:
        return False
    probe = subprocess.run([cxx, "-x", "c++", "-E", "-o", os.devnull, "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n",
                           capture_output=True, text=True, timeout=60)
    return probe.returncode == 0


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its path.
    Raises with the compiler's output on failure."""
    import fcntl

    so = library_path()
    if so.exists():
        return so
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".mdimage.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # a sibling process built it while this one waited
            return so
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a loader sees no file or the whole one
        _STATUS["build_seconds"] = time.perf_counter() - t0
    return so


def _load() -> Optional[ctypes.CDLL]:
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = build()
        lib = ctypes.CDLL(str(so))
        lib.md_batch_load.restype = ctypes.c_int
        lib.md_batch_load.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.md_batch_load_rrc.restype = ctypes.c_int
        lib.md_batch_load_rrc.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
    except (OSError, RuntimeError, AttributeError, subprocess.SubprocessError) as e:
        _STATUS.update(path="pil", reason=f"native loader unavailable: {e}")
        log.warning("native image loader unavailable, decoding with PIL: %s", e)
        return None
    _LIB = lib
    built = _STATUS["build_seconds"]
    _STATUS.update(path="native", reason=(f"built {so.name} in {built:.1f} s" if built
                                          else f"loaded {so.name}"))
    return _LIB


def native_available() -> bool:
    """True when the native batch loader is loaded."""
    return _load() is not None


# JAX's name for the seeded-RRC training path: the port builds both entry
# points from one source, so it is native exactly when the loader is
native_rrc_available = native_available


def status() -> dict:
    """{"path": "native" | "pil", "reason": ..., "build_seconds": s or None}."""
    _load()
    return dict(_STATUS)


def describe() -> str:
    s = status()
    return f"{s['path']} ({s['reason']})"


def batch_load_images(
    paths: list[str],
    size: int,
    center_crop: bool = True,
    scale: float = 1.0 / 127.5,
    offset: float = -1.0,
) -> np.ndarray:
    """Decode+crop+resize+normalize a batch -> (N, size, size, 3) float32.

    Default normalization maps uint8 -> [-1, 1] (model range); use
    scale=1/255, offset=0 for pose-hint range.
    """
    lib = _load()
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        failures = lib.md_batch_load(
            arr, n, size, 1 if center_crop else 0,
            ctypes.c_float(scale), ctypes.c_float(offset),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if failures:
            raise IOError(f"native loader failed on {failures}/{n} images")
        return out
    from PIL import Image

    from magicdance_tpu_torch.data.transforms import center_crop_square, resize

    for i, p in enumerate(paths):
        img = np.asarray(Image.open(p).convert("RGB"))
        if center_crop:
            img = center_crop_square(img)
        out[i] = resize(img, size).astype(np.float32) * scale + offset
    return out


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return state, (z ^ (z >> 31)) & 0xFFFFFFFFFFFFFFFF


def rrc_params(seed: int, h: int, w: int,
               scale: tuple[float, float]) -> tuple[int, int, int]:
    """Exact Python replica of the C++ seeded random-resized-crop parameter
    derivation (md_batch_load_rrc): returns (top, left, side). Same seed +
    same dims == same crop -- used by tests and by the PIL path."""
    s = seed & 0xFFFFFFFFFFFFFFFF

    def uniform(st):
        st, z = _splitmix64(st)
        return st, (z >> 40) / 16777216.0

    s, u = uniform(s)
    # the C++ receives the bounds as c_float: truncate to float32 and form
    # the difference in float32 exactly as `scale_lo + (scale_hi - scale_lo)
    # * u` does, else area_frac differs by ~1e-8 and side can differ by 1
    # when sqrt lands near an x.5 rounding boundary
    lo = float(np.float32(scale[0]))
    diff = float(np.float32(np.float32(scale[1]) - np.float32(scale[0])))
    area_frac = lo + diff * u
    # std::lround semantics (round half away from zero) -- Python's round()
    # rounds half to even and would diverge at exact .5 boundaries
    side = int(np.floor(np.sqrt(area_frac * h * w) + 0.5))
    side = max(1, min(side, min(h, w)))
    s, u = uniform(s)
    top = min(int(u * (h - side + 1)), h - side)
    s, u = uniform(s)
    left = min(int(u * (w - side + 1)), w - side)
    return top, left, side


def batch_load_images_rrc(
    paths: list[str],
    size: int,
    seeds: list[int],
    scale_range: tuple[float, float] = (0.9, 1.0),
    scale: float = 1.0 / 127.5,
    offset: float = -1.0,
) -> np.ndarray:
    """Decode + seeded RandomResizedCrop + resize + normalize a batch ->
    (N, size, size, 3) float32. Training-path twin of `batch_load_images`:
    passing one sample's seed for both its target frame and pose map yields
    the identical crop (the reference's shared-transform-per-sample
    semantics, tiktok_video_arnold_copy.py:60-80)."""
    lib = _load()
    n = len(paths)
    assert len(seeds) == n
    out = np.empty((n, size, size, 3), np.float32)
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        seed_arr = (ctypes.c_longlong * n)(*[int(s) & 0x7FFFFFFFFFFFFFFF
                                             for s in seeds])
        failures = lib.md_batch_load_rrc(
            arr, n, size, seed_arr,
            ctypes.c_float(scale_range[0]), ctypes.c_float(scale_range[1]),
            ctypes.c_float(scale), ctypes.c_float(offset),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if failures:
            raise IOError(f"native loader failed on {failures}/{n} images")
        return out
    # PIL path: the same crop parameters via the replica RNG; bilinear resize
    # to match the native core's resize_crop_bilinear as closely as PIL can
    from PIL import Image

    from magicdance_tpu_torch.data.transforms import resize

    for i, p in enumerate(paths):
        img = np.asarray(Image.open(p).convert("RGB"))
        h, w = img.shape[:2]
        top, left, side = rrc_params(int(seeds[i]) & 0x7FFFFFFFFFFFFFFF,
                                     h, w, scale_range)
        crop = img[top:top + side, left:left + side]
        out[i] = (resize(crop, size, method=Image.BILINEAR).astype(np.float32)
                  * scale + offset)
    return out
