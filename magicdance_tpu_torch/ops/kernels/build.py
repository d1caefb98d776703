"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` file compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes). All
sources start compiling at once, one `nvcc` process each. Libraries land in
`magicdance_tpu_torch/_build/`, named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing here runs
at import time: the first launch of a kernel builds it. `BUILDS` tells an
operator whether a run compiled or loaded a kernel library, and which.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("self_attention", "two_source_attention", "attention_dq", "attention_dkv",
           "grouped_attention", "grouped_attention_bwd", "groupnorm_silu",
           "packed_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per library name, in this process: {"builds": nvcc builds, "build_s": their
# wall seconds (the builds of one `build` call run at once, and each is given
# the call's whole wall time), "loaded": whether `load` has loaded it}
BUILDS: dict[str, dict] = {}


def _builds_entry(name: str) -> dict:
    return BUILDS.setdefault(name, {"builds": 0, "build_s": 0.0, "loaded": False})


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, all nvcc
    processes at once. Returns {name: library path}. Each compiler's output
    (ptxas register and spill report included) is kept beside its library as
    `<library>.log`. Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    outs = {n: proc.communicate()[0] for n, (_, proc) in procs.items()}
    wall = time.perf_counter() - t0
    failed = []
    for n, (tmp, proc) in procs.items():
        entry = _builds_entry(n)
        entry["builds"] += 1
        entry["build_s"] += wall
        out = outs[n]
        paths[n].with_suffix(".so.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> Optional[str]:
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else None


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # dtype, body, q, k, v, o, lse, strides, B, H, D, Sq, Sk, scale, stream
    "self_attention": ("md_self_attention",
                       [_I, _I, _VP, _VP, _VP, _VP, _VP, _STRIDES,
                        _I, _I, _I, _I, _I, _F, _VP]),
    # dtype, body, q, k_self, v_self, k_bank, v_bank, o, lse, bank_mask,
    # strides, B, H, D, Sq, Sk, Sb, scale, stream
    "two_source_attention": ("md_two_source_attention",
                             [_I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _STRIDES,
                              _I, _I, _I, _I, _I, _I, _F, _VP]),
    # dtype, body, nsrc, q, k_self, v_self, k_bank, v_bank, dout, lse, delta,
    # dq, strides, B, H, D, Sq, Sk, Sb, scale, stream
    "attention_dq": ("md_attention_dq",
                     [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _STRIDES, _I, _I, _I, _I, _I, _I, _F, _VP]),
    # dtype, body, nsplit, k, v, q, dout, lse, delta, dk, dv, part, strides,
    # Bq, Bk, H, D, Sq, Sk, scale, stream
    "attention_dkv": ("md_attention_dkv",
                      [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _STRIDES,
                       _I, _I, _I, _I, _I, _I, _F, _VP]),
    # dtype, q, k, v, o, strides, N, H, D, S, scale, stream
    "grouped_attention": ("md_grouped_attention",
                          [_I, _VP, _VP, _VP, _VP, _STRIDES, _I, _I, _I, _I, _F, _VP]),
    # dtype, q, k, v, dout, dq, dk, dv, strides, N, H, D, S, scale, stream
    "grouped_attention_bwd": ("md_grouped_attention_bwd",
                              [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _STRIDES,
                               _I, _I, _I, _I, _F, _VP]),
    # dtype, affine dtype, act, x, gamma, beta, y, workspace, strides, B, HW, C,
    # G, eps, stream
    "groupnorm_silu": ("md_groupnorm_silu",
                       [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _STRIDES, _I, _I, _I, _I, _F,
                        _VP]),
    # dtype, body, q, k, v, o, strides, BG, GD, Sq, S, G, scale, stream
    "packed_attention": ("md_packed_attention",
                         [_I, _I, _VP, _VP, _VP, _VP, _STRIDES, _I, _I, _I, _I, _I, _F, _VP]),
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.md_error_string.argtypes = [ctypes.c_int]
            lib.md_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            _builds_entry(name)["loaded"] = True
        return lib
