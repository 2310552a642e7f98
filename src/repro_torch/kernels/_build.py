"""Build and load the port's CUDA kernels.

``nvcc`` compiles each source in ``csrc/`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared library
with a plain C interface, which ``ctypes`` loads; no PyTorch header is
compiled, so a build takes seconds. It runs at first use, from the sources
in the checkout only, into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``). The library's file name carries a hash of the
sources, headers and flags, so an edited source is never served by a stale
build.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flare.cu", "flare_bwd.cu", "flare_causal.cu", "paged_attention.cu",
           "flash_attention.cu", "flash_attention_sm90.cu")
HEADERS = ("flare_common.cuh", "flare_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")   # optimize the kernel instances on all cores

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLL, _PI = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
# argtypes of every C entry point; device pointers and the stream are c_void_p
_SIGNATURES = {
    "flare_encode_splits": [_I] * 4,
    "flare_encode": [_P] * 7 + [_I] * 5 + [_LL] * 6 + [_I] * 4 + [_P],
    "flare_decode": [_P] * 5 + [_I] * 5 + [_LL] * 6 + [_I] * 3 + [_P],
    "flare_fused_bwd": [_P] * 14 + [_I] * 5 + [_PLL] + [_I] * 2 + [_P],
    "flare_enc_stats": [_P] * 7 + [_I] * 5 + [_LL] * 6 + [_I] * 3 + [_P],
    "flare_bwd_dz": [_P] * 6 + [_I] * 5 + [_PLL] + [_I] * 2 + [_P],
    "flare_bwd_grads": [_P] * 14 + [_I] * 5 + [_PLL] + [_I] * 2 + [_P],
    "flare_causal_splits": [_I],
    "flare_causal": [_P] * 6 + [_I] * 5 + [_LL] * 9 + [_I] + [_P],
    "paged_attention_splits": [_I] * 8,
    "paged_attention": [_P] * 13 + [_I] * 8 + [_F] + [_I] * 4 + [_P, _PI],
    "flash_attention_bf16": [_P] * 4 + [_I] * 6 + [_LL] * 12 + [_F] + [_I] * 3 + [_P],
    "flash_attention_tf32": [_P] * 4 + [_I] * 6 + [_LL] * 12 + [_F] + [_I] * 3 + [_P],
    "flash_attention_tc": [_P] * 4 + [_I] * 6 + [_LL] * 12 + [_F] + [_I] * 2 + [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the build this process made (ptxas -v)
build_seconds = None    # wall time of that build; None when a cached library was loaded
source_seconds = {}     # that build's seconds from the start to each source's object


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with "
                           "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the kernels (unless a library for these sources exists) and
    return the library's path. Safe against concurrent builds: each writes
    private files and renames the library into place."""
    global build_log, build_seconds, source_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libflare_{_digest()}.so"
    if out.exists() and not force:
        return out
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, obj in zip(SOURCES, objs)]
    logs, done = [""] * len(procs), {}

    def drain(i: int) -> None:   # one reader a compile, so each finishes at its own pace
        logs[i] = procs[i].communicate()[0]
        done[SOURCES[i]] = round(time.perf_counter() - t0, 1)

    readers = [threading.Thread(target=drain, args=(i,)) for i in range(len(procs))]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    build_log, source_seconds = "".join(logs), done
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.flare_error_string.argtypes = [ctypes.c_int]
            handle.flare_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = _lib.flare_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
