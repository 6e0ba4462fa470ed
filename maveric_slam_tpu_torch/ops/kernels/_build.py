"""Build and load the CUDA kernels of `maveric_slam_tpu_torch/csrc`.

Each `.cu` file has a plain C interface and is compiled by its own `nvcc`
process (all started together), then the objects are linked into one shared
library that is loaded with `ctypes`. The library's name carries a hash of
the sources and flags, so an edited source is never served from a stale
build. Output goes to `build/maveric_slam_tpu_torch/` beside the package,
a directory `.gitignore` lists. Processes that build at once (the ranks of
a mesh on a fresh checkout) take turns under a file lock there: the first
compiles, the others find its library when the lock comes to them. The
library is linked under a temporary name and renamed into place, so no
process loads a torn file.

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false`. No fast math, and no
contraction of a multiply and an add into an FMA: the detector's Taylor
exps tie exactly across channels, and a contracted product moves the
argmax (the reason the TPU kernel diverged on 85 of 1920 cells,
maveric_slam_tpu/ops/pallas_kernels.py:57-61). `-Xptxas -v` leaves each
kernel's registers, spills and shared memory in `build_log`; `sass` shows
what was compiled (cuobjdump, beside nvcc).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "maveric_slam_tpu_torch"
SOURCES = ("detector.cu", "match.cu", "nullspace.cu", "svd3.cu", "stem.cu", "refine_pose.cu",
           "qconv.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: (argtypes), each returns cudaError_t.
_SIGNATURES = {
    "detector_postproc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "windowed_match": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "nullspace_inverse_iteration": (_P, _P, _I, _I, _I, _P),
    "svd3": (_P, _P, _P, _P, _I, _I, _P),
    "fused_stem": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "refine_pose": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P),
    "qconv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build, if it built
build_log = ""  # nvcc/ptxas output of this process's build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link them, unless built
    already; returns the .so path."""
    so = BUILD_DIR / f"libmaveric_slam_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # flock is released when its holder exits, so a killed build leaves no
    # stale lock behind.
    with open(BUILD_DIR / f"{so.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built by another process while this one waited
            return so
        _compile_and_link(so)
    return so


def _compile_and_link(so: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{so.stem[-16:]}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors, logs = [], []
    for name, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"{name}:\n{out}")
        if p.returncode != 0:
            errors.append(logs[-1])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs), "-o", str(tmp)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def sass(kernel: str) -> str:
    """The SASS of the built library's functions whose (mangled) names
    contain `kernel`."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(build())], capture_output=True, text=True, check=True)
    parts = re.split(r"\n\s*Function : ", res.stdout)[1:]
    return "\n".join(p for p in parts if kernel in p.split("\n", 1)[0])


def check(err: int, kernel: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t {err}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
