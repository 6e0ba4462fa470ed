"""ctypes bindings for the port's native host runtime (native/feature_pool.cc),
the port of maveric_slam_tpu/runtime/pool.py.

The shared library is built with g++ on the first use of `FeaturePool` or
`lcd_intersect` in a process (never at import), under a lock, into
`build/maveric_slam_tpu_torch/runtime/` beside the package, a directory
`.gitignore` lists. Each output's name carries a hash of its sources and
flags, so an edited source is never served from a stale build; it is
written under a temporary name and renamed into place, so processes that
build at once cannot read a torn file. A failed build raises: there is no
Python fallback pool. `stress_binary` builds the ASan/UBSan stress driver
(native/pool_stress.cc) the same way, with the JAX package's sanitizer
flags (its runtime/native/Makefile). `CXX` names another compiler.

The pool mirrors the reference's host-side map bookkeeping
(include/local_feature_pool.h); the device-resident variant lives in
mapping/feature_pool.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "maveric_slam_tpu_torch" / "runtime"
LIB_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
SANITIZER_FLAGS = ("-g", "-O1", "-std=c++17", "-Wall", "-Wextra",
                   "-fsanitize=address,undefined", "-fno-sanitize-recover=all")

_BUILD_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compile(stem: str, suffix: str, sources, flags) -> Path:
    """g++ `sources` (in native/) with `flags` into BUILD_DIR; returns the
    output's path. Raises RuntimeError with the compiler's output."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join((cxx, *flags)).encode())
    for name in sources:
        h.update((NATIVE_DIR / name).read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), *(str(NATIVE_DIR / n) for n in sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load_library() -> ctypes.CDLL:
    global _lib
    with _BUILD_LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_compile("libmaveric_runtime", ".so", ["feature_pool.cc"], LIB_FLAGS)))
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name, argtypes, restype in (
            ("pool_create", [ci, ci], vp),
            ("pool_destroy", [vp], None),
            ("pool_size", [vp], ci),
            ("pool_load_factor", [vp], ctypes.c_float),
            ("pool_observe", [vp, ci, ci], ci),
            ("pool_observe_batch", [vp, i32, ci, ci], ci),
            ("pool_last_seen", [vp, ci], ci),
            ("pool_num_sightings", [vp, ci], ci),
            ("pool_remove_old", [vp, ci], None),
            ("pool_valid_keys", [vp, i32, ci], ci),
            ("pool_check_invariant", [vp, ci], ci),
            ("lcd_intersect", [i32, ci, i32, ci], ci),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


class SanitizersUnavailable(RuntimeError):
    """The compiler cannot build or link with ASan/UBSan (its output names
    them, e.g. a missing libasan)."""


def stress_binary() -> Path:
    """The sanitizer stress driver, built on first call; it prints
    `pool_stress: OK` and exits 0 when every check held. Raises
    SanitizersUnavailable where the toolchain lacks the sanitizers."""
    with _BUILD_LOCK:
        try:
            return _compile("pool_stress_asan", "", ["pool_stress.cc", "feature_pool.cc"],
                            SANITIZER_FLAGS)
        except RuntimeError as e:
            output = str(e).split("failed:\n", 1)[-1].lower()
            if any(word in output for word in ("sanitize", "asan", "ubsan")):
                raise SanitizersUnavailable(str(e)) from e
            raise


class FeaturePool:
    """Host feature pool: word-id keyed sightings with an age-out window.

    Capacity/window defaults follow the reference envelope
    (local_feature_pool.h:11-14: capacity 3000, 8-frame window).
    """

    def __init__(self, capacity: int = 3000, max_frames: int = 8):
        self._lib = _load_library()
        self._handle = self._lib.pool_create(capacity, max_frames)
        if not self._handle:
            raise ValueError("bad pool parameters")
        self.capacity = capacity
        self.max_frames = max_frames

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.pool_destroy(self._handle)
            self._handle = None

    def observe(self, word_id: int, frame_num: int) -> bool:
        """Record a sighting; True if a new feature was created."""
        r = self._lib.pool_observe(self._handle, word_id, frame_num)
        if r < 0:
            raise OverflowError("feature pool full")
        return bool(r)

    def observe_batch(self, word_ids: np.ndarray, frame_num: int) -> int:
        """Record a frame's sightings (ids < 0 skipped); the number of new
        features."""
        ids = np.ascontiguousarray(word_ids, np.int32)
        r = self._lib.pool_observe_batch(self._handle, ids, len(ids), frame_num)
        if r < 0:
            raise OverflowError("feature pool full")
        return r

    def remove_old(self, current_frame: int) -> None:
        self._lib.pool_remove_old(self._handle, current_frame)

    def last_seen(self, word_id: int) -> int:
        return self._lib.pool_last_seen(self._handle, word_id)

    def num_sightings(self, word_id: int) -> int:
        return self._lib.pool_num_sightings(self._handle, word_id)

    def valid_keys(self) -> np.ndarray:
        out = np.empty(self.capacity, np.int32)
        n = self._lib.pool_valid_keys(self._handle, out, self.capacity)
        return out[:n]

    def check_invariant(self, current_frame: int) -> int:
        """0 when consistent; nonzero code identifies the broken invariant."""
        return self._lib.pool_check_invariant(self._handle, current_frame)

    def __len__(self) -> int:
        return self._lib.pool_size(self._handle)

    @property
    def load_factor(self) -> float:
        return self._lib.pool_load_factor(self._handle)


def lcd_intersect(a: np.ndarray, b: np.ndarray) -> int:
    """Sorted-id intersection count (native merge-join, lcd_main.c:52-74)."""
    lib = _load_library()
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    return lib.lcd_intersect(a, len(a), b, len(b))
