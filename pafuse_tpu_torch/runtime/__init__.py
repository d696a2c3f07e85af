"""Native host runtime: the C++ batch assembly of the training sampler.

Counterpart of ``pafuse_tpu/runtime/__init__.py``.  ``batcher.cpp`` (the
port's copy of the JAX package's source, same C ABI) gathers a batch's
edge-clamped frames and applies flip augmentation in one multithreaded
pass; :func:`get_library` builds it with the C++ compiler ``CXX`` at first
use into ``build/pafuse_tpu_torch/<hash>/libbatcher.so`` beside the package
(the hash keys the source, the flags, the compiler and the CPU that
``-march=native`` targets, as ``ops/_build.py`` keys the CUDA sources), and
loads it with ctypes.  :class:`PrefetchingLoader` (``data/prefetch.py``)
is re-exported under its JAX name.

No hidden fallback: without a compiler on the PATH :func:`get_library`
returns None (``data.sampling.ChunkedSampler(use_native="auto")`` then
warns once and assembles with NumPy, as the JAX sampler does on such a
machine); a compiler that fails raises with its output, and
:func:`assemble_batch` raises without a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from typing import Dict, Optional

import numpy as np

from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
from pafuse_tpu_torch.ops._build import BUILD_ROOT

__all__ = ["PrefetchingLoader", "assemble_batch", "get_library"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "batcher.cpp")
#: the C++ compiler, looked up on the PATH at first use
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-pthread"]

_LIBS: Dict[str, ctypes.CDLL] = {}       # compiler path -> loaded library
_LOCK = threading.Lock()
_WARNED: list = []


def _run(cmd) -> subprocess.CompletedProcess:
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native batcher: {' '.join(cmd)} failed "
                           f"(exit {r.returncode}):\n{r.stdout}{r.stderr}")
    return r


def library_path(cxx: str) -> str:
    """Where ``cxx`` builds the library: keyed by the source, the flags,
    the compiler and the target ``-march=native`` resolves to here."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([cxx, *CXXFLAGS]).encode())
    h.update(_run([cxx, "-march=native", "-Q", "--help=target"]).stdout
             .encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libbatcher.so")


def _build(cxx: str) -> str:
    path = library_path(cxx)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        _run([cxx, *CXXFLAGS, SOURCE, "-o", tmp])
        os.replace(tmp, path)          # atomic: concurrent builds agree
    return path


def get_library() -> Optional[ctypes.CDLL]:
    """The native batcher, built at first use; None when ``CXX`` is not on
    the PATH.  A compiler that fails raises ``RuntimeError``."""
    cxx = shutil.which(CXX)
    if cxx is None:
        return None
    with _LOCK:
        lib = _LIBS.get(cxx)
        if lib is None:
            lib = ctypes.CDLL(_build(cxx))
            lib.assemble_batch.argtypes = [
                ctypes.c_void_p,      # src (total_frames, joints, chans) f32
                ctypes.c_void_p,      # frame_idx (batch, chunk) int64
                ctypes.c_void_p,      # flip_mask (batch,) uint8
                ctypes.c_void_p,      # perm (joints,) int32
                ctypes.c_void_p,      # out (batch, chunk, joints, chans) f32
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64]   # sizes, n_threads
            lib.assemble_batch.restype = None
            _LIBS[cxx] = lib
        return lib


def warn_no_compiler() -> None:
    """Warn, once per process, that the NumPy path assembles batches."""
    if not _WARNED:
        _WARNED.append(True)
        warnings.warn(f"native batcher unavailable (no {CXX} on the PATH); "
                      "assembling batches with NumPy", RuntimeWarning,
                      stacklevel=3)


def assemble_batch(src: np.ndarray, frame_idx: np.ndarray,
                   flip_mask: Optional[np.ndarray],
                   perm: Optional[np.ndarray],
                   out: Optional[np.ndarray] = None,
                   n_threads: int = 0) -> np.ndarray:
    """Gather (batch, chunk) windows from ``src`` with optional flip, in
    C++: ``out[b, f] = src[frame_idx[b, f]]``, and for flipped rows the
    joints permuted by ``perm`` with x negated.

    src: (total_frames, J, C) float32; frame_idx: (batch, chunk) int64;
    flip_mask: (batch,) bool/uint8 or None; perm: (J,) int32 or None (the
    identity); n_threads 0 = every core (at most one a row), each call
    starting its threads anew.  Raises without a library."""
    lib = get_library()
    if lib is None:
        raise RuntimeError(f"native batcher: no {CXX} on the PATH to build "
                           f"{SOURCE}")
    src = np.ascontiguousarray(src, dtype=np.float32)
    frame_idx = np.ascontiguousarray(frame_idx, dtype=np.int64)
    if src.ndim != 3 or frame_idx.ndim != 2:
        raise ValueError(f"src {src.shape} must be (frames, J, C) and "
                         f"frame_idx {frame_idx.shape} (batch, chunk)")
    batch, chunk = frame_idx.shape
    total, joints, chans = src.shape
    if frame_idx.size and (frame_idx.min() < 0 or frame_idx.max() >= total):
        raise ValueError(f"frame_idx outside [0, {total})")
    fm = (np.zeros(batch, np.uint8) if flip_mask is None
          else np.ascontiguousarray(flip_mask, dtype=np.uint8))
    if fm.shape != (batch,):
        raise ValueError(f"flip_mask {fm.shape} must be ({batch},)")
    pm = (np.arange(joints, dtype=np.int32) if perm is None
          else np.ascontiguousarray(perm, dtype=np.int32))
    if pm.shape != (joints,) or (pm.size and (pm.min() < 0
                                              or pm.max() >= joints)):
        raise ValueError(f"perm must be a ({joints},) table of joints")
    if out is None:
        out = np.empty((batch, chunk, joints, chans), np.float32)
    elif (out.shape != (batch, chunk, joints, chans)
          or out.dtype != np.float32 or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous float32 "
                         f"{(batch, chunk, joints, chans)} array")
    lib.assemble_batch(src.ctypes.data, frame_idx.ctypes.data,
                       fm.ctypes.data, pm.ctypes.data, out.ctypes.data,
                       batch, chunk, joints, chans, n_threads)
    return out
