"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/pafuse_tpu_torch/<hash>/lib<name>.so``
next to the package, where ``<hash>`` keys the source text and the compiler
flags, so an edited source rebuilds and an unchanged one is reused.  Nothing
is built when the package is imported: the first CUDA call of a kernel
wrapper calls :func:`load`, which builds every source at once (one ``nvcc``
process per source, all started together) and then opens the library.

The libraries have a plain C interface; ``KERNELS`` declares each exported
function's ctypes signature (``c_void_p`` for pointers and streams).  The
hash also keys the shared headers ``csrc/*.cuh``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "pafuse_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)

#: source name -> {exported function: (argtypes, restype)}.  Kernel
#: functions return int: the cudaError_t of the first failed launch, 0 on
#: success.
KERNELS: Dict[str, Dict[str, Tuple[list, type]]] = {
    "block": {
        # is_bf16, x, out, qkv, attn, x1, hidden, 14 params, the attention
        # (attention_function()), workspace and its bytes, B, L, C, H,
        # hidden, scale, stream
        "pafuse_fused_block": ([_I] + [_P] * 6 + [_P] * 14 + [_P, _P, _LL]
                               + [_LL, _I, _I, _I, _I, _F, _P], _I),
    },
    "block_train": {
        # float counts of the forward's saved workspace and the backward's
        # scratch: B, L, C, hidden
        "pafuse_block_train_saved_floats": ([_LL, _I, _I, _I], _LL),
        "pafuse_block_train_scratch_floats": ([_LL, _I, _I, _I], _LL),
        # float count of the forward's weight split: C, hidden
        "pafuse_block_train_split_floats": ([_I, _I], _LL),
        # is_bf16, x, m1, m2, 14 params, y, saved, weight split, the
        # attention (attention_function()), B, L, C, H, hidden, scale, stream
        "pafuse_block_train_fwd": ([_I] + [_P] * 3 + [_P] * 14 + [_P] * 4
                                   + [_LL, _I, _I, _I, _I, _F, _P], _I),
        # is_bf16, x, g, m1, m2, 14 params, saved, dx, grads, scratch, the
        # streamed attention backward's stats (or NULL), the attention
        # backward (attention_bwd_function()), B, L, C, H, hidden, scale,
        # stream
        "pafuse_block_train_bwd": ([_I] + [_P] * 4 + [_P] * 14 + [_P] * 6
                                   + [_LL, _I, _I, _I, _I, _F, _P], _I),
        # the forward's GEMM alone: A, W, bias, epilogue, R (or NULL),
        # r_is_bf16, mask (or NULL), L, Y, Y2 (or NULL), workspace, M, N, K,
        # stream
        "pafuse_fwd_linear": ([_P] * 3 + [_I, _P, _I, _P, _I] + [_P] * 3
                              + [_LL, _I, _I, _P], _I),
        # the backward's GEMMs alone: A, W, aux (or NULL), Y, workspace, M,
        # N, K, stream; the partials' float count: M, N, K; D, X, partials,
        # dW, M, N, K, stream
        "pafuse_data_grad": ([_P] * 5 + [_LL, _I, _I, _P], _I),
        "pafuse_weight_grad_part_floats": ([_LL, _I, _I], _LL),
        "pafuse_weight_grad": ([_P] * 4 + [_LL, _I, _I, _P], _I),
    },
    "block_temporal": {
        # is_bf16, x, out, qkv, attn, x1, hidden, 14 params, the attention,
        # workspace and its bytes, B, F, N, C, H, hidden, scale, stream
        "pafuse_fused_block_temporal": ([_I] + [_P] * 6 + [_P] * 14
                                        + [_P, _P, _LL]
                                        + [_LL, _I, _I, _I, _I, _I, _F, _P],
                                        _I),
    },
    "layer": {
        # is_bf16, x, out, ys, qkv, attn, x1, hidden, 14 spatial + 14
        # temporal params, tpe (or NULL), the attention, workspace and its
        # bytes, B, F, N, C, H, hidden, scale, stream
        "pafuse_fused_layer": ([_I] + [_P] * 7 + [_P] * 28 + [_P] + [_P, _P, _LL]
                               + [_LL, _I, _I, _I, _I, _I, _F, _P], _I),
    },
    "gemm": {
        # is_bf16, prologue, epilogue, A, W, bias, ln scale, ln bias, R, Y,
        # workspace and its bytes, M, N, K, stream
        "pafuse_linear_sm90": ([_I, _I, _I] + [_P] * 8 + [_LL, _LL, _I, _I,
                                                           _P], _I),
    },
    "attention_core": {
        # which kernel takes (L, d): is_bf16, L, d -> 1 resident, 2
        # streamed, 0 neither
        "pafuse_attention_core_variant": ([_I, _I, _I], _I),
        # is_bf16, qkv, out, sequences, L, S, C, H, scale, stream
        "pafuse_attention_core": ([_I, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
                                  _I),
        # the streamed kernel's launches: zero -> the count (then 0 if zero)
        "pafuse_attention_core_stream_launches": ([_I], _LL),
    },
    "attention_core_bwd": {
        # L, d -> as above (float32)
        "pafuse_attention_core_bwd_variant": ([_I, _I], _I),
        # qkv, dO, dqkv, stats scratch (or NULL), sequences, L, C, H, scale,
        # stream
        "pafuse_attention_core_bwd": ([_P, _P, _P, _P, _LL, _I, _I, _I, _F,
                                       _P], _I),
        # pass (0: A, 1: B), zero -> that pass's launches (then 0 if zero)
        "pafuse_attention_core_bwd_stream_launches": ([_I, _I], _LL),
    },
    "attention": {
        # is_bf16, x, out, qkv scratch, attention scratch, workspace and its
        # bytes, wqkv, bqkv, wproj, bproj, the attention, B, L, C, H, scale,
        # stream
        "pafuse_fused_attention": ([_I] + [_P] * 5 + [_LL] + [_P] * 5
                                   + [_LL, _I, _I, _I, _F, _P], _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``.  Wrappers launch from several
    threads at once (the serving batchers, one per tier), and ``+= 1`` on
    an attribute is a read-modify-write, so it runs under a lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that has no library yet, all in parallel.

    Returns {name: library path}; raises with nvcc's output on failure."""
    paths = {name: _library_path(name) for name in KERNELS}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def attention_function() -> int:
    """The address of ``csrc/attention_core.cu``'s ``pafuse_attention_core``,
    which the block chains (block.cu, block_temporal.cu, layer.cu), kernel
    #2 (attention.cu) and kernel #5 (block_train.cu) call for their
    attention stage, so its kernels are built into one library."""
    fn = load("attention_core").pafuse_attention_core
    return ctypes.cast(fn, ctypes.c_void_p).value


@functools.lru_cache(maxsize=None)
def attention_bwd_function() -> int:
    """The address of ``csrc/attention_core_bwd.cu``'s
    ``pafuse_attention_core_bwd``, which kernel #6 (block_train.cu) calls
    for its attention backward."""
    fn = load("attention_core_bwd").pafuse_attention_core_bwd
    return ctypes.cast(fn, ctypes.c_void_p).value


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in KERNELS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
