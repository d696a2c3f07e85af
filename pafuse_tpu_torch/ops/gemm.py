"""One GEMM stage of the eval block chain (kernels #1, #3, #4).

``fused_linear`` computes ``Y = T(epilogue(prologue(A) @ W^T + b))`` with
the rounding points of ``pafuse_tpu/ops/attention.py::_block_body``'s
``dot2d`` products: the LayerNorm prologue (``ln = (scale, bias)``)
normalises each row of ``A`` in float32 and rounds it to the compute dtype
``T`` (the dtype of ``A``), the weight enters the product rounded to ``T``,
sums accumulate in float32, and the epilogue is ``"store"``, the exact
(erf) ``"gelu"``, or ``"residual"``: ``R + T(product)``.

For CUDA tensors it launches the Hopper GEMM (``csrc/gemm.cu`` on
``csrc/gemm_sm90.cuh``, the GEMM that ``csrc/block_chain.cuh`` runs four
times a block): TMA-fed ``wgmma``, in float32 as three TF32 products per
product (``a_hi*w_hi + a_hi*w_lo + a_lo*w_hi``, see :func:`split_tf32`)
with the LayerNorm in the GEMM's prologue, in bfloat16 as one bf16 product
summed in one float32 accumulator over the whole K, after a pre-pass that
writes the LayerNorm rounded to bfloat16 (plain: :func:`layernorm_round`).
For CPU tensors it uses :func:`linear_reference`, the same function in
plain PyTorch ops.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from pafuse_tpu_torch.ops import _build

_EPS = 1e-6
EPILOGUES = {"store": 0, "gelu": 1, "residual": 2}


def _layernorm(v: torch.Tensor, scale, bias) -> torch.Tensor:
    v = v.float()
    mean = v.mean(-1, keepdim=True)
    var = (v - mean).square().mean(-1, keepdim=True)
    return (v - mean) * torch.rsqrt(var + _EPS) * scale + bias


def layernorm_round(a: torch.Tensor, scale, bias) -> torch.Tensor:
    """The LayerNorm prologue: each row of ``a`` normalised in float32 and
    rounded to ``a``'s dtype (the bfloat16 GEMM's pre-pass writes it)."""
    return _layernorm(a, scale, bias).to(a.dtype)


def split_tf32(x: torch.Tensor):
    """float32 ``x`` -> (hi, lo), both TF32 values (10 explicit mantissa
    bits), ``hi`` = x rounded to nearest with ties away from zero (PTX
    ``cvt.rna.tf32.f32``) and ``lo`` the remainder ``x - hi`` rounded the
    same way, so ``hi + lo`` equals finite ``x`` to ~2^-22 relative."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def linear_reference(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     ln: Optional[Sequence[torch.Tensor]] = None,
                     epilogue: str = "store",
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_linear` (any leading dims)."""
    cd = a.dtype
    if ln is not None:
        a = layernorm_round(a, *ln)
    y = F.linear(a.float(), w.to(cd).float(), b)
    if epilogue == "gelu":
        return F.gelu(y).to(cd)
    if epilogue == "residual":
        return residual + y.to(cd)
    if epilogue != "store":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return y.to(cd)


def linear_workspace_bytes(M: int, N: int, K: int, bf16: bool = False) -> int:
    """Workspace of one ``fused_linear`` call (``csrc/gemm.cu`` checks it):
    in float32 the weight's TF32 hi and lo halves and the (mean, rstd) of
    each row, in bfloat16 the rounded weight and the rounded LayerNorm of
    A."""
    return 2 * N * K + 2 * M * K if bf16 else 8 * N * K + 8 * M


def chain_workspace_bytes(M: int, C: int, hidden: int) -> int:
    """Workspace of one block chain (``csrc/block_chain.cuh``'s
    ``chain_workspace_bytes``): the four weights' TF32 hi and lo halves and
    the (mean, rstd) of each of the M rows."""
    return 4 * (2 * (4 * C * C + 2 * hidden * C) + 2 * M)


def _check(a, w, b, ln, epilogue, residual):
    if a.dim() != 2 or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_linear: A must be 2-D float32 or bfloat16; "
                         f"got {a.dtype} {tuple(a.shape)}")
    M, K = a.shape
    N = w.shape[0]
    if epilogue not in EPILOGUES:
        raise ValueError(f"fused_linear: unknown epilogue {epilogue!r}")
    if N % 8 or K % 8:
        raise ValueError(f"fused_linear: N={N} and K={K} must be multiples "
                         f"of 8")
    want = [(w, (N, K), torch.float32), (b, (N,), torch.float32)]
    if ln is not None:
        want += [(t, (K,), torch.float32) for t in ln]
    if epilogue == "residual":
        want.append((residual, (M, N), a.dtype))
    for t, shape, dtype in [(a, (M, K), a.dtype)] + want:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != a.device or not t.is_contiguous()):
            raise ValueError(f"fused_linear: expected contiguous {dtype} "
                             f"{shape} on {a.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def fused_linear(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 ln: Optional[Sequence[torch.Tensor]] = None,
                 epilogue: str = "store",
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GEMM stage on A (M, K); returns (M, N) in A's dtype.

    CUDA tensors go through the Hopper GEMM (built on first use) or raise;
    CPU tensors go through :func:`linear_reference`."""
    if a.device.type == "cpu":
        return linear_reference(a, w, b, ln, epilogue, residual)
    if a.device.type != "cuda":
        raise ValueError(f"fused_linear: unsupported device {a.device}")
    _check(a, w, b, ln, epilogue, residual)
    lib = _build.load("gemm")

    M, K = a.shape
    N = w.shape[0]
    y = a.new_empty((M, N))
    ws_bytes = linear_workspace_bytes(M, N, K, a.dtype == torch.bfloat16)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=a.device)
    scale, bias = ln if ln is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.pafuse_linear_sm90(
            int(a.dtype == torch.bfloat16),
            int(ln is not None), EPILOGUES[epilogue], a.data_ptr(), w.data_ptr(), b.data_ptr(),
            ptr(scale), ptr(bias), ptr(residual), y.data_ptr(), ws.data_ptr(),
            ws_bytes, M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"fused_linear: CUDA launch failed with cudaError "
                           f"{err} (1: a shape the GEMM does not take, or a "
                           f"failed TMA tensor-map encode)")
    _build.count_launch(fused_linear)
    return y


#: kernel launches through ``fused_linear`` (CUDA path only)
fused_linear.launches = 0
