"""Fused multi-head self-attention: QKV -> per-head softmax attention ->
output projection (eval only; no LayerNorm, no MLP).

Counterpart of ``pafuse_tpu/ops/attention.py::pallas_attention`` (the TPU
kernel ``_attention_kernel``), which the JAX package runs as every block's
attention when ``use_pallas=true`` switches the fused-block kernel off.
Numerics are that kernel's: ``x`` is upcast to float32, the weights are
float32 whatever the dtype of ``x``, qkv, the probabilities and the head
outputs stay in float32, and only the output is rounded to ``x.dtype``.

``fused_attention`` launches the hand-written CUDA kernel chain
(``csrc/attention.cu``: the two GEMMs on ``csrc/gemm_sm90.cuh``, TMA-fed
``wgmma`` with each float32 product as three TF32 products, see
``ops.gemm.split_tf32``; a bfloat16 ``x`` is converted to float32 first,
which TF32 holds exactly; the attention between them on the tensor-core
kernel of ``ops.attention_core`` in float32, three TF32 products a product)
for CUDA tensors and uses ``attention_reference``, the same function in
plain PyTorch ops, for CPU tensors.  It takes any L and head sizes up to
128; a head size above 128 raises ``ValueError`` before any launch.

Parameters are float32 in torch layout: ``qkv_w`` (3C, C), ``qkv_b`` (3C,),
``proj_w`` (C, C), ``proj_b`` (C,).  ``x`` is (..., L, C): the leading dims
are sequences.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.ops.attention_core import check_shape


def attention_reference(x: torch.Tensor, qkv_w: torch.Tensor,
                        qkv_b: torch.Tensor, proj_w: torch.Tensor,
                        proj_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: float32 arithmetic, output in ``x.dtype``."""
    *lead, L, C = x.shape
    d = C // num_heads
    qkv = F.linear(x.reshape(-1, L, C).float(), qkv_w, qkv_b)
    q, k, v = qkv.view(-1, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    ao = torch.matmul(torch.softmax(logits, dim=-1), v)    # (B, H, L, d)
    ao = ao.transpose(1, 2).reshape(-1, L, C)
    return F.linear(ao, proj_w, proj_b).to(x.dtype).reshape(*lead, L, C)


def attention_workspace_bytes(M: int, C: int, bf16: bool) -> int:
    """Workspace of one ``fused_attention`` call on M = B*L rows
    (``csrc/attention.cu`` checks it): the TF32 hi and lo halves of the two
    weights and, for bfloat16 x, a float32 copy of x."""
    return 4 * (8 * C * C + (M * C if bf16 else 0))


def _check(x: torch.Tensor, params, num_heads: int) -> None:
    if x.dim() < 2:
        raise ValueError(f"fused_attention: x must be (..., L, C); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention: x must be float32 or bfloat16; "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_attention: x must be contiguous")
    C = x.shape[-1]
    if C % num_heads or C % 8:
        raise ValueError(f"fused_attention: C={C} must be a multiple of 8 "
                         f"and divisible by {num_heads} heads")
    shapes = [(3 * C, C), (3 * C,), (C, C), (C,)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"fused_attention: parameter {i} has shape "
                             f"{tuple(p.shape)}, expected {shape}")
        if p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"fused_attention: parameter {i} must be float32 "
                             f"on {x.device}; got {p.dtype} on {p.device}")
        if not p.is_contiguous():
            raise ValueError(f"fused_attention: parameter {i} must be "
                             "contiguous")


def fused_attention(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                    proj_w: torch.Tensor, proj_b: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Attention over the -2 axis of (..., L, C); returns (..., L, C) in
    x.dtype.

    CUDA tensors go through the CUDA kernel chain (built on first use) or
    raise; CPU tensors go through :func:`attention_reference`."""
    if x.device.type == "cpu":
        return attention_reference(x, qkv_w, qkv_b, proj_w, proj_b, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {x.device}")
    params = (qkv_w, qkv_b, proj_w, proj_b)
    _check(x, params, num_heads)
    L, C = x.shape[-2:]
    check_shape(L, C, num_heads, torch.float32, "fused_attention")
    lib = _build.load("attention")

    B = x.numel() // (L * C)
    out = torch.empty_like(x)
    bf16 = x.dtype == torch.bfloat16
    qkv = torch.empty((B * L, 3 * C), dtype=torch.float32, device=x.device)
    attn = torch.empty((B * L, C), dtype=torch.float32, device=x.device)
    ws_bytes = attention_workspace_bytes(B * L, C, bf16)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.pafuse_fused_attention(
            int(bf16), x.data_ptr(), out.data_ptr(), qkv.data_ptr(),
            attn.data_ptr(), ws.data_ptr(), ws_bytes,
            *[p.data_ptr() for p in params], _build.attention_function(),
            B, L, C, num_heads, (C // num_heads) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention: CUDA kernel launch failed with "
                           f"cudaError {err} (1: a shape the GEMM does not "
                           f"take, or a failed TMA tensor-map encode)")
    _build.count_launch(fused_attention)
    return out


#: kernel launches through ``fused_attention`` (CUDA path only)
fused_attention.launches = 0
