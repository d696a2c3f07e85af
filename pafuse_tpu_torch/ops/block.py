"""Fused MixSTE transformer block + outer LayerNorm (eval only).

Counterpart of ``pafuse_tpu/ops/attention.py::pallas_block``: LN1 -> QKV ->
per-head softmax(QK^T/sqrt(d))V -> proj -> +residual -> LN2 -> fc1 -> exact
GELU -> fc2 -> +residual -> outer (Spatial/Temporal) LN, over sequences of L
tokens.  Matmuls take their operands in the compute dtype (the dtype of
``x``: float32 or bfloat16) and accumulate in float32; LayerNorm, softmax and
GELU run in float32, with the rounding points of the TPU kernel.

``fused_block`` launches the hand-written CUDA kernel chain
(``csrc/block.cu`` on ``csrc/block_chain.cuh``: the four products on the
Hopper GEMM of ``ops.gemm``, in float32 as three TF32 products per product,
the attention on the tensor-core kernel of ``ops.attention_core``)
for CUDA tensors and uses ``block_reference``, the same
function in plain PyTorch ops, for CPU tensors.

Parameters are passed as two tuples of float32 tensors in torch layout:
``block_params = (norm1.weight, norm1.bias, qkv.weight, qkv.bias,
proj.weight, proj.bias, norm2.weight, norm2.bias, fc1.weight, fc1.bias,
fc2.weight, fc2.bias)`` with Linear weights as (out, in), and
``outer_norm = (weight, bias)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.ops.attention_core import (attention_core_reference,
                                                 check_shape)
from pafuse_tpu_torch.ops.gemm import (_layernorm, chain_workspace_bytes,
                                       linear_reference)


def block_reference(x: torch.Tensor, block_params: Sequence[torch.Tensor],
                    outer_norm: Sequence[torch.Tensor],
                    num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the fused block.  x: (B, L, C).

    The four products are ``ops.gemm.linear_reference`` stages (weights
    rounded to the compute dtype, float32 accumulation), the attention
    ``ops.attention_core.attention_core_reference``."""
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2,
     bfc2) = block_params
    nos, nob = outer_norm
    cd = x.dtype

    qkv = linear_reference(x, wqkv, bqkv, (n1s, n1b))
    ao = attention_core_reference(qkv, num_heads)          # (B, L, C)
    x1 = linear_reference(ao, wproj, bproj, epilogue="residual", residual=x)
    hdn = linear_reference(x1, wfc1, bfc1, (n2s, n2b), "gelu")
    x2 = linear_reference(hdn, wfc2, bfc2, epilogue="residual", residual=x1)
    return _layernorm(x2, nos, nob).to(cd)


_LAYOUTS = {3: "(B, L, C)", 4: "(B, F, N, C)"}


def _check(x: torch.Tensor, params: Sequence[torch.Tensor], num_heads: int,
           what: str = "fused_block", ndim: int = 3) -> int:
    """Validate x (``ndim`` dims, channels last) and the 14 parameters of a
    block kernel; returns the MLP hidden width."""
    if x.dim() != ndim:
        raise ValueError(f"{what}: x must be {_LAYOUTS[ndim]}; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    C = x.shape[-1]
    if C % num_heads:
        raise ValueError(f"{what}: C={C} not divisible by {num_heads} heads")
    hidden = params[8].shape[0]
    shapes = [(C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,), (C,), (C,),
              (hidden, C), (hidden,), (C, hidden), (C,), (C,), (C,)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"{what}: parameter {i} has shape "
                             f"{tuple(p.shape)}, expected {shape}")
        if p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"{what}: parameter {i} must be float32 on "
                             f"{x.device}; got {p.dtype} on {p.device}")
        if not p.is_contiguous():
            raise ValueError(f"{what}: parameter {i} must be contiguous")
    return hidden


def fused_block(x: torch.Tensor, block_params: Sequence[torch.Tensor],
                outer_norm: Sequence[torch.Tensor],
                num_heads: int) -> torch.Tensor:
    """The fused block on (B, L, C) sequences; returns (B, L, C) in x.dtype.

    CUDA tensors go through the CUDA kernel chain (built on first use) or
    raise; CPU tensors go through :func:`block_reference`."""
    if x.device.type == "cpu":
        return block_reference(x, block_params, outer_norm, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x.device}")
    params = tuple(block_params) + tuple(outer_norm)
    hidden = _check(x, params, num_heads)
    B, L, C = x.shape
    check_shape(L, C, num_heads, x.dtype, "fused_block")
    lib = _build.load("block")

    M = B * L
    out = torch.empty_like(x)
    qkv = x.new_empty((M, 3 * C))
    attn = x.new_empty((M, C))
    x1 = x.new_empty((M, C))
    hid = x.new_empty((M, hidden))
    ws_bytes = chain_workspace_bytes(M, C, hidden)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.pafuse_fused_block(
            int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), hid.data_ptr(),
            *[p.data_ptr() for p in params], _build.attention_function(),
            ws.data_ptr(), ws_bytes,
            B, L, C, num_heads, hidden, (C // num_heads) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"fused_block: CUDA kernel launch failed with "
                           f"cudaError {err}")
    _build.count_launch(fused_block)
    return out


#: kernel launches through ``fused_block`` (CUDA path only)
fused_block.launches = 0
