"""Fused MixSTE temporal block + outer LayerNorm on the native (B, F, N, C)
layout (eval only).

Counterpart of ``pafuse_tpu/ops/attention.py::pallas_block_temporal`` (the
TPU kernel ``_block_t_kernel``): the block of ``ops.block`` with the F frames
as tokens and the (sample, joint) pairs as sequences, read from and written
to (B, F, N, C) without a transpose.  Numerics are kernel #1's (the rounding
points of ``_block_body``), on ``x.transpose(1, 2)``.

``fused_block_temporal`` launches the hand-written CUDA kernel chain
(``csrc/block_temporal.cu``) for CUDA tensors and uses
``block_temporal_reference``, the same function in plain PyTorch ops, for
CPU tensors.  Parameters are those of ``ops.block.fused_block``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.ops.attention_core import check_shape
from pafuse_tpu_torch.ops.block import _check, block_reference
from pafuse_tpu_torch.ops.gemm import chain_workspace_bytes


def block_temporal_reference(x: torch.Tensor,
                             block_params: Sequence[torch.Tensor],
                             outer_norm: Sequence[torch.Tensor],
                             num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: ``block_reference`` on the (B*N, F, C) frame
    sequences, transposed back to (B, F, N, C)."""
    B, F, N, C = x.shape
    xt = x.transpose(1, 2).reshape(B * N, F, C)
    y = block_reference(xt, block_params, outer_norm, num_heads)
    return y.view(B, N, F, C).transpose(1, 2).contiguous()


def fused_block_temporal(x: torch.Tensor, block_params: Sequence[torch.Tensor],
                         outer_norm: Sequence[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """The temporal block on x (B, F, N, C), tokens = frames; returns
    (B, F, N, C) in x.dtype.

    CUDA tensors go through the CUDA kernel chain (built on first use) or
    raise; CPU tensors go through :func:`block_temporal_reference`."""
    if x.device.type == "cpu":
        return block_temporal_reference(x, block_params, outer_norm, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_temporal: unsupported device "
                         f"{x.device}")
    params = tuple(block_params) + tuple(outer_norm)
    hidden = _check(x, params, num_heads, "fused_block_temporal", ndim=4)
    B, F, N, C = x.shape
    check_shape(F, C, num_heads, x.dtype, "fused_block_temporal")
    lib = _build.load("block_temporal")

    M = B * F * N
    out = torch.empty_like(x)
    qkv = x.new_empty((M, 3 * C))
    attn = x.new_empty((M, C))
    x1 = x.new_empty((M, C))
    hid = x.new_empty((M, hidden))
    ws_bytes = chain_workspace_bytes(M, C, hidden)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.pafuse_fused_block_temporal(
            int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), hid.data_ptr(),
            *[p.data_ptr() for p in params], _build.attention_function(),
            ws.data_ptr(), ws_bytes,
            B, F, N, C, num_heads, hidden, (C // num_heads) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"fused_block_temporal: CUDA kernel launch failed "
                           f"with cudaError {err}")
    _build.count_launch(fused_block_temporal)
    return out


#: kernel launches through ``fused_block_temporal`` (CUDA path only)
fused_block_temporal.launches = 0
