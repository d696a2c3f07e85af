"""One fused MixSTE layer on the (B, F, N, C) activation (eval only).

Counterpart of ``pafuse_tpu/ops/attention.py::pallas_layer`` (the TPU
kernel ``_layer_kernel``): the spatial block with its Spatial_norm (tokens =
joints), on layer 0 ``+ tpe`` (the temporal position embedding, cast to
``x.dtype``), then the temporal block with its Temporal_norm (tokens =
frames), each with kernel #1's rounding points.

``fused_layer`` launches the hand-written CUDA kernel chain
(``csrc/layer.cu``) for CUDA tensors and uses ``layer_reference``, the same
function in plain PyTorch ops, for CPU tensors.  Block parameters are those
of ``ops.block.fused_block``; ``tpe`` is None or float32 (F, C).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.ops.attention_core import check_shape
from pafuse_tpu_torch.ops.block import _check, block_reference
from pafuse_tpu_torch.ops.gemm import chain_workspace_bytes
from pafuse_tpu_torch.ops.block_temporal import block_temporal_reference


def layer_reference(x: torch.Tensor, spatial_params: Sequence[torch.Tensor],
                    spatial_norm: Sequence[torch.Tensor],
                    temporal_params: Sequence[torch.Tensor],
                    temporal_norm: Sequence[torch.Tensor], num_heads: int,
                    tpe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: two ``block_reference`` calls around the
    (F, N) transposes, with ``tpe`` added between them."""
    B, F, N, C = x.shape
    ys = block_reference(x.reshape(B * F, N, C), spatial_params, spatial_norm,
                         num_heads).view(B, F, N, C)
    if tpe is not None:
        ys = ys + tpe.to(x.dtype)[None, :, None, :]
    return block_temporal_reference(ys, temporal_params, temporal_norm,
                                    num_heads)


def fused_layer(x: torch.Tensor, spatial_params: Sequence[torch.Tensor],
                spatial_norm: Sequence[torch.Tensor],
                temporal_params: Sequence[torch.Tensor],
                temporal_norm: Sequence[torch.Tensor], num_heads: int,
                tpe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer on x (B, F, N, C); returns (B, F, N, C) in x.dtype.

    CUDA tensors go through the CUDA kernel chain (built on first use) or
    raise; CPU tensors go through :func:`layer_reference`."""
    if x.device.type == "cpu":
        return layer_reference(x, spatial_params, spatial_norm,
                               temporal_params, temporal_norm, num_heads, tpe)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer: unsupported device {x.device}")
    sp = tuple(spatial_params) + tuple(spatial_norm)
    tp = tuple(temporal_params) + tuple(temporal_norm)
    hidden = _check(x, sp, num_heads, "fused_layer (spatial)", ndim=4)
    if _check(x, tp, num_heads, "fused_layer (temporal)", ndim=4) != hidden:
        raise ValueError("fused_layer: the two blocks' MLP widths differ")
    B, F, N, C = x.shape
    if tpe is not None and (tuple(tpe.shape) != (F, C)
                            or tpe.dtype != torch.float32
                            or tpe.device != x.device
                            or not tpe.is_contiguous()):
        raise ValueError(f"fused_layer: tpe must be contiguous float32 "
                         f"({F}, {C}) on {x.device}; got {tpe.dtype} "
                         f"{tuple(tpe.shape)} on {tpe.device}")
    check_shape(N, C, num_heads, x.dtype, "fused_layer (spatial)")
    check_shape(F, C, num_heads, x.dtype, "fused_layer (temporal)")
    lib = _build.load("layer")

    M = B * F * N
    out = torch.empty_like(x)
    ys = x.new_empty((M, C))
    qkv = x.new_empty((M, 3 * C))
    attn = x.new_empty((M, C))
    x1 = x.new_empty((M, C))
    hid = x.new_empty((M, hidden))
    ws_bytes = chain_workspace_bytes(M, C, hidden)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.pafuse_fused_layer(
            int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
            ys.data_ptr(), qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(),
            hid.data_ptr(), *[p.data_ptr() for p in sp + tp],
            None if tpe is None else tpe.data_ptr(),
            _build.attention_function(), ws.data_ptr(), ws_bytes,
            B, F, N, C, num_heads, hidden, (C // num_heads) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"fused_layer: CUDA kernel launch failed with "
                           f"cudaError {err}")
    _build.count_launch(fused_layer)
    return out


#: kernel launches through ``fused_layer`` (CUDA path only)
fused_layer.launches = 0
