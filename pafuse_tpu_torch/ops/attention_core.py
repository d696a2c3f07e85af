"""The attention stages on the tensor cores alone: the forward of kernels
#1-#5 and the training backward of kernel #6.

``attention_core`` computes per-head softmax attention from a packed qkv
with the rounding points of ``pafuse_tpu/ops/attention.py::_block_body``
(its attention, ``:300-345``): logits = (q . k summed in float32) x
d^-1/2, the softmax over the whole row in float32, the probabilities
rounded to the compute dtype ``T`` (the dtype of qkv) after the row's full
sum, and ``T(sum p v)`` summed in float32.

For CUDA tensors it launches the tensor-core kernels that the block chain
runs at its step 2, and kernels #2 and #5 in float32
(``csrc/attention_core.cu`` on ``csrc/attention_sm90.cuh``: ``mma.sync``,
bf16 products in bfloat16, three TF32 products a product in float32); for
CPU tensors it uses :func:`attention_core_reference`, the same function in
plain PyTorch ops, through which ``ops.block.block_reference`` runs its
attention.  A (sequence, head) whose q, k and v fit a CTA's shared memory
(head size up to 64; L up to 256 in float32 at d = 64) goes through the
resident kernel; any other L, and head sizes up to 128, through the
streamed one, which runs the same arithmetic on key chunks that stream
through shared memory.  A head size above 128 raises ``ValueError``.

``attention_core_bwd`` is kernel #6's attention backward
(``pafuse_tpu/ops/block_grad.py:203-226``): from the saved float32 qkv (B,
L, 3C) and the gradient of the attention output dO (B, L, C) it recomputes
P = softmax(q k^T d^-1/2) and returns dqkv = [dq | dk | dv] (B, L, 3C), dq
= d^-1/2 dS k, dk = d^-1/2 dS^T q, dv = P^T dO, dS = P (dO v^T - rowsum(dO
v^T * P)).  CUDA tensors go through ``csrc/attention_bwd_sm90.cuh`` (built
into ``csrc/attention_core_bwd.cu``; three TF32 products a product; the
resident kernel where q, k, v and dO of one (sequence, head) fit a CTA,
else the streamed one's two passes, with the rows' statistics in a
scratch the wrapper allocates), CPU tensors through
:func:`attention_core_bwd_reference`, through which
``ops.block_train.train_bwd_reference`` runs its attention backward.

Layouts, with the chain's row order: qkv ``(B, L, 3C)`` attends over L for
each of the B sequences; qkv ``(B, F, N, 3C)`` attends over the F frames
for each (b, n), read in place (the chain's ``S = N`` layout of kernels #3
and #4).  Each token's ``3C`` values are ``[q | k | v]``, C =
``num_heads * d``.  The output has qkv's leading dims and C channels.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from pafuse_tpu_torch.ops import _build


def _dims(qkv: torch.Tensor, num_heads: int, what: str):
    """(sequences, L, S, C, d) of a 3-D or 4-D qkv."""
    if qkv.dim() not in (3, 4):
        raise ValueError(f"{what}: qkv must be (B, L, 3C) or (B, F, N, 3C); "
                         f"got {tuple(qkv.shape)}")
    if qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"{what}: last dim {qkv.shape[-1]} is not 3 x "
                         f"{num_heads} heads x a head size")
    C = qkv.shape[-1] // 3
    if qkv.dim() == 3:
        B, L = qkv.shape[:2]
        return B, L, 1, C, C // num_heads
    B, F, N = qkv.shape[:3]
    return B * N, F, N, C, C // num_heads


def attention_core_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`attention_core`."""
    cd = qkv.dtype
    _, L, _, C, d = _dims(qkv, num_heads, "attention_core_reference")
    if qkv.dim() == 3:
        B = qkv.shape[0]
        q, k, v = qkv.float().view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    else:
        B, F, N = qkv.shape[:3]
        # (3, B, N, H, F, d): the frames of each (b, n) read in place
        q, k, v = qkv.float().view(B, F, N, 3, num_heads, d).permute(
            3, 0, 2, 4, 1, 5)
    logits = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(cd).float()
    ao = torch.matmul(probs, v).to(cd)
    if qkv.dim() == 3:
        return ao.transpose(1, 2).reshape(B, L, C)             # (B, H, L, d)
    return ao.permute(0, 3, 1, 2, 4).reshape(B, F, N, C)       # (B, N, H, F, d)


#: the largest head size the tensor-core attention takes (both stages)
MAX_HEAD_DIM = 128


@functools.lru_cache(maxsize=None)
def variant(bf16: bool, L: int, d: int) -> int:
    """Which forward kernel takes (L, d) in bfloat16 or float32: 1 the
    resident one, 2 the streamed one, 0 neither; the library's own rule,
    asked once a shape.  Builds the kernels."""
    return _build.load("attention_core").pafuse_attention_core_variant(
        int(bf16), L, d)


@functools.lru_cache(maxsize=None)
def bwd_variant(L: int, d: int) -> int:
    """The same for the backward (float32)."""
    return _build.load("attention_core_bwd").pafuse_attention_core_bwd_variant(
        L, d)


def _raise_unless_taken(route, L, C, num_heads, what, stage):
    if route == 0:
        raise ValueError(f"{what}: the tensor-core attention{stage} takes "
                         f"head sizes from 1 to {MAX_HEAD_DIM} and at least "
                         f"one token; got d = {C} / {num_heads} = "
                         f"{C // num_heads}, L = {L}")


def check_shape(L: int, C: int, num_heads: int, dtype: torch.dtype,
                what: str) -> None:
    """Raise ValueError where the tensor-core attention does not take (L,
    d = C / num_heads) in ``dtype``: d above MAX_HEAD_DIM, or L < 1.
    Builds the kernels."""
    _raise_unless_taken(variant(dtype == torch.bfloat16, L, C // num_heads),
                        L, C, num_heads, what, "")


def check_bwd_shape(L: int, C: int, num_heads: int, what: str) -> None:
    """The same for the tensor-core attention backward (float32)."""
    _raise_unless_taken(bwd_variant(L, C // num_heads), L, C, num_heads,
                        what, " backward")


def bwd_stats(seqs: int, L: int, C: int, num_heads: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """The streamed backward's scratch of row statistics (m, 1 / l and t / l
    a row and head: 3 x seqs x num_heads x L floats) where the library
    streams (L, C / num_heads), else None: the resident kernel needs none
    and its callers pass NULL."""
    if bwd_variant(L, C // num_heads) != 2:
        return None
    return torch.empty(3 * seqs * num_heads * L, dtype=torch.float32,
                       device=device)


def stream_launches(zero: bool = False) -> Dict[str, int]:
    """Launches of the streamed kernels, counted in the libraries where they
    launch, from any wrapper, since the counts were last zeroed:
    ``forward`` (attention_stream_kernel), ``backward_a`` and
    ``backward_b`` (the backward's two passes, one each a call).  With
    ``zero``, also sets them to 0.  Builds the kernels."""
    fwd = _build.load("attention_core")
    bwd = _build.load("attention_core_bwd")
    return {"forward": fwd.pafuse_attention_core_stream_launches(int(zero)),
            "backward_a": bwd.pafuse_attention_core_bwd_stream_launches(
                0, int(zero)),
            "backward_b": bwd.pafuse_attention_core_bwd_stream_launches(
                1, int(zero))}


def attention_core(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention from qkv (B, L, 3C) or (B, F, N, 3C); returns (B, L, C) or
    (B, F, N, C) in qkv's dtype.

    CUDA tensors go through the tensor-core kernels (built on first use) or
    raise: the resident one where it takes the shape, else the streamed
    one; CPU tensors go through :func:`attention_core_reference`."""
    if qkv.device.type == "cpu":
        return attention_core_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_core: unsupported device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_core: qkv must be float32 or bfloat16; "
                        f"got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("attention_core: qkv must be contiguous")
    seqs, L, S, C, d = _dims(qkv, num_heads, "attention_core")
    check_shape(L, C, num_heads, qkv.dtype, "attention_core")
    lib = _build.load("attention_core")
    out = qkv.new_empty(qkv.shape[:-1] + (C,))
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.pafuse_attention_core(
            int(qkv.dtype == torch.bfloat16), qkv.data_ptr(), out.data_ptr(),
            seqs, L, S, C, num_heads, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"attention_core: CUDA launch failed with "
                           f"cudaError {err}")
    _build.count_launch(attention_core)
    return out


#: kernel launches through ``attention_core`` (CUDA path only; the block
#: chains launch the same kernels from their own wrappers)
attention_core.launches = 0


def attention_core_bwd_reference(qkv: torch.Tensor, do: torch.Tensor,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`attention_core_bwd`: float32 qkv (B,
    L, 3C) and do (B, L, C) -> dqkv (B, L, 3C), with JAX's formula
    (``block_grad.py:210-223``)."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    scale = d ** -0.5
    q, k, v = qkv.view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    P = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1)
    do = do.view(B, L, num_heads, d).transpose(1, 2)     # (B, H, L, d)
    dP = do @ v.transpose(-1, -2)
    dv = P.transpose(-1, -2) @ do
    dS = P * (dP - (dP * P).sum(-1, keepdim=True))
    dq = (dS @ k) * scale
    dk = (dS.transpose(-1, -2) @ q) * scale
    dqkv = torch.stack([dq, dk, dv], dim=2)              # (B, H, 3, L, d)
    return dqkv.permute(0, 3, 2, 1, 4).reshape(B, L, 3 * C)


def attention_core_bwd(qkv: torch.Tensor, do: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """Kernel #6's attention backward alone: float32 qkv (B, L, 3C) and do
    (B, L, C) -> dqkv (B, L, 3C).

    CUDA tensors go through the tensor-core kernels (built on first use) or
    raise, as :func:`attention_core` chooses; CPU tensors go through
    :func:`attention_core_bwd_reference`."""
    if qkv.device.type == "cpu":
        return attention_core_bwd_reference(qkv, do, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_core_bwd: unsupported device "
                         f"{qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"attention_core_bwd: qkv must be (B, L, 3C) with C "
                         f"a multiple of {num_heads} heads; got "
                         f"{tuple(qkv.shape)}")
    B, L, C3 = qkv.shape
    for name, t, shape in (("qkv", qkv, (B, L, C3)),
                           ("do", do, (B, L, C3 // 3))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != qkv.device or not t.is_contiguous()):
            raise ValueError(f"attention_core_bwd: {name} must be a "
                             f"contiguous float32 {shape} tensor on "
                             f"{qkv.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    C = C3 // 3
    check_bwd_shape(L, C, num_heads, "attention_core_bwd")
    lib = _build.load("attention_core_bwd")
    dqkv = torch.empty_like(qkv)
    stats = bwd_stats(B, L, C, num_heads, qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.pafuse_attention_core_bwd(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
            None if stats is None else stats.data_ptr(), B, L, C, num_heads,
            (C // num_heads) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"attention_core_bwd: CUDA launch failed with "
                           f"cudaError {err}")
    _build.count_launch(attention_core_bwd)
    return dqkv


#: kernel launches through ``attention_core_bwd`` (CUDA path only; kernel
#: #6 launches the same kernels from its own wrapper)
attention_core_bwd.launches = 0
