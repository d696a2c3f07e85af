"""The eval block chain's attention stage alone (kernels #1, #3, #4).

``attention_core`` computes per-head softmax attention from a packed qkv
with the rounding points of ``pafuse_tpu/ops/attention.py::_block_body``
(its attention, ``:300-345``): logits = (q . k summed in float32) x
d^-1/2, the softmax over the whole row in float32, the probabilities
rounded to the compute dtype ``T`` (the dtype of qkv) after the row's full
sum, and ``T(sum p v)`` summed in float32.

For CUDA tensors it launches the tensor-core kernel that the block chain
runs at its step 2 (``csrc/attention_core.cu`` on
``csrc/attention_sm90.cuh``: ``mma.sync``, bf16 products in bfloat16,
three TF32 products a product in float32); for CPU tensors it uses
:func:`attention_core_reference`, the same function in plain PyTorch ops,
through which ``ops.block.block_reference`` runs its attention.

Layouts, with the chain's row order: qkv ``(B, L, 3C)`` attends over L for
each of the B sequences; qkv ``(B, F, N, 3C)`` attends over the F frames
for each (b, n), read in place (the chain's ``S = N`` layout of kernels #3
and #4).  Each token's ``3C`` values are ``[q | k | v]``, C =
``num_heads * d``.  The output has qkv's leading dims and C channels.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _unit_bytes(bf16: bool, L: int, d: int):
    """(shared memory of one (sequence, head), a CTA's most), from the
    library: the kernels' own rule, asked once a shape."""
    lib = _build.load("attention_core")
    return (lib.pafuse_attention_core_unit_bytes(int(bf16), L, d),
            lib.pafuse_attention_core_smem_limit())


def check_shape(L: int, C: int, num_heads: int, dtype: torch.dtype,
                what: str) -> None:
    """Raise ValueError where the tensor-core attention does not take (L,
    d = C / num_heads) in ``dtype``: d above 64, or one (sequence, head)'s
    q, k and v beyond a CTA's shared memory.  Builds the kernels."""
    d = C // num_heads
    need, limit = _unit_bytes(dtype == torch.bfloat16, L, d)
    if need == 0:
        raise ValueError(f"{what}: the tensor-core attention takes head "
                         f"sizes up to 64; got d = {C} / {num_heads} = {d}")
    if need > limit:
        raise ValueError(f"{what}: {L} tokens of head size {d} in {dtype} "
                         f"need {need} bytes of shared memory for one "
                         f"(sequence, head), above the {limit} a CTA has")


def attention_core(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention from qkv (B, L, 3C) or (B, F, N, 3C); returns (B, L, C) or
    (B, F, N, C) in qkv's dtype.

    CUDA tensors go through the tensor-core kernel (built on first use) or
    raise; CPU tensors go through :func:`attention_core_reference`."""
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
#: chains launch the same kernel from their own wrappers)
attention_core.launches = 0
