"""Trainable MixSTE block + outer LayerNorm with stochastic-depth masks.

Counterpart of ``pafuse_tpu/ops/block_grad.py::block_train_apply`` (the TPU
kernels ``_train_fwd_kernel`` and ``_train_bwd_kernel`` behind a custom VJP):
per sequence b of L tokens,

    x1 = x0 + m1[b] * Attn(LN1(x0));  x2 = x1 + m2[b] * MLP(LN2(x1));
    y  = LN_outer(x2)

with all arithmetic in float32 whatever the dtype of x; y and dx come back in
x's dtype.  LayerNorm eps is 1e-6 and GELU is exact (erf).  m1, m2 are the
stochastic-depth scale factors of the two residual branches, one per
sequence (0 or 1/keep).

``block_train_fwd`` and ``block_train_bwd`` launch the hand-written CUDA
kernels (``csrc/block_train.cu``) for CUDA tensors and use the plain
versions, ``train_fwd_reference`` and ``train_bwd_reference`` (the math of
``block_grad.py:47-124, 165-238`` in PyTorch ops), for CPU tensors.  The CUDA
forward saves the block's intermediates for the backward; the plain backward
recomputes them from the inputs.  ``block_train`` wraps the pair as a
``torch.autograd.Function`` that returns dx, the 14 parameter gradients and
zero gradients for the masks.

Every GEMM runs on the tensor cores, each float32 product as three TF32
products (``ops.gemm.split_tf32``) with partial sums over pairs of 32-deep K
slices added in float32: the forward's four products (with their bias,
GELU and masked-residual epilogues) and the backward's data gradients on
the TMA + ``wgmma`` GEMM of ``csrc/gemm_sm90.cuh``, the weight gradients
and their bias gradients together on the ``wgmma`` kernel of
``csrc/wgrad_sm90.cuh``, per chunk of :func:`weight_grad_chunk_rows` rows,
summed in chunk order.  ``fwd_linear``, ``data_grad`` and ``weight_grads``
run each alone (plain versions ``fwd_linear_reference``, through which the
plain forward runs its four products, ``data_grad_reference`` and
``weight_grads_reference``).  The backward's three LayerNorm backwards run
on ``ln_bwd_kernel`` (a warp a row, 16-byte vectors, one wave of CTAs of
:func:`ln_backward_rows` rows) and the parameter partials' fixed two-level
sum ``ln_sums_kernel``; ``ln_backward`` runs them alone (plain
``ln_backward_reference``).
The attention forward and backward run on the tensor-core kernels of
``ops.attention_core`` in float32 (plain ``attention_core_bwd_reference``,
through which the plain backward runs its attention backward), which take
any L and head sizes up to 128 (a (sequence, head) held in shared memory, or
streamed through it beyond); a head size above 128, or C above 1024, raises
``ValueError`` before any launch.

Parameters are the 14 float32 tensors of ``ops.block`` in torch layout:
``(norm1.weight, norm1.bias, qkv.weight, qkv.bias, proj.weight, proj.bias,
norm2.weight, norm2.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
outer.weight, outer.bias)``, Linear weights as (out, in).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.ops.attention_core import (attention_core_bwd_reference,
                                                 bwd_stats, check_bwd_shape,
                                                 check_shape)
from pafuse_tpu_torch.ops.block import _check as _check_block


_EPS = 1e-6
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
#: the weight-gradient kernel's tile rows, rows of a chunk a multiple of,
#: SMs and cost of an item in rows, as ``csrc/wgrad_sm90.cuh`` sets them
_WG_BM, _WG_ALIGN, _WG_WAVE, _WG_ITEM_OVERHEAD = 128, 64, 132, 64


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _wgrad_tile_n(K: int) -> int:
    if K % 128 == 0:
        return 128
    return 112 if K % 112 == 0 else 96 if K % 96 == 0 else 128


def weight_grad_chunk_rows(M: int, N: int, K: int) -> int:
    """Rows of a chunk of the weight- and bias-gradient partials of d (M,
    N) and x (M, K) (``wgrad::chunk_rows`` in ``csrc/wgrad_sm90.cuh``): a
    function of the shape alone, so the summation order is too.  Over the
    chunk counts P, the rows R = ceil(M / P) rounded up to a multiple of 64
    (where that still makes P chunks), the R of least cost ceil(tiles * P /
    132) * (R + 64) (tiles: 128 x BN tiles of the (N, K) output, BN 128
    where that divides K, else 112 or 96 where one of them does, else
    128), the fewest chunks among equals; the last chunk takes what is
    left."""
    bn = _wgrad_tile_n(K)
    tiles = _ceil(N, _WG_BM) * _ceil(K, bn)
    best = None
    for p in range(1, _ceil(M, _WG_ALIGN) + 1):
        r = _ceil(_ceil(M, p), _WG_ALIGN) * _WG_ALIGN
        if _ceil(M, r) != p:
            continue
        cost = _ceil(tiles * p, _WG_WAVE) * (r + _WG_ITEM_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, r)
    return best[1]


#: the LayerNorm backward's SMs a wave and warps a CTA, and its ordered
#: pass's split (partials p = s, s + LN_SUM_SPLIT, ... summed apart, then the
#: LN_SUM_SPLIT sums in s order), as ``csrc/block_train.cu`` sets them
_LNB_SMS, LN_BWD_WARPS, LN_SUM_SPLIT = 132, 8, 32


def ln_backward_rows(M: int, C: int) -> int:
    """Rows of a CTA of the LayerNorm backward (``ln_rows`` in
    ``csrc/block_train.cu``), a function of (M, C) alone, so the order of
    its sums is too: a lane holds ceil(C / 128) 4-column chunks (6 or 8
    past 512), which lets 3 CTAs share an SM up to 256 columns, 2 up to 512
    and 1 beyond; the grid is one wave of them on 132 SMs, ceil(M / (132 *
    CTAs)) rows each, the last CTA taking what is left."""
    chunks = next(n for n, w in ((1, 128), (2, 256), (3, 384), (4, 512),
                                 (6, 768), (8, 1024)) if C <= w)
    ctas = 3 if chunks <= 2 else 2 if chunks <= 4 else 1
    return _ceil(M, _LNB_SMS * ctas)


def _ln_fwd(x, s, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + _EPS)
    xhat = (x - mu) * inv
    return xhat * s + b, xhat, inv


def _ln_bwd(dy, xhat, inv, s):
    """(dx, dscale, dbias); parameter gradients summed over all rows."""
    g = dy * s
    dx = inv * (g - g.mean(-1, keepdim=True)
                - xhat * (g * xhat).mean(-1, keepdim=True))
    rows = tuple(range(dy.dim() - 1))
    return dx, (dy * xhat).sum(rows), dy.sum(rows)


def ln_backward_reference(g: torch.Tensor, x: torch.Tensor,
                          mean: torch.Tensor, rstd: torch.Tensor,
                          scale: torch.Tensor,
                          residual: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          seq_len: int = 1):
    """Plain version of :func:`ln_backward`: ``_ln_bwd`` on the (M, C) rows
    with xhat = (x - mean) * rstd from the saved row statistics, plus the
    residual; returns (dx in x's dtype, dxm = mask[m // seq_len] * dx in
    float32 or None, dscale, dbias), all arithmetic in float32."""
    inv = rstd.float()[:, None]
    xhat = (x.float() - mean.float()[:, None]) * inv
    dx, ds, db = _ln_bwd(g.float(), xhat, inv, scale.float())
    if residual is not None:
        dx = residual.float() + dx
    dxm = (None if mask is None
           else mask.float().repeat_interleave(seq_len)[:, None] * dx)
    return dx.to(x.dtype), dxm, ds, db


def _gelu(u):
    return 0.5 * u * (1.0 + torch.erf(u * _INV_SQRT2))


def _gelu_grad(u):
    phi = _INV_SQRT2PI * torch.exp(-0.5 * u * u)
    return 0.5 * (1.0 + torch.erf(u * _INV_SQRT2)) + u * phi


def fwd_linear_reference(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         epilogue: str = "store",
                         residual: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         seq_len: int = 1):
    """Plain version of :func:`fwd_linear` on float32 ``a`` (M, K) and a
    torch Linear weight ``w`` (N, K): ``a @ w^T + b`` ("store"); the pair
    (that, its exact GELU) ("gelu"); or ``residual + mask[m // seq_len] *
    (a @ w^T + b)`` for row m ("residual"; residual (M, N) in float32 or
    bfloat16, mask one float32 factor a sequence of seq_len rows)."""
    y = a @ w.t() + b
    if epilogue == "store":
        return y
    if epilogue == "gelu":
        return y, _gelu(y)
    if epilogue == "residual":
        return residual.float() + mask.repeat_interleave(seq_len)[:, None] * y
    raise ValueError(f"unknown epilogue {epilogue!r}")


def _fwd_core(x0, m1, m2, params, num_heads):
    """The forward on float32 (B, L, C) with masks (B, 1, 1), its four
    products through :func:`fwd_linear_reference` on the (B*L, C) rows;
    returns y and the intermediates the backward needs."""
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     nos, nob) = params
    B, L, C = x0.shape
    M, d = B * L, C // num_heads
    h1, xhat1, inv1 = _ln_fwd(x0, n1s, n1b)
    qkv = fwd_linear_reference(h1.reshape(M, C), wqkv, bqkv)
    q, k, v = qkv.view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    P = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1)
    o = (P @ v).transpose(1, 2).reshape(B, L, C)
    x1 = fwd_linear_reference(o.reshape(M, C), wproj, bproj, "residual",
                              x0.reshape(M, C), m1.reshape(B), L).view(B, L, C)
    h2, xhat2, inv2 = _ln_fwd(x1, n2s, n2b)
    u, gu = fwd_linear_reference(h2.reshape(M, C), wfc1, bfc1, "gelu")
    x2 = fwd_linear_reference(gu, wfc2, bfc2, "residual", x1.reshape(M, C),
                              m2.reshape(B), L).view(B, L, C)
    y, xhato, invo = _ln_fwd(x2, nos, nob)
    return y, (h1, xhat1, inv1, qkv, o, xhat2, inv2, h2, u, gu, xhato, invo)


def _masks(m: torch.Tensor) -> torch.Tensor:
    return m.float().reshape(-1, 1, 1)


def train_fwd_reference(x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                        params: Sequence[torch.Tensor],
                        num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of kernel #5.  x: (B, L, C); m1, m2: (B,)."""
    y, _ = _fwd_core(x.float(), _masks(m1), _masks(m2),
                     [p.float() for p in params], num_heads)
    return y.to(x.dtype)


def data_grad_reference(a: torch.Tensor, w: torch.Tensor,
                        aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`data_grad`: ``(a @ w) * gelu'(aux)``."""
    y = a @ w
    return y if aux is None else y * _gelu_grad(aux)


def weight_grad_reference(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The weight gradient ``d^T x``."""
    return d.t() @ x


def weight_grads_reference(d: torch.Tensor, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`weight_grads`: ``(d^T x, d.sum(0))``."""
    return weight_grad_reference(d, x), d.sum(0)


def train_bwd_reference(x: torch.Tensor, g: torch.Tensor, m1: torch.Tensor,
                        m2: torch.Tensor, params: Sequence[torch.Tensor],
                        num_heads: int
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain PyTorch version of kernel #6: recomputes the forward, then
    returns (dx in x.dtype, the 14 parameter gradients in float32)."""
    params = [p.float() for p in params]
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     nos, nob) = params
    m1, m2 = _masks(m1), _masks(m2)
    B, L, C = x.shape
    (_, (h1, xhat1, inv1, qkv, o, xhat2, inv2, h2, u, gu, xhato,
         invo)) = _fwd_core(x.float(), m1, m2, params, num_heads)
    M = B * L

    dx2, dnos, dnob = _ln_bwd(g.float(), xhato, invo, nos)
    # MLP branch
    dm = (m2 * dx2).reshape(M, C)
    gu, u, h2 = gu.reshape(M, -1), u.reshape(M, -1), h2.reshape(M, C)
    du = data_grad_reference(dm, wfc2, u)
    dwfc2, dbfc2 = weight_grads_reference(dm, gu)
    dwfc1, dbfc1 = weight_grads_reference(du, h2)
    dh2 = data_grad_reference(du, wfc1).reshape(B, L, C)
    dx1_ln2, dn2s, dn2b = _ln_bwd(dh2, xhat2, inv2, n2s)
    dx1 = dx2 + dx1_ln2
    # attention branch
    da = (m1 * dx1).reshape(M, C)
    dwproj, dbproj = weight_grads_reference(da, o.reshape(M, C))
    do = data_grad_reference(da, wproj).view(B, L, C)
    dqkv = attention_core_bwd_reference(qkv.view(B, L, 3 * C), do,
                                        num_heads).reshape(M, 3 * C)
    dwqkv, dbqkv = weight_grads_reference(dqkv, h1.reshape(M, C))
    dh1 = data_grad_reference(dqkv, wqkv).reshape(B, L, C)
    dx0_ln1, dn1s, dn1b = _ln_bwd(dh1, xhat1, inv1, n1s)
    dx0 = dx1 + dx0_ln1
    return dx0.to(x.dtype), (dn1s, dn1b, dwqkv, dbqkv, dwproj, dbproj, dn2s,
                             dn2b, dwfc1, dbfc1, dwfc2, dbfc2, dnos, dnob)


class TrainSaved(NamedTuple):
    """What the forward hands to the backward: its inputs and, on the CUDA
    path, the kernel's workspace of saved intermediates."""
    x: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    params: Tuple[torch.Tensor, ...]
    num_heads: int
    workspace: Optional[torch.Tensor]


def _check(x, m1, m2, params, num_heads) -> None:
    _check_block(x, params, num_heads, "block_train")
    B = x.shape[0]
    for name, m in (("m1", m1), ("m2", m2)):
        if (tuple(m.shape) != (B,) or m.dtype != torch.float32
                or m.device != x.device or not m.is_contiguous()):
            raise ValueError(f"block_train: {name} must be a contiguous float32 "
                             f"({B},) tensor on {x.device}; got {m.dtype} "
                             f"{tuple(m.shape)} on {m.device}")
    if x.shape[2] > 1024:
        raise ValueError(f"block_train: C={x.shape[2]} > 1024 is not supported "
                         f"(the LayerNorm backward holds at most 1024 "
                         f"columns a row)")
    if x.shape[2] % 8 or params[8].shape[0] % 8:
        raise ValueError("block_train: C and the hidden width must be "
                         "multiples of 8 (the tensor-core GEMMs' tiles)")


def _lib_and_dims(x, params, num_heads):
    """The library and (B, L, C, H, hidden, scale), after checking that both
    attention stages take (L, C / H); the forward checks the backward's
    shape too, so a step that cannot finish does not start."""
    B, L, C = x.shape
    check_shape(L, C, num_heads, torch.float32, "block_train")
    check_bwd_shape(L, C, num_heads, "block_train")
    return _build.load("block_train"), (B, L, C, num_heads, params[8].shape[0],
                                        (C // num_heads) ** -0.5)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def block_train_fwd(x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                    params: Sequence[torch.Tensor], num_heads: int
                    ) -> Tuple[torch.Tensor, TrainSaved]:
    """Kernel #5 on (B, L, C): returns (y in x.dtype, what the backward
    takes).  CUDA tensors go through the CUDA kernels (built on first use)
    or raise; CPU tensors go through :func:`train_fwd_reference`."""
    params = tuple(params)
    if x.device.type == "cpu":
        y = train_fwd_reference(x, m1, m2, params, num_heads)
        return y, TrainSaved(x, m1, m2, params, num_heads, None)
    if x.device.type != "cuda":
        raise ValueError(f"block_train_fwd: unsupported device {x.device}")
    _check(x, m1, m2, params, num_heads)
    lib, (B, L, C, H, hid, scale) = _lib_and_dims(x, params, num_heads)
    workspace = torch.empty(lib.pafuse_block_train_saved_floats(B, L, C, hid),
                            dtype=torch.float32, device=x.device)
    # the weights' TF32 halves: a temporary of this call, freed on return
    split = torch.empty(lib.pafuse_block_train_split_floats(C, hid),
                        dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pafuse_block_train_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), *[p.data_ptr() for p in params], y.data_ptr(),
            workspace.data_ptr(), split.data_ptr(),
            _build.attention_function(), B, L, C, H, hid, scale, _stream(x))
    _raise_on(err, "block_train_fwd")
    _build.count_launch(block_train_fwd)
    return y, TrainSaved(x, m1, m2, params, num_heads, workspace)


def block_train_bwd(ctx: TrainSaved, g: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Kernel #6: (dx in x.dtype, the 14 float32 parameter gradients summed
    over all rows).  CUDA tensors go through the CUDA kernels or raise; CPU
    tensors go through :func:`train_bwd_reference`."""
    x, m1, m2, params, num_heads, workspace = ctx
    if x.device.type == "cpu":
        return train_bwd_reference(x, g, m1, m2, params, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"block_train_bwd: unsupported device {x.device}")
    if workspace is None:
        raise ValueError("block_train_bwd: no saved workspace; the forward "
                         "did not run block_train_fwd on CUDA")
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"block_train_bwd: g must be a contiguous "
                         f"{x.dtype} {tuple(x.shape)} tensor on {x.device}")
    lib, (B, L, C, H, hid, scale) = _lib_and_dims(x, params, num_heads)
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=x.device)
    grads = tuple(t.view(p.shape) for t, p in zip(
        flat.split([p.numel() for p in params]), params))
    dx = torch.empty_like(x)
    scratch = torch.empty(lib.pafuse_block_train_scratch_floats(B, L, C, hid),
                          dtype=torch.float32, device=x.device)
    stats = bwd_stats(B, L, C, H, x.device)
    with torch.cuda.device(x.device):
        err = lib.pafuse_block_train_bwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), g.data_ptr(),
            m1.data_ptr(), m2.data_ptr(), *[p.data_ptr() for p in params],
            workspace.data_ptr(), dx.data_ptr(), flat.data_ptr(),
            scratch.data_ptr(), None if stats is None else stats.data_ptr(),
            _build.attention_bwd_function(), B, L, C, H, hid, scale,
            _stream(x))
    _raise_on(err, "block_train_bwd")
    _build.count_launch(block_train_bwd)
    return dx, grads


#: kernel launches through the wrappers (CUDA path only)
block_train_fwd.launches = 0
block_train_bwd.launches = 0


def _check_2d(what, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if (t.dim() != 2 or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{what}: expected contiguous 2-D float32 "
                             f"tensors on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.shape[1] % 8:
            raise ValueError(f"{what}: widths must be multiples of 8; got "
                             f"{tuple(t.shape)}")


_FWD_EPILOGUES = {"store": 0, "gelu": 1, "residual": 2}


def fwd_linear(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               epilogue: str = "store", residual: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, seq_len: int = 1):
    """The forward's GEMM alone: ``a`` (M, K) float32 times the torch Linear
    weight ``w`` (N, K) plus ``b``, with the epilogue of
    :func:`fwd_linear_reference`; float32 (M, N), or the pair (u, gelu(u))
    for "gelu".  On the tensor cores for CUDA tensors (or raise);
    :func:`fwd_linear_reference` for CPU tensors."""
    if a.device.type == "cpu":
        return fwd_linear_reference(a, w, b, epilogue, residual, mask, seq_len)
    if a.device.type != "cuda":
        raise ValueError(f"fwd_linear: unsupported device {a.device}")
    if epilogue not in _FWD_EPILOGUES:
        raise ValueError(f"fwd_linear: unknown epilogue {epilogue!r}")
    _check_2d("fwd_linear", a, w, b.view(1, -1))
    (M, K), N = a.shape, w.shape[0]
    if w.shape[1] != K or tuple(b.shape) != (N,):
        raise ValueError(f"fwd_linear: a {tuple(a.shape)}, w {tuple(w.shape)} "
                         f"and b {tuple(b.shape)} do not fit")
    if epilogue == "residual":
        if (tuple(residual.shape) != (M, N) or residual.device != a.device
                or residual.dtype not in (torch.float32, torch.bfloat16)
                or not residual.is_contiguous()):
            raise ValueError(f"fwd_linear: residual must be a contiguous "
                             f"float32 or bfloat16 ({M}, {N}) tensor on "
                             f"{a.device}")
        if (seq_len < 1 or M % seq_len or mask.dtype != torch.float32
                or tuple(mask.shape) != (M // seq_len,)
                or mask.device != a.device or not mask.is_contiguous()):
            raise ValueError(f"fwd_linear: mask must be a contiguous float32 "
                             f"({M} // seq_len,) tensor on {a.device}, "
                             f"seq_len a divisor of {M}")
    lib = _build.load("block_train")
    y = a.new_empty((M, N))
    y2 = a.new_empty((M, N)) if epilogue == "gelu" else None
    ws = a.new_empty(2 * N * K)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        err = lib.pafuse_fwd_linear(
            a.data_ptr(), w.data_ptr(), b.data_ptr(), _FWD_EPILOGUES[epilogue],
            ptr(residual), int(residual is not None
                               and residual.dtype == torch.bfloat16),
            ptr(mask), seq_len, y.data_ptr(), ptr(y2), ws.data_ptr(), M, N, K,
            _stream(a))
    _raise_on(err, "fwd_linear")
    _build.count_launch(fwd_linear)
    return y if y2 is None else (y, y2)


def data_grad(a: torch.Tensor, w: torch.Tensor,
              aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward's data-gradient GEMM alone: a (M, K) @ w (K, N), times
    gelu'(aux (M, N)) when given, on the tensor cores for CUDA tensors (or
    raise); :func:`data_grad_reference` for CPU tensors."""
    if a.device.type == "cpu":
        return data_grad_reference(a, w, aux)
    if a.device.type != "cuda":
        raise ValueError(f"data_grad: unsupported device {a.device}")
    (M, K), N = a.shape, w.shape[1]
    _check_2d("data_grad", a, w, *([] if aux is None else [aux]))
    if w.shape[0] != K or (aux is not None and tuple(aux.shape) != (M, N)):
        raise ValueError(f"data_grad: a {tuple(a.shape)}, w {tuple(w.shape)} "
                         f"and aux {None if aux is None else tuple(aux.shape)} "
                         f"do not fit")
    lib = _build.load("block_train")
    y = a.new_empty((M, N))
    ws = a.new_empty(2 * N * K)
    with torch.cuda.device(a.device):
        err = lib.pafuse_data_grad(a.data_ptr(), w.data_ptr(),
                                   None if aux is None else aux.data_ptr(),
                                   y.data_ptr(), ws.data_ptr(), M, N, K,
                                   _stream(a))
    _raise_on(err, "data_grad")
    _build.count_launch(data_grad)
    return y


def weight_grads(d: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's weight- and bias-gradient kernel alone: (d (M, N)^T x
    (M, K) -> (N, K), the column sums of d -> (N,)), both summed per chunk
    of :func:`weight_grad_chunk_rows` rows and then in chunk order, on the
    tensor cores for CUDA tensors (or raise);
    :func:`weight_grads_reference` for CPU tensors."""
    if d.device.type == "cpu":
        return weight_grads_reference(d, x)
    if d.device.type != "cuda":
        raise ValueError(f"weight_grads: unsupported device {d.device}")
    _check_2d("weight_grads", d, x)
    (M, N), K = d.shape, x.shape[1]
    if x.shape[0] != M:
        raise ValueError(f"weight_grads: {tuple(d.shape)} and "
                         f"{tuple(x.shape)} differ in rows")
    lib = _build.load("block_train")
    out = d.new_empty(N * K + N)            # dW, then db
    part = d.new_empty(lib.pafuse_weight_grads_part_floats(M, N, K))
    with torch.cuda.device(d.device):
        err = lib.pafuse_weight_grads(d.data_ptr(), x.data_ptr(),
                                      part.data_ptr(), out.data_ptr(), M, N,
                                      K, _stream(d))
    _raise_on(err, "weight_grads")
    _build.count_launch(weight_grads)
    return out[:N * K].view(N, K), out[N * K:]


def _check_ln(g, x, mean, rstd, scale, residual, mask, seq_len) -> None:
    if g.dim() != 2 or tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"ln_backward: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be the same (M, C)")
    M, C = x.shape
    if not 1 <= M < 2 ** 31:
        raise ValueError(f"ln_backward: M={M} rows; the kernel takes 1 to "
                         f"2^31 - 1")
    want = [(g, (M, C), (torch.float32, torch.bfloat16)),
            (x, (M, C), (torch.float32, torch.bfloat16)),
            (mean, (M,), (torch.float32,)), (rstd, (M,), (torch.float32,)),
            (scale, (C,), (torch.float32,))]
    if residual is not None:
        want.append((residual, (M, C), (torch.float32,)))
    if mask is not None:
        if seq_len < 1 or M % seq_len:
            raise ValueError(f"ln_backward: seq_len {seq_len} does not divide "
                             f"{M} rows")
        want.append((mask, (M // seq_len,), (torch.float32,)))
    if g.dtype == x.dtype == torch.bfloat16:
        raise ValueError("ln_backward: g and x are not both bfloat16 in any "
                         "call of the block's backward; one of them is "
                         "float32")
    for t, shape, dtypes in want:
        if (tuple(t.shape) != shape or t.dtype not in dtypes
                or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"ln_backward: expected a contiguous {shape} "
                             f"tensor of {dtypes} on {x.device}, 16-byte "
                             f"aligned; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def ln_backward(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor, scale: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, seq_len: int = 1):
    """The backward's LayerNorm backward alone, as ``block_train.cu``'s
    ``train_bwd`` runs it three times: (dx in x's dtype, dxm = mask[m //
    seq_len] * dx in float32 or None, dscale, dbias) for g and x (M, C) in
    float32 or one of them in bfloat16 (the outer norm's g and LN1's x in a
    bfloat16 block), the row statistics mean and rstd (M,), the scale
    (C,), a float32 residual (M, C) added to dx and a float32 mask a
    sequence of seq_len rows.  dscale and dbias are summed per CTA of
    :func:`ln_backward_rows` rows and then in a fixed order.  On the
    kernels for CUDA tensors (or raise); :func:`ln_backward_reference` for
    CPU tensors.  C must be a multiple of 8 up to 1024 on either device."""
    C = x.shape[-1]
    if C % 8 or C > 1024:
        raise ValueError(f"ln_backward: C={C} must be a multiple of 8 up to "
                         f"1024 (the kernel holds 4-column chunks of at most "
                         f"1024 columns a row)")
    if x.device.type == "cpu":
        return ln_backward_reference(g, x, mean, rstd, scale, residual, mask,
                                     seq_len)
    if x.device.type != "cuda":
        raise ValueError(f"ln_backward: unsupported device {x.device}")
    _check_ln(g, x, mean, rstd, scale, residual, mask, seq_len)
    M, C = x.shape
    lib = _build.load("block_train")
    dx = torch.empty_like(x)
    dxm = None if mask is None else torch.empty(M, C, device=x.device)
    out = torch.empty(2 * C, device=x.device)     # dscale, then dbias
    part = torch.empty(lib.pafuse_ln_backward_part_floats(M, C),
                       device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        err = lib.pafuse_ln_backward(
            int(g.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
            g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            scale.data_ptr(), ptr(residual), ptr(mask), seq_len,
            dx.data_ptr(), ptr(dxm), part.data_ptr(), out.data_ptr(), M, C,
            _stream(x))
    _raise_on(err, "ln_backward")
    _build.count_launch(ln_backward)
    return dx, dxm, out[:C], out[C:]


#: kernel launches through the GEMM and LayerNorm-backward wrappers (CUDA
#: path only)
fwd_linear.launches = 0
data_grad.launches = 0
weight_grads.launches = 0
ln_backward.launches = 0


class BlockTrainFn(torch.autograd.Function):
    """Autograd for the trainable block: forward kernel #5, backward kernel
    #6 (``plain=True``: their plain versions, on any device)."""

    @staticmethod
    def forward(ctx, x, m1, m2, num_heads, plain, *params):
        if plain:
            y = train_fwd_reference(x, m1, m2, params, num_heads)
            ctx.train_saved = TrainSaved(x, m1, m2, params, num_heads, None)
        else:
            y, ctx.train_saved = block_train_fwd(x, m1, m2, params, num_heads)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, g):
        saved, ctx.train_saved = ctx.train_saved, None
        if ctx.plain:
            x, m1, m2, params, num_heads, _ = saved
            dx, grads = train_bwd_reference(x, g, m1, m2, params, num_heads)
        else:
            dx, grads = block_train_bwd(saved, g.contiguous())
        dm1 = torch.zeros_like(saved.m1) if ctx.needs_input_grad[1] else None
        dm2 = torch.zeros_like(saved.m2) if ctx.needs_input_grad[2] else None
        return (dx, dm1, dm2, None, None) + tuple(grads)


def block_train(x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                params: Sequence[torch.Tensor], num_heads: int) -> torch.Tensor:
    """Differentiable block through kernels #5 and #6 (plain versions on
    the CPU)."""
    return BlockTrainFn.apply(x, m1, m2, num_heads, False, *params)


def block_train_plain(x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                      params: Sequence[torch.Tensor],
                      num_heads: int) -> torch.Tensor:
    """The same block through the plain versions on any device: the
    comparison path of checks on the card."""
    return BlockTrainFn.apply(x, m1, m2, num_heads, True, *params)



def select_train_block_fn(train_kernel="auto"):
    """The training block of ``gpu.train_kernel``, as the JAX package's
    ``select_train_block_fn`` (``block_grad.py:442``): ``auto``/``true``
    -> :func:`block_train` (kernels #5/#6; their plain versions on the
    CPU); ``false`` -> None, the autodiff path of ``models.mixste``.  Any
    other value raises."""
    mode = str(train_kernel).lower()
    if mode in ("auto", "true"):
        return block_train
    if mode == "false":
        return None
    raise ValueError(f"train_kernel={train_kernel!r}: expected auto, true "
                     "or false")
