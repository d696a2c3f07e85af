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
the TMA + ``wgmma`` GEMM of ``csrc/gemm_sm90.cuh``, the weight gradients on
``mma.sync`` per chunk of ``RED_ROWS`` rows, summed in chunk order.
``fwd_linear``, ``data_grad`` and ``weight_grad`` run each alone (plain
versions ``fwd_linear_reference``, through which the plain forward runs
its four products, ``data_grad_reference`` and ``weight_grad_reference``).
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
#: rows per partial sum of a weight gradient (``csrc/block_train.cu``)
RED_ROWS = 1024


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
    """Plain version of :func:`weight_grad`: ``d^T x``."""
    return d.t() @ x


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
    dwfc2, dbfc2 = weight_grad_reference(dm, gu), dm.sum(0)
    dwfc1, dbfc1 = weight_grad_reference(du, h2), du.sum(0)
    dh2 = data_grad_reference(du, wfc1).reshape(B, L, C)
    dx1_ln2, dn2s, dn2b = _ln_bwd(dh2, xhat2, inv2, n2s)
    dx1 = dx2 + dx1_ln2
    # attention branch
    da = (m1 * dx1).reshape(M, C)
    dwproj, dbproj = weight_grad_reference(da, o.reshape(M, C)), da.sum(0)
    do = data_grad_reference(da, wproj).view(B, L, C)
    dqkv = attention_core_bwd_reference(qkv.view(B, L, 3 * C), do,
                                        num_heads).reshape(M, 3 * C)
    dwqkv, dbqkv = weight_grad_reference(dqkv, h1.reshape(M, C)), dqkv.sum(0)
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


def weight_grad(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The backward's weight-gradient GEMM alone: d (M, N)^T x (M, K) ->
    (N, K), summed per chunk of RED_ROWS rows and then in chunk order, on
    the tensor cores for CUDA tensors (or raise);
    :func:`weight_grad_reference` for CPU tensors."""
    if d.device.type == "cpu":
        return weight_grad_reference(d, x)
    if d.device.type != "cuda":
        raise ValueError(f"weight_grad: unsupported device {d.device}")
    _check_2d("weight_grad", d, x)
    (M, N), K = d.shape, x.shape[1]
    if x.shape[0] != M:
        raise ValueError(f"weight_grad: {tuple(d.shape)} and "
                         f"{tuple(x.shape)} differ in rows")
    lib = _build.load("block_train")
    dw = d.new_empty((N, K))
    part = d.new_empty(lib.pafuse_weight_grad_part_floats(M, N, K))
    with torch.cuda.device(d.device):
        err = lib.pafuse_weight_grad(d.data_ptr(), x.data_ptr(),
                                     part.data_ptr(), dw.data_ptr(), M, N, K,
                                     _stream(d))
    _raise_on(err, "weight_grad")
    _build.count_launch(weight_grad)
    return dw


#: kernel launches through the GEMM wrappers (CUDA path only)
fwd_linear.launches = 0
data_grad.launches = 0
weight_grad.launches = 0


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
