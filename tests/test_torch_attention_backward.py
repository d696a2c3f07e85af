"""Kernel #6's attention backward (pafuse_tpu_torch.ops.attention_core).

``attention_core_bwd_reference`` is the one plain attention backward of the
trainable block: ``train_bwd_reference`` runs through it, so the block
tests against the TPU kernels in interpret mode and ``jax.grad``
(test_torch_block_train.py) hold it inside the whole backward.  Here:

- it equals, bit for bit, the attention backward as ``train_bwd_reference``
  computed it inline before it became a function, at the training shapes'
  token counts and head sizes, and ``train_bwd_reference`` and
  ``train_fwd_reference`` (kernel #5's plain path) keep their bits, as does
  ``attention_reference`` (kernel #2's plain path);
- in float32 it agrees with ``jax.vjp`` of the per-head attention of
  ``pafuse_tpu/ops/block_grad.py::_fwd_core`` (whose backward
  ``_train_bwd_kernel`` writes out at :203-226), within 2e-6 x max|dqkv|
  (both float32 at the highest matmul precision, sums in another order);
- the tensor-core kernel's arithmetic, emulated on the CPU (three TF32
  products a product with ``split_tf32``, the two small ones summed apart
  in S and dP; head size padded with zeros to 32/48/64; keys padded to the
  key chunks and masked to -inf; pass A's row max, sum and sum of e * dP
  gathered chunk by chunk, chunks of 48 or 64 keys past 80 keys; pass B's
  dk and dv summed over 16-query tiles in order) stays within
  ATTN_BWD_RTOL = 1e-5 x max|plain| of the plain version for each of dq,
  dk and dv, on the qkv the training forward computes (LN1(x) @ Wqkv +
  bqkv) and a unit-variance dO, at every training shape's L and d, at the
  monolithic model's L = 134 and at L = 243; and inside the whole plain
  backward it keeps the block's bound, 1e-4 x max|gradient|;
- so does the streamed kernel's order (it takes a head size above 64 or a
  unit beyond a CTA's shared memory: d padded to 64 or 128, pass A's row
  statistics gathered over chunks of 32 keys, pass B's order unchanged) at
  MixSTE's 243 and 351 frames and at d = 128.
The kernel itself against this plain version runs on the card
(tests/test_torch_cuda.py, chip_smoke.py's train_kernel and mono134_kernel
phases).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu_torch.ops import block_train as port_block_train
from pafuse_tpu_torch.ops.attention import attention_reference
from pafuse_tpu_torch.ops.attention_core import (attention_core_bwd,
                                                 attention_core_bwd_reference)
from pafuse_tpu_torch.ops.block_train import (_ln_bwd, _ln_fwd, _masks,
                                              data_grad_reference,
                                              fwd_linear_reference,
                                              train_bwd_reference,
                                              train_fwd_reference,
                                              weight_grad_reference)
from pafuse_tpu_torch.ops.gemm import split_tf32

torch.set_num_threads(2)

HEADS = 8
TOKENS = (17, 24, 27, 42, 68, 134)
HEAD_SIZES = (28, 32, 36, 48)
ATTN_BWD_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4


def _former_inline(qkv, do, num_heads):
    """The attention backward as train_bwd_reference computed it inline: P
    from _fwd_core's q, k, v, then the gradients; (B, L, 3C), (B, L, C) ->
    (B*L, 3C)."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    scale = d ** -0.5
    q, k, v = qkv.reshape(B * L, C3).view(B, L, 3, num_heads, d).permute(
        2, 0, 3, 1, 4)
    P = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1)
    do = do.reshape(B * L, C).view(B, L, num_heads, d)
    do = do.transpose(1, 2)
    dP = do @ v.transpose(-1, -2)
    dv = P.transpose(-1, -2) @ do
    dS = P * (dP - (dP * P).sum(-1, keepdim=True))
    dq = (dS @ k) * scale
    dk = (dS.transpose(-1, -2) @ q) * scale
    dqkv = torch.stack([dq, dk, dv], dim=2)
    return dqkv.permute(0, 3, 2, 1, 4).reshape(B * L, 3 * C)


def _qkv_do(B, L, d, seed):
    r = np.random.RandomState(seed)
    C = HEADS * d
    return (torch.tensor(r.randn(B, L, 3 * C), dtype=torch.float32),
            torch.tensor(r.randn(B, L, C), dtype=torch.float32))


@pytest.mark.parametrize("L", TOKENS)
def test_reference_equals_former_inline_backward(L):
    for i, d in enumerate(HEAD_SIZES):
        qkv, do = _qkv_do(3, L, d, L + i)
        got = attention_core_bwd_reference(qkv, do, HEADS)
        assert got.shape == qkv.shape and got.dtype == torch.float32
        assert torch.equal(got.reshape(-1, qkv.shape[-1]),
                           _former_inline(qkv, do, HEADS)), (L, d)
        # the CPU wrapper is the plain version
        assert torch.equal(attention_core_bwd(qkv, do, HEADS), got)


def _params(C, seed):
    """The 14 block tensors (torch layout), seeded."""
    r = np.random.RandomState(seed)
    hid = 2 * C

    def u(shape, fan_in):
        return r.uniform(-1, 1, shape) / np.sqrt(fan_in)

    def ln():
        return [1 + 0.1 * r.randn(C), 0.1 * r.randn(C)]

    arrays = (ln() + [u((3 * C, C), C), u((3 * C,), C), u((C, C), C),
                      u((C,), C)] + ln()
              + [u((hid, C), C), u((hid,), C), u((C, hid), hid), u((C,), hid)]
              + ln())
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def _former_train_bwd(x, g, m1, m2, params, num_heads):
    """train_bwd_reference as it was before its attention backward became
    attention_core_bwd_reference (its forward recomputation inline)."""
    params = [p.float() for p in params]
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     nos, nob) = params
    m1, m2 = _masks(m1), _masks(m2)
    B, L, C = x.shape
    d = C // num_heads
    scale = d ** -0.5
    M = B * L
    x0 = x.float()
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

    dx2, dnos, dnob = _ln_bwd(g.float(), xhato, invo, nos)
    dm = (m2 * dx2).reshape(M, C)
    gu, u, h2 = gu.reshape(M, -1), u.reshape(M, -1), h2.reshape(M, C)
    du = data_grad_reference(dm, wfc2, u)
    dwfc2, dbfc2 = weight_grad_reference(dm, gu), dm.sum(0)
    dwfc1, dbfc1 = weight_grad_reference(du, h2), du.sum(0)
    dh2 = data_grad_reference(du, wfc1).reshape(B, L, C)
    dx1_ln2, dn2s, dn2b = _ln_bwd(dh2, xhat2, inv2, n2s)
    dx1 = dx2 + dx1_ln2
    da = (m1 * dx1).reshape(M, C)
    dwproj, dbproj = weight_grad_reference(da, o.reshape(M, C)), da.sum(0)
    do = data_grad_reference(da, wproj).view(B, L, num_heads, d)
    do = do.transpose(1, 2)
    dP = do @ v.transpose(-1, -2)
    dv = P.transpose(-1, -2) @ do
    dS = P * (dP - (dP * P).sum(-1, keepdim=True))
    dq = (dS @ k) * scale
    dk = (dS.transpose(-1, -2) @ q) * scale
    dqkv = torch.stack([dq, dk, dv], dim=2)
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(M, 3 * C)
    dwqkv, dbqkv = weight_grad_reference(dqkv, h1.reshape(M, C)), dqkv.sum(0)
    dh1 = data_grad_reference(dqkv, wqkv).reshape(B, L, C)
    dx0_ln1, dn1s, dn1b = _ln_bwd(dh1, xhat1, inv1, n1s)
    dx0 = dx1 + dx0_ln1
    return y.to(x.dtype), dx0.to(x.dtype), (
        dn1s, dn1b, dwqkv, dbqkv, dwproj, dbproj, dn2s, dn2b, dwfc1, dbfc1,
        dwfc2, dbfc2, dnos, dnob)


def _train_inputs(B, L, C, seed, dtype=torch.float32):
    r = np.random.RandomState(seed)
    pattern = np.array([0.0, 1.0 / 0.9, 1.0], np.float32)
    x, g = (torch.tensor(r.randn(B, L, C), dtype=torch.float32).to(dtype)
            for _ in range(2))
    m1 = torch.tensor(pattern[np.arange(B) % 3])
    m2 = torch.tensor(pattern[(np.arange(B) + 1) % 3])
    return x, g, m1, m2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", [(6, 24, 384), (4, 68, 224), (5, 27, 256),
                                   (3, 17, 288), (2, 134, 288)])
def test_train_references_keep_their_bits(B, L, C, dtype):
    """train_bwd_reference through attention_core_bwd_reference, and
    train_fwd_reference (kernel #5's plain path, whose forward core no
    longer hands q, k, v and P to the backward), equal their former
    versions bit for bit."""
    params = _params(C, seed=L + C)
    x, g, m1, m2 = _train_inputs(B, L, C, seed=B, dtype=dtype)
    want_y, want_dx, want = _former_train_bwd(x, g, m1, m2, params, HEADS)
    got_dx, got = train_bwd_reference(x, g, m1, m2, params, HEADS)
    assert torch.equal(got_dx, want_dx)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(train_fwd_reference(x, m1, m2, params, HEADS), want_y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_reference_keeps_its_bits(dtype):
    """Kernel #2's plain path is untouched: attention_reference equals its
    formula written out (float32 qkv, softmax, AV, projection, one rounding
    to x's dtype)."""
    C, L = 224, 68
    p = _params(C, seed=3)
    x = torch.tensor(np.random.RandomState(4).randn(5, L, C),
                     dtype=torch.float32).to(dtype)
    d = C // HEADS
    qkv = torch.nn.functional.linear(x.float(), p[2], p[3])
    q, k, v = qkv.view(-1, L, 3, HEADS, d).permute(2, 0, 3, 1, 4)
    ao = torch.matmul(torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                                    * d ** -0.5, dim=-1), v)
    want = torch.nn.functional.linear(ao.transpose(1, 2).reshape(-1, L, C),
                                      p[4], p[5]).to(dtype)
    assert torch.equal(attention_reference(x, p[2], p[3], p[4], p[5], HEADS),
                       want)


def _jax_attention(qkv, num_heads):
    """The per-head attention of block_grad._fwd_core on (TB, L, 3C)."""
    c = qkv.shape[-1] // 3
    hd = c // num_heads
    outs = []
    for hh in range(num_heads):
        q = qkv[:, :, hh * hd:(hh + 1) * hd]
        k = qkv[:, :, c + hh * hd:c + (hh + 1) * hd]
        v = qkv[:, :, 2 * c + hh * hd:2 * c + (hh + 1) * hd]
        S = jax.lax.dot_general(
            q, k, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32) * hd ** -0.5
        P = jax.nn.softmax(S, axis=-1)
        outs.append(jax.lax.dot_general(
            P, v, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32))
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("L,d", [(24, 48), (27, 28), (68, 28), (42, 32),
                                 (17, 36), (134, 36), (243, 64), (351, 64),
                                 (243, 128)])
def test_float32_matches_jax_vjp(L, d):
    qkv, do = _qkv_do(4, L, d, L * d)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda t: _jax_attention(t, HEADS),
                         jnp.asarray(qkv.numpy()))
        (want,) = vjp(jnp.asarray(do.numpy()))
    want = np.asarray(want)
    got = attention_core_bwd_reference(qkv, do, HEADS).numpy()
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def _bwd_key_tiles(L):
    """Key tiles of 16 a chunk of the backward (attention_bwd_sm90.cuh)."""
    if L <= 32:
        return 2
    if L <= 48:
        return 3
    if L <= 80:
        return 5
    return 3 if -(-L // 48) * 48 <= -(-L // 64) * 64 else 4


def _three(a, b):
    """a @ b as the kernel's dS K, P^T dO and dS^T Q: lo*hi, hi*lo, hi*hi
    in one sum."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _logits(a, b):
    """a @ b^T as the kernel's S and dP: hi*hi, plus lo*hi + hi*lo summed
    apart."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bh.mT + (al @ bh.mT + ah @ bl.mT)


#: the resident kernel's largest shared memory a CTA, and the streamed
#: kernel's keys (and queries) a chunk (attention_bwd_sm90.cuh STREAM_KC)
SMEM_MAX = 227 * 1024
STREAM_KC = 32


def _streamed(L, d):
    """Whether the streamed backward takes (L, d) (attention_bwd_sm90.cuh's
    variant(): d above 64, or one unit's q, k, v and dO tiles and its
    statistics beyond SMEM_MAX)."""
    if d > 64:
        return True
    kc = 16 * _bwd_key_tiles(L)
    lp = -(-L // kc) * kc
    dp = 32 if d <= 32 else 48 if d <= 48 else 64
    return 4 * (4 * lp * (dp + 4) + 3 * lp) > SMEM_MAX


def test_the_rule_streams_the_shapes_past_the_resident_kernel():
    """L up to 256 at d <= 48 and 192 at d = 64 resident (the monolithic
    model's 134 among them); 243 frames at d = 64 and any d above 64
    streamed."""
    assert not _streamed(256, 48) and _streamed(257, 48)
    assert not _streamed(192, 64) and _streamed(193, 64)
    assert not _streamed(134, 36) and _streamed(243, 64)
    assert _streamed(1, 65) and _streamed(17, 128)


def _emulate(qkv, do, num_heads, streamed=None):
    """The tensor-core backward's arithmetic on qkv (B, L, 3C), do (B, L,
    C), the resident or the streamed kernel's as the rule picks (or the
    streamed one where ``streamed``): returns dqkv (B, L, 3C)."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    scale = d ** -0.5
    if streamed or _streamed(L, d):
        dp, kc = (64 if d <= 64 else 128), STREAM_KC
    else:
        dp = 32 if d <= 32 else 48 if d <= 48 else 64
        kc = 16 * _bwd_key_tiles(L)
    lp = -(-L // kc) * kc
    q, k, v = qkv.view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    g = do.view(B, L, num_heads, d).transpose(1, 2)
    q, k, v, g = (torch.nn.functional.pad(t, (0, dp - d, 0, lp - L))
                  for t in (q, k, v, g))
    # pass A: per query row, the max, sum of e and sum of e * dP over the
    # key chunks; then dS and dq = scale * dS K
    s = _logits(q, k) * scale
    s[..., L:] = -math.inf
    dP = _logits(g, v)
    mx = torch.full(s.shape[:-1] + (1,), -math.inf)
    total = torch.zeros_like(mx)
    tot = torch.zeros_like(mx)
    for c in range(lp // kc):
        part = s[..., c * kc:(c + 1) * kc]
        m = torch.maximum(mx, part.amax(-1, keepdim=True))
        alpha = torch.exp(mx - m)
        e = torch.exp(part - m)
        total = total * alpha + e.sum(-1, keepdim=True)
        tot = tot * alpha + (e * dP[..., c * kc:(c + 1) * kc]).sum(
            -1, keepdim=True)
        mx = m
    inv = 1 / total
    rt = tot * inv
    p = torch.exp(s - mx) * inv
    dS = p * (dP - rt)
    dq = _three(dS, k) * scale
    # pass B: per 16-key tile, dk and dv summed over the query tiles in
    # order, with P^T and dS^T from the stored row statistics
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    tiles = -(-L // 16)
    for qb in range(tiles):
        rows = slice(16 * qb, 16 * qb + 16)
        st = _logits(k, q[..., rows, :]) * scale          # (keys, 16 queries)
        pt = torch.exp(st - mx[..., rows, 0].unsqueeze(-2)) * inv[
            ..., rows, 0].unsqueeze(-2)
        pt = torch.where(torch.arange(16 * qb, 16 * qb + 16) < L, pt, 0.0)
        dpt = _logits(v, g[..., rows, :])
        dst = pt * (dpt - rt[..., rows, 0].unsqueeze(-2))
        dv = dv + _three(pt, g[..., rows, :])
        dk = dk + _three(dst, q[..., rows, :])
    dk = dk * scale
    out = torch.stack([dq, dk, dv], dim=2)[..., :L, :d]  # (B, H, 3, L, d)
    return out.permute(0, 3, 2, 1, 4).reshape(B, L, 3 * C)


def _train_qkv_do(B, L, d, seed):
    """qkv as the training forward computes it (LN1(x) @ Wqkv + bqkv) and a
    unit-variance dO."""
    C = HEADS * d
    r = np.random.RandomState(seed)
    w = torch.tensor(r.uniform(-1, 1, (3 * C, C)) / np.sqrt(C),
                     dtype=torch.float32)
    b = torch.tensor(r.uniform(-1, 1, (3 * C,)) / np.sqrt(C),
                     dtype=torch.float32)
    s = torch.tensor(1 + 0.1 * r.randn(C), dtype=torch.float32)
    t = torch.tensor(0.1 * r.randn(C), dtype=torch.float32)
    x = torch.tensor(r.randn(B, L, C), dtype=torch.float32)
    h, _, _ = _ln_fwd(x, s, t)
    qkv = fwd_linear_reference(h.reshape(B * L, C), w, b).view(B, L, 3 * C)
    return qkv, torch.tensor(r.randn(B, L, C), dtype=torch.float32)


def _rel_errs(got, want, C):
    """max|got - want| / max|want| for dq, dk and dv."""
    return [float((got[..., i * C:(i + 1) * C]
                   - want[..., i * C:(i + 1) * C]).abs().max()
                  / want[..., i * C:(i + 1) * C].abs().max())
            for i in range(3)]


@pytest.mark.parametrize("L", TOKENS + (243,))
def test_tensor_core_arithmetic_within_bound(L):
    for d in HEAD_SIZES:
        qkv, do = _train_qkv_do(2, L, d, L * 100 + d)
        got = _emulate(qkv, do, HEADS)
        want = attention_core_bwd_reference(qkv, do, HEADS)
        errs = _rel_errs(got, want, HEADS * d)
        assert max(errs) <= ATTN_BWD_RTOL, (L, d, errs)


#: the shapes the streamed backward takes on the main paths (as
#: test_torch_attention_core.py's STREAMED; 243 x 64 is MixSTE's cs=512
#: temporal block) and the monolithic model's 134 joints at d = 128
STREAMED = [(243, 64), (351, 64), (351, 48), (243, 128), (134, 128)]


@pytest.mark.parametrize("L,d", STREAMED)
def test_streamed_arithmetic_within_bound(L, d):
    qkv, do = _train_qkv_do(2, L, d, L * 100 + d)
    assert _streamed(L, d)
    got = _emulate(qkv, do, HEADS, streamed=True)
    want = attention_core_bwd_reference(qkv, do, HEADS)
    errs = _rel_errs(got, want, HEADS * d)
    assert max(errs) <= ATTN_BWD_RTOL, (L, d, errs)


@pytest.mark.parametrize("B,L,C", [(6, 24, 384), (4, 68, 224), (3, 134, 288)])
def test_emulated_backward_keeps_the_block_bound(monkeypatch, B, L, C):
    """The plain block backward with its attention backward computed as the
    tensor-core kernel computes it, against the plain block backward:
    within the block's gradient bound (1e-4 x max|gradient| per tensor)."""
    params = _params(C, seed=B + L)
    x, g, m1, m2 = _train_inputs(B, L, C, seed=L)
    want_dx, want = train_bwd_reference(x, g, m1, m2, params, HEADS)
    with monkeypatch.context() as m:
        m.setattr(port_block_train, "attention_core_bwd_reference", _emulate)
        got_dx, got = train_bwd_reference(x, g, m1, m2, params, HEADS)
    for a, b in zip((got_dx,) + got, (want_dx,) + want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= TRAIN_GRAD_RTOL, err


def test_wrapper_rejects_a_bad_device():
    qkv = torch.empty(2, 5, 3 * 8 * 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_core_bwd(qkv, torch.empty(2, 5, 32, device="meta"), HEADS)
