"""The block chain's attention stage (pafuse_tpu_torch.ops.attention_core).

``attention_core_reference`` is the one plain attention of kernels #1, #3
and #4: ``block_reference`` runs through it, so the block tests against the
TPU kernels in interpret mode (test_torch_block.py, test_torch_layer.py,
test_torch_block_temporal.py) hold it inside the whole block.  Here:

- it equals, bit for bit, the attention as ``block_reference`` computed it
  inline before it became a function (on the (B*N, F, C) transposed rows
  for the temporal layout), at the chain's token counts and head sizes, in
  float32 and bfloat16, and ``block_reference`` keeps its bits;
- its (B, F, N, 3C) layout equals transpose -> (B*N, F, 3C) -> transpose;
- in float32 it agrees with the JAX model's ``_attention`` (the projection
  set to the identity), whose rounding points are ``_block_body``'s there;
- the tensor-core kernels' arithmetic, emulated on the CPU (head size
  padded with zeros to 32/48/64, keys padded to the kernel's key chunks and
  masked to -inf, the row's max and sum over the whole row up to 144 keys
  (float32 at 81-144 keys on wgmma: chunks of 64 keys, 48 at d > 48, all
  their logits kept, the sums in the same order) and gathered chunk by
  chunk past 144 keys; the streamed kernel, which takes a head size above 64, bf16 (and
  float32 at d = 49..64) past 144 keys, or a unit beyond a CTA's shared
  memory, with d padded to 64 or 128 and its keys in chunks of 64 at any
  L), stays within its bounds of the plain version:
    float32: three TF32 products a product (split_tf32; in the logits
      hi*hi, and hi*lo + lo*hi summed apart and added; in P V lo*hi, hi*lo,
      hi*hi in one sum) within 1e-6 max abs on the qkv the chain
      computes (LN1(x) @ Wqkv + bqkv, |qkv| < ~3.3).  The dropped lo*lo and
      the split's remainder are each under 2^-22 of a product, so the error
      grows with |q||k| d^-1/2 and |v|: on unit-variance qkv it reaches
      ~1.7e-6;
    bfloat16: bf16 operands, float32 sums, p rounded after the row's full
      sum: each probability within one bf16 ulp of the plain one (the f32
      values before the rounding differ in the last bits: another exp and a
      multiplication by 1 / sum; the streamed kernel's exp is 2^(s c - m)
      with c = d^-1/2 log2(e) folded into one FMA), and each output within
      one bf16 ulp of its own plus what the flipped probabilities carry,
      sum |dp| |v|.
The kernel itself against this plain version runs on the card
(tests/test_torch_cuda.py, chip_smoke.py's attention_stage phase).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu.models import mixste
from pafuse_tpu_torch.ops.attention_core import (attention_core,
                                                 attention_core_reference)
from pafuse_tpu_torch.ops.block import block_reference
from pafuse_tpu_torch.ops.gemm import _layernorm, linear_reference, split_tf32

torch.set_num_threads(2)

HEADS = 8
TOKENS = (1, 17, 24, 27, 68, 134)
HEAD_SIZES = (28, 32, 36, 48)
DTYPES = (torch.float32, torch.bfloat16)


def _former_inline(qkv, num_heads):
    """The attention as block_reference computed it inline: qkv (B, L, 3C)
    in the compute dtype -> (B, L, C)."""
    cd = qkv.dtype
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    q, k, v = qkv.float().view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(cd).float()
    ao = torch.matmul(probs, v).to(cd)                     # (B, H, L, d)
    return ao.transpose(1, 2).reshape(B, L, C)


def _frames_first(qkv):
    """(B, F, N, 3C) -> the (B*N, F, 3C) frame sequences."""
    B, F, N, C3 = qkv.shape
    return qkv.transpose(1, 2).reshape(B * N, F, C3)


def _back(y, B, N):
    """(B*N, F, C) -> (B, F, N, C)."""
    return y.view(B, N, *y.shape[1:]).transpose(1, 2)


def _qkv(shape, d, seed, dtype):
    r = np.random.RandomState(seed)
    return torch.tensor(r.randn(*shape, 3 * HEADS * d),
                        dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("layout", ["S=1", "S=N"])
@pytest.mark.parametrize("L", TOKENS)
def test_reference_equals_former_inline_attention(L, layout):
    for i, d in enumerate(HEAD_SIZES):
        for dtype in DTYPES:
            if layout == "S=1":
                qkv = _qkv((5, L), d, L + i, dtype)
                want = _former_inline(qkv, HEADS)
            else:
                qkv = _qkv((2, L, 3), d, L + i, dtype)
                want = _back(_former_inline(_frames_first(qkv), HEADS), 2, 3)
            got = attention_core_reference(qkv, HEADS)
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.equal(got, want), (L, d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,C", [(24, 384), (68, 224), (27, 288)])
def test_block_reference_keeps_its_bits(dtype, L, C):
    """block_reference through attention_core_reference equals, bit for
    bit, the same block with the attention computed inline."""
    r = np.random.RandomState(C)
    hid = 2 * C

    def u(shape, fan_in):
        return torch.tensor(r.uniform(-1, 1, shape) / np.sqrt(fan_in),
                            dtype=torch.float32)

    def ln():
        return [torch.tensor(1 + 0.1 * r.randn(C), dtype=torch.float32),
                torch.tensor(0.1 * r.randn(C), dtype=torch.float32)]

    bp = (ln() + [u((3 * C, C), C), u((3 * C,), C), u((C, C), C),
                  u((C,), C)] + ln()
          + [u((hid, C), C), u((hid,), C), u((C, hid), hid), u((C,), hid)])
    on = ln()
    x = torch.tensor(r.randn(3, L, C), dtype=torch.float32).to(dtype)
    ao = _former_inline(linear_reference(x, bp[2], bp[3], bp[0:2]), HEADS)
    x1 = linear_reference(ao, bp[4], bp[5], epilogue="residual", residual=x)
    hdn = linear_reference(x1, bp[8], bp[9], bp[6:8], "gelu")
    x2 = linear_reference(hdn, bp[10], bp[11], epilogue="residual",
                          residual=x1)
    want = _layernorm(x2, *on).to(dtype)
    assert torch.equal(block_reference(x, bp, on, HEADS), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("F,N", [(27, 24), (27, 68), (27, 42), (17, 17)])
def test_temporal_layout_equals_transposed_sequences(dtype, F, N):
    qkv = _qkv((2, F, N), 32, F * N, dtype)
    got = attention_core_reference(qkv, HEADS)
    want = _back(attention_core_reference(_frames_first(qkv), HEADS), 2, N)
    assert torch.equal(got, want)
    # the CPU wrapper is the plain version
    assert torch.equal(attention_core(qkv, HEADS), got)


@pytest.mark.parametrize("L,d", [(24, 48), (27, 28), (68, 28), (42, 32),
                                 (17, 36), (134, 36), (243, 64), (351, 64),
                                 (243, 128), (134, 64), (243, 28), (243, 48)])
def test_float32_matches_jax_attention(L, d):
    C = HEADS * d
    r = np.random.RandomState(L * d)
    x = r.randn(6, L, C).astype(np.float32)
    w = (r.uniform(-1, 1, (C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    b = (r.uniform(-1, 1, (3 * C,)) / np.sqrt(C)).astype(np.float32)
    p = {"qkv": {"kernel": w, "bias": b},
         "proj": {"kernel": np.eye(C, dtype=np.float32),
                  "bias": np.zeros(C, np.float32)}}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mixste._attention(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), HEADS,
            jnp.float32))
    qkv = torch.from_numpy(x) @ torch.from_numpy(w) + torch.from_numpy(b)
    got = attention_core_reference(qkv, HEADS).numpy()
    assert np.abs(got - want).max() <= 2e-5


def _key_tiles(L):
    """Key tiles of 16 the kernel holds in registers (attention_sm90.cuh)."""
    return 2 if L <= 32 else 3 if L <= 48 else 5 if L <= 80 else (
        9 if L <= 144 else 4)


#: the resident kernel's largest shared memory a CTA (attention_sm90.cuh
#: SMEM_MAX), and the streamed kernel's keys a chunk (STREAM_KC)
SMEM_MAX = 227 * 1024
STREAM_KC = 64


def _streamed(size, L, d):
    """Whether the streamed kernel takes (L, d) (attention_sm90.cuh's
    variant(): d above 64; past 144 keys (the resident kernel's 64-key
    chunks, the same arithmetic) bf16 at any d and float32 at d = 33..64;
    or one unit's q, k, v tiles beyond SMEM_MAX)."""
    if d > 64 or (_key_tiles(L) == 4 and (size == 2 or d > 32)):
        return True
    kc = 16 * _key_tiles(L)
    dp = 32 if d <= 32 else 48 if d <= 48 else 64
    stride = dp + (8 if size == 2 else 4)
    return 3 * -(-L // kc) * kc * stride * size > SMEM_MAX


def _stream_smem(size, dp):
    """A streamed CTA's shared memory in bytes (attention_sm90.cuh's
    stream_smem): bf16 at its most consumer warpgroups (two, three at d =
    128) a ring of four stages of a K and a V chunk and two Q buffers of a
    tile a warpgroup, 64 128-byte rows (64 values) a 64-value slice of dp
    each, and the ring's and the buffers' twelve mbarriers; float32 (ring chunks of 64 keys, 32 at d = 128) at d = 128 Q's
    TF32 lo tiles (128 rows of 128-byte slices of dp), a ring chunk's K
    tiles by rows and V^T tiles (one per 32 keys), hi and lo, the chunk as
    copied ([keys][dp] twice); both and 1 KB to align the tiles."""
    if size == 2:
        return ((4 * 2 + 2 * (3 if dp > 64 else 2)) * (dp // 64) * 64 * 128
                + 12 * 8 + 1024)
    keys = 32 if dp > 64 else 64
    q_lo = 2 * (dp // 32) * 64 * 128 if dp > 64 else 0
    return (q_lo + (dp // 32) * 2 * keys * 128 + (keys // 32) * 2 * dp * 128
            + 2 * keys * dp * 4 + 1024)


@pytest.mark.parametrize("size,dp,want", [(4, 64, 99328), (4, 128, 164864),
                                          (2, 64, 99424), (2, 128, 230496)])
def test_streamed_shared_memory_fits_a_cta(size, dp, want):
    """Each streamed forward instantiation (float32 and bf16, d padded to
    64 and 128) takes no more shared memory than a CTA may have."""
    assert _stream_smem(size, dp) == want <= SMEM_MAX


def test_the_rule_streams_the_shapes_past_the_resident_kernel():
    """float32: L up to 144 at d = 33..64 (one pass) and 512 at d <= 32
    resident, beyond them streamed; bf16 up to 144 at every d (one pass)
    resident, beyond it streamed; any d above 64 streamed."""
    assert not _streamed(4, 144, 64) and _streamed(4, 145, 64)
    assert _streamed(4, 243, 64) and _streamed(4, 243, 49)
    assert not _streamed(4, 144, 48) and _streamed(4, 145, 48)
    assert _streamed(4, 243, 48) and _streamed(4, 243, 33)
    assert not _streamed(4, 512, 32) and _streamed(4, 513, 32)
    for d in (28, 32, 36, 48, 64):
        assert not _streamed(2, 144, d) and _streamed(2, 145, d)
    assert _streamed(2, 243, 48) and _streamed(2, 351, 48)
    assert _streamed(4, 1, 65) and _streamed(2, 17, 128)


def _emulate(qkv, num_heads, streamed=None):
    """The tensor-core kernels' arithmetic on qkv (B, L, 3C), the resident
    or the streamed one as the rule picks (or the streamed one where
    ``streamed``): returns the output (B, L, C) and the probabilities (B,
    H, L, L), both in qkv's dtype."""
    cd = qkv.dtype
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    stream = bool(streamed or _streamed(qkv.element_size(), L, d))
    if stream:
        dp, kc = (64 if d <= 64 else 128), STREAM_KC
    else:
        dp, kc = (32 if d <= 32 else 48 if d <= 48 else 64), 16 * _key_tiles(L)
    chunks = -(-L // kc)
    q, k, v = qkv.float().view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = (torch.nn.functional.pad(t, (0, dp - d, 0, chunks * kc - L))
               for t in (q, k, v))
    if cd == torch.float32:
        (qh, ql), (kh, kl) = split_tf32(q), split_tf32(k)
        s = qh @ kh.mT + (ql @ kh.mT + qh @ kl.mT)
    else:
        s = q @ k.mT
    # the streamed bf16 kernel: e = 2^(s c - mx), the scale and log2(e)
    # folded into c and one float32 FMA (ex2.approx's ~2 ulp not modelled:
    # two orders of magnitude under what the bf16 rounding of p resolves);
    # the other kernels: e = exp(s d^-1/2 - mx)
    log2 = cd == torch.bfloat16 and stream
    c2 = (torch.tensor(d ** -0.5, dtype=torch.float32)
          * torch.tensor(math.log2(math.e), dtype=torch.float32))

    def exponent(x, m):
        if log2:
            return torch.exp2((x.double() * float(c2) - m.double()).float())
        return torch.exp(x - m)

    if not log2:
        s = s * d ** -0.5
    s[..., L:] = -math.inf
    mx = torch.full(s.shape[:-1] + (1,), -math.inf)
    total = torch.zeros_like(mx)
    for c in range(chunks):
        part = s[..., c * kc:(c + 1) * kc]
        top = part.amax(-1, keepdim=True)
        m = torch.maximum(mx, top * c2 if log2 else top)
        total = total * (torch.exp2 if log2 else torch.exp)(mx - m) + exponent(
            part, m).sum(-1, keepdim=True)
        mx = m
    # the padded keys' p are exact zeros: P V over the L real keys, so the
    # CPU's float32 product has the plain version's shapes (a padded one
    # sums in another blocked order, which at 1000 tokens moves outputs
    # that cancel to ~1e-7 by a few bf16 ulps, order noise the kernel's
    # tensor-core sums have too and the ulp bound does not cover)
    p = (exponent(s, mx) * (1 / total)).to(cd).float()[..., :L, :L]
    v = v[..., :L, :]
    if cd == torch.float32:
        (ph, pl), (vh, vl) = split_tf32(p), split_tf32(v)
        o = pl @ vh + ph @ vl + ph @ vh
    else:
        o = p @ v
    o = o.to(cd)[..., :d].transpose(1, 2).reshape(B, L, C)
    return o, p.to(cd)


def _plain_probs(qkv, num_heads):
    """The plain version's probabilities (B, H, L, L) in qkv's dtype."""
    B, L, C3 = qkv.shape
    d = C3 // 3 // num_heads
    q, k, _ = qkv.float().view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return torch.softmax(q @ k.mT * d ** -0.5, dim=-1).to(qkv.dtype)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (x a float32 tensor of bf16 values)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


def _chain_qkv(L, d, seed, dtype):
    """qkv as the chain computes it: LN1(x) @ Wqkv + bqkv in ``dtype``."""
    C = HEADS * d
    r = np.random.RandomState(seed)
    w = torch.tensor(r.uniform(-1, 1, (3 * C, C)) / np.sqrt(C),
                     dtype=torch.float32)
    b = torch.tensor(r.uniform(-1, 1, (3 * C,)) / np.sqrt(C),
                     dtype=torch.float32)
    ln = (torch.tensor(1 + 0.1 * r.randn(C), dtype=torch.float32),
          torch.tensor(0.1 * r.randn(C), dtype=torch.float32))
    x = torch.tensor(r.randn(4, L, C), dtype=torch.float32).to(dtype)
    return linear_reference(x, w, b, ln)


@pytest.mark.parametrize("L", TOKENS + (243,))
def test_float32_three_tf32_products_within_bound(L):
    # d = 64 at 134 tokens: MixSTE's spatial blocks (cs 512, 134 joints)
    for d in HEAD_SIZES + ((64,) if L == 134 else ()):
        qkv = _chain_qkv(L, d, L * 100 + d, torch.float32)
        got, _ = _emulate(qkv, HEADS)
        err = (got - attention_core_reference(qkv, HEADS)).abs().max()
        assert err <= 1e-6, (L, d, float(err))


@pytest.mark.parametrize("L", TOKENS + (243,))
def test_bfloat16_arithmetic_within_one_ulp(L):
    for d in HEAD_SIZES:
        qkv = _chain_qkv(L, d, L * 100 + d, torch.bfloat16)
        got, p = _emulate(qkv, HEADS)
        want = attention_core_reference(qkv, HEADS).float()
        plain_p = _plain_probs(qkv, HEADS).float()
        dp = (p.float() - plain_p).abs()
        assert bool((dp <= _bf16_ulp(plain_p)).all()), (L, d)
        B, _, C3 = qkv.shape
        v = qkv.float().view(B, L, 3, HEADS, d)[:, :, 2].transpose(1, 2)
        carried = (dp @ v.abs()).transpose(1, 2).reshape(B, L, C3 // 3)
        bound = _bf16_ulp(want) + carried
        assert bool(((got.float() - want).abs() <= bound).all()), (L, d)


#: the shapes the streamed kernel takes on the main paths: MixSTE's 243
#: frames at d = 64 (the cs=512 model), 351 frames at d = 64 and 48, d = 128
#: (C = 1024) at 243 frames and at the 134 joints
STREAMED = [(243, 64), (351, 64), (351, 48), (243, 128), (134, 128)]


@pytest.mark.parametrize("L,d", STREAMED)
def test_streamed_arithmetic_within_bounds(L, d):
    """The streamed kernel's order (chunks of 64 keys, d padded to 64 or
    128) within the resident kernel's bounds, in both dtypes (the resident
    kernel's chunked path, which float32 still takes past 144 keys at d <=
    48, has the same chunks)."""
    for dtype in DTYPES:
        qkv = _chain_qkv(L, d, L * 100 + d, dtype)
        got, p = _emulate(qkv, HEADS, streamed=True)
        want = attention_core_reference(qkv, HEADS).float()
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-6, (L, d)
            continue
        plain_p = _plain_probs(qkv, HEADS).float()
        dp = (p.float() - plain_p).abs()
        assert bool((dp <= _bf16_ulp(plain_p)).all()), (L, d)
        B, _, C3 = qkv.shape
        v = qkv.float().view(B, L, 3, HEADS, d)[:, :, 2].transpose(1, 2)
        carried = (dp @ v.abs()).transpose(1, 2).reshape(B, L, C3 // 3)
        assert bool(((got.float() - want).abs()
                     <= _bf16_ulp(want) + carried).all()), (L, d)


@pytest.mark.parametrize("L,d", [(1000, 64), (1000, 48)])
def test_streamed_bf16_within_bounds_at_1000_tokens(L, d):
    """bf16 at 1000 tokens, the longest the card's tests stream: each
    probability within one bf16 ulp of the plain one, as above; each
    output within what the flipped probabilities carry plus one ulp of the
    larger of the two outputs.  Both outputs are rounded to bf16, so their
    rounding errors are half an ulp of each: the ulp of the plain output
    alone (the bound above) misses the case that appears at this length,
    an output that cancels to ~6e-8 in the plain version while the
    carried difference (~2.9e-6, the flips all pushing one way) lifts the
    kernel's into a binade 2^5 higher (one of 2,048,000 values at d =
    64)."""
    qkv = _chain_qkv(L, d, L * 100 + d, torch.bfloat16)
    got, p = _emulate(qkv, HEADS, streamed=True)
    want = attention_core_reference(qkv, HEADS).float()
    plain_p = _plain_probs(qkv, HEADS).float()
    dp = (p.float() - plain_p).abs()
    assert bool((dp <= _bf16_ulp(plain_p)).all())
    B, _, C3 = qkv.shape
    v = qkv.float().view(B, L, 3, HEADS, d)[:, :, 2].transpose(1, 2)
    carried = (dp @ v.abs()).transpose(1, 2).reshape(B, L, C3 // 3)
    ulp = torch.maximum(_bf16_ulp(want), _bf16_ulp(got.float()))
    assert bool(((got.float() - want).abs() <= ulp + carried).all())


def test_wrapper_rejects_a_bad_layout():
    with pytest.raises(ValueError):
        attention_core(torch.zeros(2, 5, 3 * 8 * 4 + 1), HEADS)
    with pytest.raises(ValueError):
        attention_core(torch.zeros(2, 3 * 8 * 4), HEADS)
