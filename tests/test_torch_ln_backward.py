"""Port LayerNorm backward (pafuse_tpu_torch.ops.block_train.ln_backward)
against the JAX package.

Kernel #6 runs the LayerNorm backward three times a block (the TPU
kernel's ``_ln_bwd``, ``pafuse_tpu/ops/block_grad.py:55``, at its :166,
:188 and :237): the outer norm (g, then dm = m2 * dx2 for the MLP branch),
LN2 (the residual dx2 added, da = m1 * dx1) and LN1 (the residual dx1
added).  The port's plain version, ``ln_backward_reference`` (which the
wrapper runs for CPU tensors), takes the saved row statistics and those
three forms; here it is held against JAX's ``_ln_bwd`` on xhat and inv from
JAX's ``_ln_fwd``, on the same inputs made from a numpy seed, within
RTOL = 1e-5 x max|JAX| for each output (float32 sums over C columns and
over the rows in another order).

Then the CUDA kernels' order, which the card alone runs: the rows rule
``ln_backward_rows`` (each row in one CTA, in order; one wave of the card;
a function of (M, C) alone), and the kernels' fixed summation order emulated
in float32 (the row sums as 32 lanes' sums of their 4-column chunks added
by the warp's butterfly; the column sums per warp over its rows, per CTA
over its warps, then LN_SUM_SPLIT strided sums added in order) against
float64 sums within RTOL.  The card's own checks (kernel against plain in
float32 and bfloat16, repeats bit for bit, the library's rows rule) are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from pafuse_tpu.ops import block_grad
from pafuse_tpu_torch.ops import block_train as bt
from pafuse_tpu_torch.ops.block_train import (LN_BWD_WARPS, LN_SUM_SPLIT,
                                              ln_backward,
                                              ln_backward_reference,
                                              ln_backward_rows)

torch.set_num_threads(2)

RTOL = 1e-5
KEEP = 0.9
#: (M, C) of every main-path call: H3WB's parts, 3DHP's and the monolithic
#: model's 288 (spatial 999 x 17 and 999 x 134 rows), MixSTE's 512
MAIN_PATH = ((999 * 24, 384), (999 * 68, 224), (999 * 42, 256),
             (999 * 17, 288), (999 * 134, 288), (4 * 243 * 134, 512))
FORMS = ("outer", "ln2", "ln1")


def _inputs(M, C, L, seed):
    """g, x, the residual, the scale and a mask of M // L sequences mixing
    0, 1/keep and 1, float32 numpy."""
    r = np.random.RandomState(seed)
    g, x, res = (r.randn(M, C).astype(np.float32) for _ in range(3))
    x = 2.0 * x + 0.5
    scale = (1 + 0.1 * r.randn(C)).astype(np.float32)
    mask = np.array([0.0, 1 / KEEP, 1.0], np.float32)[np.arange(M // L) % 3]
    return g, x, res, scale, mask


def _form(form, res, mask):
    """The keyword arguments of ``form``: outer (mask), LN2 (residual and
    mask), LN1 (residual)."""
    return {"outer": {"mask": mask}, "ln2": {"residual": res, "mask": mask},
            "ln1": {"residual": res}}[form]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax(g, x, scale, residual=None, mask=None, seq_len=1):
    """JAX's _ln_bwd on _ln_fwd's xhat and inv, plus the residual and the
    masked copy: (dx, dxm or None, dscale, dbias) and the row statistics
    (mean, inv) as _ln_fwd computes them."""
    xj = jnp.asarray(x)
    _, xhat, inv = block_grad._ln_fwd(xj, jnp.asarray(scale),
                                      jnp.zeros_like(jnp.asarray(scale)))
    mean = jnp.mean(xj, axis=-1)
    dx, ds, db = block_grad._ln_bwd(jnp.asarray(g), xhat, inv,
                                    jnp.asarray(scale))
    if residual is not None:
        dx = jnp.asarray(residual) + dx
    dxm = (None if mask is None
           else jnp.repeat(jnp.asarray(mask), seq_len)[:, None] * dx)
    return ((dx, dxm, ds, db), np.asarray(mean), np.asarray(inv)[:, 0])


@pytest.mark.parametrize("C", [24, 32, 40])
@pytest.mark.parametrize("form", FORMS)
def test_ln_backward_reference_matches_jax(form, C):
    """The plain version against JAX's ``_ln_bwd`` in each form, at M =
    1001 rows (not a multiple of the 3 rows a CTA that the rule gives at
    these widths) of 7-row sequences: dx, dxm, dscale and dbias within
    RTOL x max|JAX|."""
    M, L = 1001, 7
    assert M % ln_backward_rows(M, C)
    g, x, res, scale, mask = _inputs(M, C, L, seed=C + len(form))
    kw = _form(form, res, mask)
    want, mean, inv = _jax(g, x, scale, seq_len=L, **kw)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = ln_backward_reference(torch.from_numpy(g), torch.from_numpy(x),
                                torch.tensor(mean), torch.tensor(inv),
                                torch.from_numpy(scale), seq_len=L, **tkw)
    assert (got[1] is None) == (form == "ln1")
    for name, a, b in zip(("dx", "dxm", "dscale", "dbias"), got, want):
        if b is not None:
            assert a.dtype == torch.float32 and a.shape == b.shape, name
            assert _rel(a.numpy(), b) <= RTOL, (name, _rel(a.numpy(), b))


@settings(max_examples=200, deadline=None)
@given(M=st.integers(1, 2_000_000), C=st.integers(1, 128).map(lambda k: 8 * k))
def test_ln_backward_rows_cover_each_row_once(M, C):
    """The rows rule: CTAs of ln_backward_rows(M, C) consecutive rows, the
    last taking what is left, cover the M rows once and in order, make one
    wave (at most 132 SMs x the CTAs of the width class an SM holds: 3 up
    to 256 columns, 2 up to 512, 1 beyond) and depend on (M, C) alone."""
    rows = ln_backward_rows(M, C)
    parts = -(-M // rows)
    ctas = 3 if C <= 256 else 2 if C <= 512 else 1
    assert rows >= 1 and parts <= 132 * ctas
    assert (parts - 1) * rows < M <= parts * rows
    assert rows == ln_backward_rows(M, C) == -(-M // (132 * ctas))


@pytest.mark.parametrize("M,C", MAIN_PATH)
def test_ln_backward_rows_fill_the_card_at_main_path_shapes(M, C):
    """At every main-path shape the grid is one wave of at least 90% of
    the CTAs the card holds and at most 396 partials, and no CTA takes more
    than one row beyond an even share of the rows."""
    rows = ln_backward_rows(M, C)
    parts = -(-M // rows)
    slots = 132 * (3 if C <= 256 else 2 if C <= 512 else 1)
    assert 0.9 * slots <= parts <= slots <= 396
    assert rows < M / slots + 1


def _lane_sums(v):
    """The row sums of v (M, C) float32 as the kernel takes them: lane l
    adds its chunks c4 = l, l + 32, ... (4 columns each, in column order),
    then the warp's butterfly (xor 16, 8, 4, 2, 1) adds the 32 lanes."""
    M, C = v.shape
    chunks = C // 4
    lanes = np.zeros((M, 32), np.float32)
    for q in range(-(-chunks // 32)):
        for lane in range(32):
            c4 = lane + 32 * q
            if c4 < chunks:
                for e in range(4):
                    lanes[:, lane] += v[:, 4 * c4 + e]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    assert np.all(lanes == lanes[:, :1])       # every lane holds the sum
    return lanes[:, 0]


def _column_sums(v, rows):
    """The column sums of v (M, C) float32 in the kernels' order: CTA p
    takes rows [p rows, (p + 1) rows), warp w its rows p rows + w, + 8,
    ... in order, the CTA its warps in order; then ln_sums_kernel adds the
    partials s, s + LN_SUM_SPLIT, ... for each s, and the LN_SUM_SPLIT
    sums in s order."""
    M, C = v.shape
    parts = -(-M // rows)
    partial = np.zeros((parts, C), np.float32)
    for p in range(parts):
        block = v[p * rows:min(M, (p + 1) * rows)]
        for w in range(LN_BWD_WARPS):
            acc = np.zeros(C, np.float32)
            for row in block[w::LN_BWD_WARPS]:
                acc += row
            partial[p] += acc
    sub = np.zeros((LN_SUM_SPLIT, C), np.float32)
    for s in range(LN_SUM_SPLIT):
        for row in partial[s::LN_SUM_SPLIT]:
            sub[s] += row
    total = np.zeros(C, np.float32)
    for row in sub:
        total += row
    return total


@pytest.mark.parametrize("M,C,form", [(5000, 40, "outer"), (3001, 224, "ln2"),
                                      (2381, 384, "ln1")])
def test_ln_backward_order_emulated_in_float32(M, C, form):
    """The kernels' arithmetic in float32 in their order (_lane_sums for
    the two row means, _column_sums for dscale and dbias over
    ln_backward_rows(M, C) rows a CTA) against float64 sums of the same
    float32 terms, and its dx against the plain version: within RTOL x
    max|float64| for dx, dscale and dbias."""
    L = 1 if form == "ln1" else 7
    M -= M % L
    g, x, res, scale, mask = _inputs(M, C, L, seed=M + C)
    mean = x.mean(1, dtype=np.float64).astype(np.float32)
    inv = (1 / np.sqrt(x.astype(np.float64).var(1) + 1e-6)).astype(np.float32)
    xhat = (x - mean[:, None]) * inv[:, None]
    gs = g * scale
    s1 = _lane_sums(gs) / np.float32(C)
    s2 = _lane_sums(gs * xhat) / np.float32(C)
    dx = inv[:, None] * (gs - s1[:, None] - xhat * s2[:, None])
    if form != "outer":
        dx = dx + res
    rows = ln_backward_rows(M, C)
    ds = _column_sums(g * xhat, rows)
    db = _column_sums(g, rows)
    want = ln_backward_reference(
        *(torch.from_numpy(a) for a in (g, x, mean, inv, scale)),
        seq_len=L, **{k: torch.from_numpy(v)
                      for k, v in _form(form, res, mask).items()})
    g64, xh64 = g.astype(np.float64), xhat.astype(np.float64)
    assert _rel(ds, (g64 * xh64).sum(0)) <= RTOL
    assert _rel(db, g64.sum(0)) <= RTOL
    assert _rel(dx, want[0].numpy()) <= RTOL
    assert _rel(ds, want[2].numpy()) <= RTOL
    assert _rel(db, want[3].numpy()) <= RTOL


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_backward_on_cpu_is_the_plain_version(form, dtype):
    """For CPU tensors the wrapper returns the plain version's results,
    bit for bit, dx in x's dtype (dxm, dscale, dbias float32), and counts no
    launch."""
    M, C, L = 96, 32, 12
    g, x, res, scale, mask = _inputs(M, C, L, seed=3)
    xt = torch.from_numpy(x).to(dtype)
    gt = torch.from_numpy(g).to(dtype)
    mean, rstd = xt.float().mean(1), torch.rsqrt(xt.float().var(1, unbiased=False)
                                                 + 1e-6)
    kw = {k: torch.from_numpy(v) for k, v in _form(form, res, mask).items()}
    launches = ln_backward.launches
    got = ln_backward(gt, xt, mean, rstd, torch.from_numpy(scale),
                      seq_len=L, **kw)
    want = ln_backward_reference(gt, xt, mean, rstd, torch.from_numpy(scale),
                                 seq_len=L, **kw)
    assert ln_backward.launches == launches
    assert got[0].dtype == dtype
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("C", [20, 36, 1032])
def test_ln_backward_raises_on_a_width_the_kernel_does_not_take(C):
    """C not a multiple of 8, or above 1024, raises ValueError before any
    launch, on either device."""
    g, x, _, scale, _ = _inputs(16, C, 1, seed=1)
    t = [torch.from_numpy(a) for a in (g, x)]
    launches = ln_backward.launches
    with pytest.raises(ValueError, match="multiple of 8 up to 1024"):
        ln_backward(*t, t[1].mean(1), t[1].std(1), torch.from_numpy(scale))
    assert ln_backward.launches == launches


def test_block_train_backward_uses_the_same_layernorm_backward():
    """train_bwd_reference's outer-norm parameter gradients are
    ln_backward's plain version on the same xhat (given as x with mean 0
    and rstd 1) and g: dscale and dbias as the block's own backward
    returns them."""
    B, L, C = 6, 5, 32
    r = np.random.RandomState(0)
    shapes = ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,), (C,), (C,),
              (2 * C, C), (2 * C,), (C, 2 * C), (C,), (C,), (C,))
    params = [torch.from_numpy(r.randn(*s).astype(np.float32) * 0.1)
              for s in shapes]
    params[12] = params[12] + 1
    x = torch.from_numpy(r.randn(B, L, C).astype(np.float32))
    g = torch.from_numpy(r.randn(B, L, C).astype(np.float32))
    m = torch.ones(B)
    _, grads = bt.train_bwd_reference(x, g, m, m, params, 8)
    _, saved = bt._fwd_core(x, m.reshape(-1, 1, 1), m.reshape(-1, 1, 1),
                            params, 8)
    xhato = saved[10].reshape(-1, C)
    got = ln_backward_reference(g.reshape(-1, C), xhato, torch.zeros(B * L),
                                torch.ones(B * L), params[12])
    assert torch.equal(got[2], grads[12]) and torch.equal(got[3], grads[13])
