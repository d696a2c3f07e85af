"""The block chain's GEMM stage (pafuse_tpu_torch.ops.gemm) on the CPU.

``linear_reference`` (the plain version that ``fused_linear`` uses for CPU
tensors and that ``block_reference`` runs four times a block) against the
matching pieces of the TPU kernel body ``pafuse_tpu/ops/attention.py::
_block_body``: ``dot2d`` after ``ln`` (the QKV and fc1 stages, fc1 with the
``_erf_as`` GELU) and the residual adds of proj and fc2, run eagerly op by
op so that XLA rounds to bfloat16 where the kernel does.  Bounds: float32
2e-6 max abs (the same float32 arithmetic; sums of up to 768 products in
another order differ by a few ulps, 2.4e-7 at |y| in [2, 4); the
kernel's erf approximation is within 1.5e-7); bfloat16 one ulp of the
output, 2^-7 |y| + 1e-6 elementwise (both sides round float32 values that
differ by ~1e-7).

Then the numerics decision of the kernel's bfloat16 path: one float32
accumulator over the whole K (the tensor cores' accumulation modelled as
truncating after every 16-deep step), at every part shape and forward
stage, stays within the card's bfloat16 block bound of
``linear_reference``, and the LayerNorm pre-pass's plain version
(``layernorm_round``) is ``linear_reference``'s prologue bit for bit.

Then the numerics decision of the kernel's float32 path, on the same
blocks: ``split_tf32`` halves are TF32 values that sum back to x, and a
block whose products are three TF32 products each stays within 1e-5 of the
float32 block, while one TF32 product per product misses the kernel's 1e-4
bound.  The same decision for the training forward's GEMM (kernel #5,
``ops.block_train.fwd_linear``) at the part shapes: its four products in
the kernel's order (three TF32 products per pair of 32-deep K slices, the
pairs' partial sums added in float32) stay within 1e-5 of
``fwd_linear_reference`` in float32, one TF32 product does not.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax import lax

from pafuse_tpu.ops import attention
from pafuse_tpu_torch.ops import gemm
from pafuse_tpu_torch.ops.block import block_reference
from pafuse_tpu_torch.ops.block_train import fwd_linear_reference
from pafuse_tpu_torch.ops.gemm import (fused_linear, layernorm_round,
                                       linear_reference, split_tf32)

torch.set_num_threads(2)

HEADS = 8


def _jax_ln(x, s, b):
    # _block_body's ln (attention.py:267-270)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * lax.rsqrt(var + 1e-6) * s + b


def _jax_dot(a, w_in_out, b, cd):
    # _block_body's dot2d (attention.py:272-278), weights (in, out)
    return lax.dot_general(a, w_in_out.astype(cd), (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.float32) + b


def _jax_stage(stage, a, w, b, ln, res, cd):
    """One stage as _block_body computes it; w in torch (out, in) layout."""
    a = jnp.asarray(a, cd)
    wj, bj = jnp.asarray(w.T), jnp.asarray(b)
    if ln is not None:
        a = _jax_ln(a.astype(jnp.float32), *map(jnp.asarray, ln)).astype(cd)
    y = _jax_dot(a, wj, bj, cd)
    if stage == "gelu":           # attention.py:374-376
        y = 0.5 * y * (1.0 + attention._erf_as(y * 0.7071067811865476))
    if stage == "residual":       # attention.py:370-371 and 377-381
        return np.asarray((jnp.asarray(res, cd) + y.astype(cd)).astype(jnp.float32))
    return np.asarray(y.astype(cd).astype(jnp.float32))


def _stage_inputs(stage, C, seed):
    """A (M, K), W (N, K), b, LayerNorm (scale, bias) or None, R (M, N) or
    None for the QKV ("store"), fc1 ("gelu") and fc2 ("residual") stages."""
    r = np.random.RandomState(seed)
    N, K, ln = {"store": (3 * C, C, True), "gelu": (2 * C, C, True),
                "residual": (C, 2 * C, False)}[stage]
    M = 37
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    w = (r.uniform(-1, 1, (N, K)) / np.sqrt(K)).astype(np.float32)
    b = (r.uniform(-1, 1, N) / np.sqrt(K)).astype(np.float32)
    norm = ((1 + 0.1 * f(K)), 0.1 * f(K)) if ln else None
    res = f(M, N) if stage == "residual" else None
    return f(M, K), w, b, norm, res


def _port_stage(stage, a, w, b, ln, res, dtype):
    t = torch.from_numpy
    return linear_reference(
        t(a).to(dtype), t(w), t(b), None if ln is None else tuple(map(t, ln)),
        stage, None if res is None else t(res).to(dtype))


@pytest.mark.parametrize("stage", ["store", "gelu", "residual"])
@pytest.mark.parametrize("C", [64, 224, 384])
def test_linear_reference_matches_jax_block_body_f32(stage, C):
    a, w, b, ln, res = _stage_inputs(stage, C, seed=C)
    got = _port_stage(stage, a, w, b, ln, res, torch.float32).numpy()
    want = _jax_stage(stage, a, w, b, ln, res, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("stage", ["store", "gelu", "residual"])
@pytest.mark.parametrize("C", [64, 256])
def test_linear_reference_matches_jax_block_body_bf16(stage, C):
    a, w, b, ln, res = _stage_inputs(stage, C, seed=C + 1)
    got = _port_stage(stage, a, w, b, ln, res, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax_stage(stage, a, w, b, ln, res, jnp.bfloat16)
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= 2.0 ** -7 * np.abs(want) + 1e-6), diff.max()


def test_fused_linear_on_cpu_is_the_plain_version():
    a, w, b, ln, res = _stage_inputs("gelu", 32, seed=4)
    t = torch.from_numpy
    launches = fused_linear.launches
    got = fused_linear(t(a), t(w), t(b), tuple(map(t, ln)), "gelu")
    assert fused_linear.launches == launches
    np.testing.assert_array_equal(
        got.numpy(), _port_stage("gelu", a, w, b, ln, res, torch.float32).numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        fused_linear(t(a).to("meta"), t(w), t(b))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_split_tf32_halves_are_tf32_and_sum_to_x(scale):
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32)
                         * scale)
    hi, lo = split_tf32(x)
    for half in (hi, lo):         # 10 explicit mantissa bits: 13 low bits 0
        assert torch.all(half.view(torch.int32) & 0x1FFF == 0)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert rel.max() <= 2.0 ** -21
    # hi is x rounded to nearest: within half a TF32 ulp (2^-11 relative)
    assert ((hi - x).abs() / x.abs()).max() <= 2.0 ** -11


@pytest.mark.parametrize("C", [384, 224, 256])
def test_transposed_weight_split_sums_to_the_transpose(C):
    """The data gradients' operands: each backward weight W (fc2 (C, 2C),
    fc1 (2C, C), proj (C, C), qkv (3C, C)) split transposed, hi and lo (N, K)
    = W^T's TF32 halves, sum back to W^T within 2^-21 relative."""
    r = np.random.RandomState(C)
    for rows, cols in ((C, 2 * C), (2 * C, C), (C, C), (3 * C, C)):
        w = torch.from_numpy((r.uniform(-1, 1, (rows, cols))
                              / np.sqrt(cols)).astype(np.float32))
        hi, lo = split_tf32(w.t())
        assert hi.shape == lo.shape == (cols, rows) and hi.is_contiguous()
        for half in (hi, lo):
            assert torch.all(half.view(torch.int32) & 0x1FFF == 0)
        err = (hi.double() + lo.double() - w.t().double()).abs()
        assert torch.all(err <= 2.0 ** -21 * w.t().double().abs())


def _block(L, C, seed, B=16):
    """16 sequences of random block params (U(+-1/sqrt(in)) weights,
    LayerNorm affines near (1, 0)) and inputs."""
    r = np.random.RandomState(seed)
    hid = 2 * C

    def u(shape, fan_in):
        return r.uniform(-1, 1, shape) / np.sqrt(fan_in)

    def ln():
        return [1 + 0.1 * r.randn(C), 0.1 * r.randn(C)]

    arrays = (ln() + [u((3 * C, C), C), u((3 * C,), C), u((C, C), C),
                      u((C,), C)] + ln()
              + [u((hid, C), C), u((hid,), C), u((C, hid), hid),
                 u((C,), hid)] + ln())
    p = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    x = torch.tensor(r.randn(B, L, C), dtype=torch.float32)
    return x, p[:12], p[12:]


def _tf32_products(products):
    """``F.linear`` in float32 as one (a_hi*w_hi) or three (+ a_hi*w_lo +
    a_lo*w_hi) products of TF32 values, each exact in float32, summed in
    float32: the arithmetic of the kernel's float32 path, whose tensor
    cores sum in float32 as well."""
    def linear(a, w, b=None):
        a_hi, a_lo = split_tf32(a)
        w_hi, w_lo = split_tf32(w)
        y = F.linear(a_hi, w_hi)
        if products == 3:
            y = F.linear(a_lo, w_hi) + F.linear(a_hi, w_lo) + y
        return y + b
    return types.SimpleNamespace(linear=linear, gelu=F.gelu)


def _emulated_block(monkeypatch, products, x, bp, on):
    """block_reference with every product of linear_reference replaced by
    TF32 products."""
    with monkeypatch.context() as m:
        m.setattr(gemm, "F", _tf32_products(products))
        return block_reference(x, bp, on, HEADS)


# the (L, C) of the parts' spatial blocks (body 24 joints, face 68, merged
# hands 42) and of a temporal block (27 frames)
PART_SHAPES = [(24, 384), (68, 224), (42, 256), (27, 384)]


@pytest.mark.parametrize("L,C", PART_SHAPES)
def test_three_tf32_products_keep_float32_accuracy(monkeypatch, L, C):
    x, bp, on = _block(L, C, seed=L + C)
    f32 = block_reference(x, bp, on, HEADS)
    three = _emulated_block(monkeypatch, 3, x, bp, on)
    assert (three - f32).abs().max() <= 1e-5


@pytest.mark.parametrize("L,C", PART_SHAPES)
def test_one_tf32_product_misses_the_kernel_bound(monkeypatch, L, C):
    x, bp, on = _block(L, C, seed=L + C)
    f32 = block_reference(x, bp, on, HEADS)
    one = _emulated_block(monkeypatch, 1, x, bp, on)
    assert (one - f32).abs().max() > 1e-4


def _pairwise_tf32(a, w, products):
    """a @ w^T as kernel #5's GEMM sums it: per pair of 32-deep K slices
    one (a_hi*w_hi) or three (+ a_hi*w_lo + a_lo*w_hi) TF32 products, the
    pairs' partial sums added in float32 in K order."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], 64):
        k = slice(k0, k0 + 64)
        part = a_hi[:, k] @ w_hi[:, k].t()
        if products == 3:
            part = (a_lo[:, k] @ w_hi[:, k].t() + a_hi[:, k] @ w_lo[:, k].t()
                    + part)
        acc = acc + part
    return acc


@pytest.mark.parametrize("L,C", PART_SHAPES)
def test_forward_gemm_order_keeps_float32_accuracy(L, C):
    """Each forward product of a block (qkv on LN1(x), proj, fc1, fc2 on
    GELU outputs) at the part's width: three TF32 products within 1e-5
    max abs of float32 for every epilogue, one TF32 product beyond it."""
    x, bp, _ = _block(L, C, seed=L + C + 1)
    B = x.shape[0]
    rows = x.reshape(-1, C)
    r = np.random.RandomState(C)
    mask = torch.tensor(np.array([0.0, 1 / 0.9, 1.0])[np.arange(B) % 3],
                        dtype=torch.float32)
    hidden = F.gelu(torch.tensor(r.randn(B * L, 2 * C), dtype=torch.float32))
    stages = [(gemm._layernorm(rows, bp[0], bp[1]), bp[2], bp[3], "store"),
              (torch.tensor(r.randn(B * L, C), dtype=torch.float32), bp[4],
               bp[5], "residual"),
              (gemm._layernorm(rows, bp[6], bp[7]), bp[8], bp[9], "gelu"),
              (hidden, bp[10], bp[11], "residual")]
    for a, w, b, epilogue in stages:
        want = fwd_linear_reference(a, w, b, epilogue, rows, mask, L)
        for products, ok in ((3, True), (1, False)):
            y = _pairwise_tf32(a, w, products) + b
            if epilogue == "residual":
                y = rows + mask.repeat_interleave(L)[:, None] * y
            pairs = (zip((y, F.gelu(y)), want) if epilogue == "gelu"
                     else [(y, want)])
            err = max(float((g - v).abs().max()) for g, v in pairs)
            assert (err <= 1e-5) == ok, (epilogue, products, err)


# chip_smoke.KERNEL_TOL_BF16: the card's bound of a bfloat16 block kernel
# (and of the bfloat16 GEMM alone) against its plain version, (max, mean)
KERNEL_TOL_BF16 = (2.0 ** -4, 1e-3)


def _bf16_stage(L, C, stage):
    """One forward product of a bfloat16 block at the part's width: A (the
    rounded LayerNorm for qkv and fc1, else bfloat16 activations), W, b,
    the LayerNorm (scale, bias) or None, the epilogue and R (or None), with
    ``a_raw`` the rows the LayerNorm reads."""
    x, bp, _ = _block(L, C, seed=L + C + 2)
    rows = x.reshape(-1, C).to(torch.bfloat16)
    r = np.random.RandomState(C + L)
    bf = lambda *s: torch.tensor(r.randn(*s), dtype=torch.float32).to(torch.bfloat16)  # noqa: E731
    if stage == "qkv":
        return rows, bp[2], bp[3], (bp[0], bp[1]), "store", None
    if stage == "proj":
        return bf(rows.shape[0], C), bp[4], bp[5], None, "residual", rows
    if stage == "fc1":
        return rows, bp[8], bp[9], (bp[6], bp[7]), "gelu", None
    hidden = F.gelu(bf(rows.shape[0], 2 * C).float()).to(torch.bfloat16)
    return hidden, bp[10], bp[11], None, "residual", rows


def _truncate_f32(v):
    """float64 ``v`` to float32 rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _one_accumulator(a, w):
    """a @ w^T for bfloat16 a and w as the bfloat16 kernel sums it: one
    float32 accumulator over the whole K in K order, each 16-deep step's
    exact sum added and the result truncated to float32."""
    a64, w64 = a.double(), w.double()
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], 16):
        k = slice(k0, k0 + 16)
        acc = _truncate_f32(acc.double() + a64[:, k] @ w64[:, k].t())
    return acc


@pytest.mark.parametrize("stage", ["qkv", "proj", "fc1", "fc2"])
@pytest.mark.parametrize("L,C", PART_SHAPES)
def test_bf16_one_accumulator_stays_within_kernel_bound(L, C, stage):
    """The bfloat16 GEMM's order (no partial sums: one float32 accumulator
    over K = C or 2C) at each stage's epilogue (store, residual, GELU,
    residual) against linear_reference, within KERNEL_TOL_BF16."""
    a, w, b, ln, epilogue, res = _bf16_stage(L, C, stage)
    want = linear_reference(a, w, b, ln, epilogue, res)
    if ln is not None:
        a = layernorm_round(a, *ln)
    y = _one_accumulator(a, w.to(torch.bfloat16)) + b
    if epilogue == "gelu":
        got = F.gelu(y).to(torch.bfloat16)
    elif epilogue == "residual":
        got = res + y.to(torch.bfloat16)
    else:
        got = y.to(torch.bfloat16)
    diff = (got.float() - want.float()).abs()
    assert diff.max() <= KERNEL_TOL_BF16[0] and diff.mean() <= KERNEL_TOL_BF16[1], (
        float(diff.max()), float(diff.mean()))


@pytest.mark.parametrize("stage", ["qkv", "fc1"])
@pytest.mark.parametrize("L,C", PART_SHAPES)
def test_bf16_layernorm_prepass_is_the_reference_prologue(L, C, stage):
    """The pre-pass's plain version is _layernorm then the rounding to
    bfloat16, bit for bit, and the GEMM on its output is linear_reference
    with the LayerNorm, bit for bit."""
    a, w, b, ln, epilogue, _ = _bf16_stage(L, C, stage)
    h = layernorm_round(a, *ln)
    assert h.dtype == torch.bfloat16
    assert torch.equal(h, gemm._layernorm(a, *ln).to(torch.bfloat16))
    assert torch.equal(linear_reference(h, w, b, None, epilogue),
                       linear_reference(a, w, b, ln, epilogue))
