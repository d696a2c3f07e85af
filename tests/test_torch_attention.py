"""Port attention (pafuse_tpu_torch.ops.attention) against the JAX package.

The same seeded inputs and weights go through the port's plain version
(``attention_reference``, which ``fused_attention`` uses for CPU tensors)
and two JAX references: the TPU kernel ``_attention_kernel`` itself, run by
``pl.pallas_call`` in interpret mode as ``pallas_attention`` calls it (L
padded to a multiple of 8 with the padded keys masked, two batch tiles),
and the XLA path ``mixste._attention``.  Weights cross through
``checkpoints.params_from_jax``.

Tolerances: float32 2e-5 max abs (float32 arithmetic on both sides, sums in
another order; the bound of tests/test_torch_block.py).  bfloat16 x:
|diff| <= 2^-7 |y| + 1e-4 elementwise, one bfloat16 ulp of the output plus
the float32 bound: both sides compute in float32 and round only the output,
so a value near a rounding boundary may round the other way.

Then the numerics of the CUDA kernel's GEMMs, emulated: every product as
TF32 products of the split_tf32 halves (a bfloat16 x is exact in TF32, so
its QKV product is two products, x*w_hi + x*w_lo; the attention output's
projection three), within the kernel's bounds on the card (chip_smoke.py:
float32 1e-5 max abs, bfloat16 x 2^-7 |y| + 1e-5) of the plain version.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pafuse_tpu.models import mixste
from pafuse_tpu.ops import attention
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.ops import attention as port_attention
from pafuse_tpu_torch.ops.attention import attention_reference, fused_attention
from pafuse_tpu_torch.ops.gemm import split_tf32

torch.set_num_threads(2)

HEADS = 8
F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
TILE = 2            # sequences per batch tile; the tests use two tiles

#: (L, C) of every block of the part-based model: each part's spatial and
#: temporal shape (body 24 joints at 384, face 68 at 224, merged hands 42
#: at 256, one unmerged hand 21 at 256; 27 frames), plus a narrow one
SHAPES = [(24, 384), (27, 384), (68, 224), (27, 224), (42, 256), (27, 256),
          (21, 256), (9, 32)]


def _jax_params(C, seed):
    r = np.random.RandomState(seed)

    def lin(i, o):
        b = 1.0 / np.sqrt(i)
        return {"kernel": r.uniform(-b, b, (i, o)).astype(np.float32),
                "bias": r.uniform(-b, b, (o,)).astype(np.float32)}

    return {"qkv": lin(C, 3 * C), "proj": lin(C, C)}


def _port_params(p):
    sd = checkpoints.params_from_jax(p)
    return tuple(sd[k] for k in ("qkv.weight", "qkv.bias", "proj.weight",
                                 "proj.bias"))


def _kernel_ref(p, x, dtype):
    """``_attention_kernel`` through pallas_call in interpret mode, on the
    operands ``pallas_attention`` builds: L padded to Lp, tiles of TILE."""
    B, L, C = x.shape
    Lp = -(-L // 8) * 8
    xf = np.zeros((B, Lp, C), np.float32)
    xf[:, :L] = x
    args = [jnp.asarray(xf, dtype)] + [
        jnp.asarray(p[n][k], jnp.float32)
        for n in ("qkv", "proj") for k in ("kernel", "bias")]
    kernel = attention.functools.partial(
        attention._attention_kernel, num_heads=HEADS, seq_len=L,
        head_dim=C // HEADS)
    full = lambda a: pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)  # noqa: E731
    out = pl.pallas_call(
        kernel, grid=(B // TILE,),
        in_specs=[pl.BlockSpec((TILE, Lp, C), lambda i: (i, 0, 0))]
        + [full(a) for a in args[1:]],
        out_specs=pl.BlockSpec((TILE, Lp, C), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, Lp, C), dtype), interpret=True,
    )(*args)
    return np.asarray(out[:, :L].astype(jnp.float32))


def _inputs(L, C):
    p = _jax_params(C, seed=L * 1000 + C)
    x = np.random.RandomState(L + C).randn(2 * TILE, L, C).astype(np.float32)
    return p, x


@pytest.mark.parametrize("L,C", SHAPES)
def test_attention_reference_matches_jax_f32(L, C):
    p, x = _inputs(L, C)
    params = _port_params(p)
    got = attention_reference(torch.from_numpy(x), *params, HEADS).numpy()
    np.testing.assert_allclose(got, _kernel_ref(p, x, jnp.float32),
                               rtol=0, atol=F32_TOL)
    xla = np.asarray(mixste._attention(p, jnp.asarray(x), HEADS, jnp.float32))
    np.testing.assert_allclose(got, xla, rtol=0, atol=F32_TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    launches = fused_attention.launches
    np.testing.assert_array_equal(
        fused_attention(torch.from_numpy(x), *params, HEADS).numpy(), got)
    assert fused_attention.launches == launches


@pytest.mark.parametrize("L,C", [(24, 384), (68, 224), (27, 256)])
def test_attention_reference_matches_tpu_kernel_bf16(L, C):
    p, x = _inputs(L, C)
    got = attention_reference(torch.from_numpy(x).bfloat16(), *_port_params(p),
                              HEADS)
    assert got.dtype == torch.bfloat16
    want = _kernel_ref(p, x, jnp.bfloat16)
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= BF16_RTOL * np.abs(want) + BF16_ATOL), diff.max()


def test_attention_reference_keeps_leading_dims():
    p, x = _inputs(9, 32)
    params = _port_params(p)
    x4 = torch.from_numpy(x).reshape(2, TILE, 9, 32)
    got = attention_reference(x4, *params, HEADS)
    assert got.shape == (2, TILE, 9, 32)
    torch.testing.assert_close(
        got.reshape(-1, 9, 32),
        attention_reference(torch.from_numpy(x), *params, HEADS),
        rtol=0, atol=0)


def test_fused_attention_rejects_other_devices():
    p, _ = _inputs(9, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_attention(torch.empty(2, 9, 32, device="meta"),
                        *_port_params(p), HEADS)


def _tf32_linear(a, w, b):
    """F.linear as the kernel's GEMM computes it: a_lo*w_hi + a_hi*w_lo +
    a_hi*w_hi on the TF32 halves (each product exact in float32), summed in
    float32; a_lo*w_hi is zero where a is exact in TF32."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    return (F.linear(a_lo, w_hi) + F.linear(a_hi, w_lo)
            + F.linear(a_hi, w_hi) + b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,C", [(24, 384), (68, 224), (42, 256)])
def test_tf32_products_keep_the_kernel_bounds(monkeypatch, dtype, L, C):
    """At each part's spatial shape: bfloat16 x -> two TF32 products for
    QKV (its low halves are 0), three for the projection; float32 x ->
    three for both."""
    p, x = _inputs(L, C)
    params = _port_params(p)
    xt = torch.from_numpy(x).to(dtype)
    if dtype == torch.bfloat16:
        assert torch.count_nonzero(split_tf32(xt.float())[1]) == 0
    want = attention_reference(xt, *params, HEADS).float()
    with monkeypatch.context() as m:
        m.setattr(port_attention, "F",
                  types.SimpleNamespace(linear=_tf32_linear))
        got = attention_reference(xt, *params, HEADS).float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-5
    else:
        assert torch.all(diff <= 2.0 ** -7 * want.abs() + 1e-5)
