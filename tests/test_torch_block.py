"""Port block (pafuse_tpu_torch.ops.block) against the JAX package.

The same seeded inputs and weights go through the port's plain version
(``block_reference``, which ``fused_block`` uses for CPU tensors) and two
JAX references: the XLA path ``_layernorm(outer, _block(...))`` and the TPU
kernel ``_block_kernel`` itself, run by ``pl.pallas_call`` in interpret
mode.  Weights cross through ``checkpoints.params_from_jax``.

Tolerances: float32 2e-5 max abs (the bound of tests/test_mixste.py against
the torch reference; sums differ only in order).  bfloat16: 5e-3 + 2^-6*|y|
elementwise (two bf16 ulps): both sides round the output and five
intermediates to bfloat16, so a last-bit difference in an f32 sum flips a
bf16 ulp (up to 2^-7 of the value) and a flipped intermediate can carry one
more ulp into the output; a plain 5e-3 cannot hold where |y| > 0.64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pafuse_tpu.models import mixste
from pafuse_tpu.ops import attention
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.models.mixste import Block
from pafuse_tpu_torch.ops.block import block_reference, fused_block

torch.set_num_threads(2)

HEADS = 8
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 5e-3, 2.0 ** -6


def _jax_block(C, seed):
    """Random block params (LayerNorm affine included) + outer norm."""
    r = np.random.RandomState(seed)
    hid = 2 * C

    def lin(i, o):
        b = 1.0 / np.sqrt(i)
        return {"kernel": r.uniform(-b, b, (i, o)).astype(np.float32),
                "bias": r.uniform(-b, b, (o,)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * r.randn(C)).astype(np.float32),
                "bias": (0.1 * r.randn(C)).astype(np.float32)}

    p = {"norm1": ln(), "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C)},
         "norm2": ln(), "mlp": {"fc1": lin(C, hid), "fc2": lin(hid, C)}}
    return p, ln()


def _port_params(p, outer):
    C = p["norm1"]["scale"].shape[0]
    blk = Block(C, 2.0)
    blk.load_state_dict(checkpoints.params_from_jax(p), strict=True)
    return (tuple(t.detach() for t in blk.params()),
            (torch.from_numpy(outer["scale"]), torch.from_numpy(outer["bias"])))


def _xla_ref(p, outer, x, dtype):
    y = mixste._layernorm(outer, mixste._block(p, jnp.asarray(x, dtype),
                                               HEADS, dtype))
    return np.asarray(y.astype(jnp.float32))


def _kernel_ref(p, outer, x, dtype):
    """The TPU kernel body through pallas_call in interpret mode."""
    B, L, C = x.shape
    Lp = -(-L // 8) * 8
    args = [jnp.asarray(x, dtype)] + [
        jnp.asarray(a, jnp.float32)
        for a in attention._flatten_block_params(p, outer)]
    kernel = attention.functools.partial(
        attention._block_kernel, num_heads=HEADS, seq_len=L,
        head_dim=C // HEADS, pad_to=Lp)
    full = lambda a: pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)  # noqa: E731
    out = pl.pallas_call(
        kernel, grid=(1,), in_specs=[full(a) for a in args],
        out_specs=pl.BlockSpec((B, L, C), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, L, C), dtype), interpret=True,
    )(*args)
    return np.asarray(out.astype(jnp.float32))


CASES = [(3, L, C) for L in (24, 68, 42, 21, 27) for C in (32, 64)] + [
    (2, 68, 224)]


@pytest.mark.parametrize("B,L,C", CASES)
def test_block_reference_matches_jax_f32(B, L, C):
    p, outer = _jax_block(C, seed=L * 1000 + C)
    x = np.random.RandomState(L + C).randn(B, L, C).astype(np.float32)
    bp, on = _port_params(p, outer)
    got = block_reference(torch.from_numpy(x), bp, on, HEADS).numpy()
    np.testing.assert_allclose(got, _xla_ref(p, outer, x, jnp.float32),
                               rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got, _kernel_ref(p, outer, x, jnp.float32),
                               rtol=0, atol=F32_TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    launches = fused_block.launches
    np.testing.assert_array_equal(
        fused_block(torch.from_numpy(x), bp, on, HEADS).numpy(), got)
    assert fused_block.launches == launches


@pytest.mark.parametrize("L,C", [(24, 64), (68, 224)])
def test_block_reference_matches_tpu_kernel_bf16(L, C):
    p, outer = _jax_block(C, seed=7 + L)
    x = np.random.RandomState(L).randn(4, L, C).astype(np.float32)
    bp, on = _port_params(p, outer)
    got = block_reference(torch.from_numpy(x).bfloat16(), bp, on, HEADS)
    assert got.dtype == torch.bfloat16
    want = _kernel_ref(p, outer, x, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_fused_block_rejects_bad_input():
    p, outer = _jax_block(32, seed=0)
    bp, on = _port_params(p, outer)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block(torch.empty(2, 5, 32, device="meta"), bp, on, HEADS)

