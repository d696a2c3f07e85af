"""Port layer (pafuse_tpu_torch.ops.layer) against the JAX package.

The same seeded inputs and weights go through the port's plain version
(``layer_reference``, which ``fused_layer`` uses for CPU tensors) and two
JAX references: the TPU kernel ``_layer_kernel`` run by the JAX wrapper
``pallas_layer`` with its own block specs (one (1, F, N, C) tile per sample,
the spatial body unpadded) through ``pl.pallas_call`` in interpret mode, and
the XLA composition (spatial ``_block`` + Spatial_norm, ``+ tpe``, swapaxes,
temporal ``_block`` + Temporal_norm, swapaxes).  With the temporal position
embedding (layer 0) and without, at the merged-hands joint count 42, the
unmerged hand's 21 and a narrow one.

Tolerances: float32 2e-5 max abs (the bound of tests/test_torch_block.py).
bfloat16: 2e-2 + 2^-4 |y| elementwise (four bf16 ulps), twice the block's
bound of tests/test_torch_block.py, doubled.  Twice, because the temporal
block takes the spatial block's output, with its flipped ulps and the
rounded ``+ tpe``, as input, so the output carries both blocks' flips.
Doubled, because XLA on the CPU keeps excess precision across some of the
kernel body's bfloat16 roundings (``xla_allow_excess_precision``, on by
default), so about half the layer's outputs differ from the port's by an
ulp, where with the flag off 0.3% do and all stay within 0.33 of twice the
block's bound (measured at (4, 27, 21, 32)).  Measured with the flag on: at
most 0.74 of this bound over six seeds and shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pafuse_tpu.models import mixste
from pafuse_tpu.ops import attention
from pafuse_tpu_torch.ops.layer import fused_layer, layer_reference
from test_torch_block import F32_TOL, HEADS, _jax_block, _port_params
from test_torch_block_temporal import interpret_kernels

torch.set_num_threads(2)

BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -4


def _case(B, F, N, C, seed=0):
    sp, sn = _jax_block(C, seed=seed + 1)
    tp, tn = _jax_block(C, seed=seed + 2)
    r = np.random.RandomState(F * 100 + N)
    x = r.randn(B, F, N, C).astype(np.float32)
    tpe = r.randn(F, C).astype(np.float32)
    return (sp, sn, tp, tn), x, tpe


def _port(blocks):
    sp, sn, tp, tn = blocks
    return _port_params(sp, sn) + _port_params(tp, tn)


def _kernel_ref(blocks, x, tpe, dtype):
    jtpe = None if tpe is None else jnp.asarray(tpe)
    with interpret_kernels():
        y = attention.pallas_layer(*blocks[:2], *blocks[2:],
                                   jnp.asarray(x, dtype), HEADS, dtype,
                                   tpe=jtpe)
    return np.asarray(y.astype(jnp.float32))


def _xla_ref(blocks, x, tpe):
    sp, sn, tp, tn = blocks
    f32 = jnp.float32
    ys = mixste._layernorm(sn, mixste._block(sp, jnp.asarray(x), HEADS, f32))
    if tpe is not None:
        ys = ys + jnp.asarray(tpe)[None, :, None, :]
    yt = mixste._block(tp, jnp.swapaxes(ys, 1, 2), HEADS, f32)
    return np.asarray(jnp.swapaxes(mixste._layernorm(tn, yt), 1, 2))


@pytest.mark.parametrize("B,F,N,C,with_tpe", [(2, 9, 21, 32, True),
                                              (2, 27, 10, 32, False)])
def test_layer_reference_matches_tpu_kernel_f32(B, F, N, C, with_tpe):
    blocks, x, tpe = _case(B, F, N, C)
    tpe = tpe if with_tpe else None
    got = layer_reference(torch.from_numpy(x), *_port(blocks), HEADS,
                          tpe=None if tpe is None else torch.from_numpy(tpe))
    assert got.shape == (B, F, N, C) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _kernel_ref(blocks, x, tpe,
                                                        jnp.float32),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("with_tpe", [True, False])
@pytest.mark.parametrize("B,F,N,C", [(2, 27, 42, 32), (2, 9, 21, 64)])
def test_layer_reference_matches_xla_f32(B, F, N, C, with_tpe):
    blocks, x, tpe = _case(B, F, N, C, seed=3)
    tpe = tpe if with_tpe else None
    port_tpe = None if tpe is None else torch.from_numpy(tpe)
    params = _port(blocks)
    got = layer_reference(torch.from_numpy(x), *params, HEADS,
                          tpe=port_tpe).numpy()
    np.testing.assert_allclose(got, _xla_ref(blocks, x, tpe), rtol=0,
                               atol=F32_TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    launches = fused_layer.launches
    np.testing.assert_array_equal(
        fused_layer(torch.from_numpy(x), *params, HEADS, tpe=port_tpe).numpy(),
        got)
    assert fused_layer.launches == launches


def test_layer_reference_matches_tpu_kernel_bf16():
    blocks, x, tpe = _case(2, 9, 21, 32, seed=5)
    got = layer_reference(torch.from_numpy(x).bfloat16(), *_port(blocks),
                          HEADS, tpe=torch.from_numpy(tpe))
    assert got.dtype == torch.bfloat16
    want = _kernel_ref(blocks, x, tpe, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_fused_layer_rejects_other_devices():
    blocks, _, _ = _case(1, 9, 7, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_layer(torch.empty(1, 9, 7, 32, device="meta"), *_port(blocks),
                    HEADS)
