"""Port temporal block (pafuse_tpu_torch.ops.block_temporal) against the JAX
package.

The same seeded inputs and weights go through the port's plain version
(``block_temporal_reference``, which ``fused_block_temporal`` uses for CPU
tensors) and two JAX references: the TPU kernel ``_block_t_kernel`` run by
the JAX wrapper ``pallas_block_temporal`` with its own block specs (tiles
(1, F, TBn, C) over a (B, ceil(N/TBn)) grid, F padded to a multiple of 8 and
masked) through ``pl.pallas_call`` in interpret mode, and the XLA
composition ``swapaxes(_layernorm(outer, _block(swapaxes(x))))``.  One case
has joint tiles that overhang N (N = 10 in tiles of 4), which the TPU kernel
zeroes.  Weights cross through ``checkpoints.params_from_jax``.

Tolerances are those of tests/test_torch_block.py (the same block, the
frames as tokens): float32 2e-5 max abs; bfloat16 5e-3 + 2^-6 |y|
elementwise (two bf16 ulps).
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from pafuse_tpu.models import mixste
from pafuse_tpu.ops import attention
from pafuse_tpu_torch.ops.block_temporal import (block_temporal_reference,
                                                 fused_block_temporal)
from test_torch_block import (BF16_ATOL, BF16_RTOL, F32_TOL, HEADS,
                              _jax_block, _port_params)

torch.set_num_threads(2)


@contextlib.contextmanager
def interpret_kernels():
    """The JAX package's Pallas wrappers run (they decline on the CPU
    otherwise), each ``pl.pallas_call`` in interpret mode."""
    with mock.patch.object(attention, "_pallas_usable", lambda: True), \
            mock.patch.object(attention.pl, "pallas_call", functools.partial(
                pl.pallas_call, interpret=True)):
        yield


def _xla_ref(p, outer, x, dtype):
    """The XLA path around a temporal block: swapaxes, block, outer LN,
    swapaxes."""
    xt = jnp.swapaxes(jnp.asarray(x, dtype), 1, 2)
    y = mixste._layernorm(outer, mixste._block(p, xt, HEADS, dtype))
    return np.asarray(jnp.swapaxes(y, 1, 2).astype(jnp.float32))


def _kernel_ref(p, outer, x, dtype, joint_tile=None):
    with interpret_kernels():
        y = attention.pallas_block_temporal(p, outer, jnp.asarray(x, dtype),
                                            HEADS, dtype,
                                            joint_tile=joint_tile)
    return np.asarray(y.astype(jnp.float32))


def _case(B, F, N, C):
    p, outer = _jax_block(C, seed=F * 1000 + N * 10 + C)
    x = np.random.RandomState(N + C).randn(B, F, N, C).astype(np.float32)
    return p, outer, x


#: (B, F, N, C, joint tile): 27 frames (padded to 32) with N = 10 joints in
#: tiles of 4, the third overhanging N by 2; 9 frames at the wrapper's
#: default tile (all 7 joints in one)
KERNEL_CASES = [(2, 27, 10, 32, 4), (2, 9, 7, 64, None)]


@pytest.mark.parametrize("B,F,N,C,tile", KERNEL_CASES)
def test_block_temporal_reference_matches_tpu_kernel_f32(B, F, N, C, tile):
    p, outer, x = _case(B, F, N, C)
    bp, on = _port_params(p, outer)
    got = block_temporal_reference(torch.from_numpy(x), bp, on, HEADS)
    assert got.shape == (B, F, N, C) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(),
                               _kernel_ref(p, outer, x, jnp.float32, tile),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("B,F,N,C", [(3, 27, 24, 32), (2, 27, 68, 32),
                                     (2, 27, 42, 64), (3, 9, 21, 64)])
def test_block_temporal_reference_matches_xla_f32(B, F, N, C):
    p, outer, x = _case(B, F, N, C)
    bp, on = _port_params(p, outer)
    got = block_temporal_reference(torch.from_numpy(x), bp, on, HEADS).numpy()
    np.testing.assert_allclose(got, _xla_ref(p, outer, x, jnp.float32),
                               rtol=0, atol=F32_TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    launches = fused_block_temporal.launches
    np.testing.assert_array_equal(
        fused_block_temporal(torch.from_numpy(x), bp, on, HEADS).numpy(), got)
    assert fused_block_temporal.launches == launches


def test_block_temporal_reference_matches_tpu_kernel_bf16():
    p, outer, x = _case(2, 27, 10, 32)
    bp, on = _port_params(p, outer)
    got = block_temporal_reference(torch.from_numpy(x).bfloat16(), bp, on,
                                   HEADS)
    assert got.dtype == torch.bfloat16
    want = _kernel_ref(p, outer, x, jnp.bfloat16, joint_tile=4)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_fused_block_temporal_rejects_other_devices():
    p, outer, _ = _case(1, 9, 7, 32)
    bp, on = _port_params(p, outer)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block_temporal(torch.empty(2, 9, 7, 32, device="meta"), bp, on,
                             HEADS)
