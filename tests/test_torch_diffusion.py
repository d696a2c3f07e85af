"""Port PartModel and D3DP.ddim_sample against the JAX package at depth 1
and the published part widths (body 384, face 224, merged hands 256), with
injected init and step noise, flip-TTA on and off.

Tolerance: float32 1e-4 max abs on poses (inputs and noise are O(1)): the
denoiser alone holds 2e-5 per call (tests/test_torch_mixste.py); DDIM feeds
each step's prediction back in through 1/sqrt(1/alpha - 1) (up to ~6x at the
early steps) and the flip average, so per-call differences grow a few-fold.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import diffusion as jax_diffusion
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.diffusion import (D3DP, D3DPConfig, ddim_noise,
                                        ddim_time_pairs, make_schedule)

torch.set_num_threads(2)

TOL = 1e-4
KW = dict(frames=9, num_kps=134, timesteps=1000, sampling_timesteps=2,
          num_proposals=2, depth=1)
B, H, S, F, N = 2, 2, 2, 9, 134


@pytest.fixture(scope="module")
def models():
    jm = jax_diffusion.D3DP(jax_diffusion.D3DPConfig(**KW))
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    pm = D3DP(D3DPConfig(**KW), device="cpu")
    pm.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                      strict=True)
    return jm, params, pm


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    x2d = r.uniform(-1, 1, (B, F, N, 2)).astype(np.float32)
    init = r.randn(B, H, F, N, 3).astype(np.float32)
    step = r.randn(S, B, H, F, N, 3).astype(np.float32)
    return x2d, init, step


def test_schedule_and_time_pairs_match_jax():
    for T in (20, 1000):
        a, b = make_schedule(T), jax_diffusion.make_schedule(T)
        for name in a.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for s in (1, 2, 5, 10):
            assert ddim_time_pairs(T, s) == jax_diffusion.ddim_time_pairs(T, s)


def test_part_model_matches_jax(models):
    jm, params, pm = models
    r = np.random.RandomState(5)
    x2d = r.uniform(-1, 1, (3, F, N, 2)).astype(np.float32)
    x3d = r.randn(3, F, N, 3).astype(np.float32)
    t = np.array([0, 500, 999], np.int32)
    want = np.asarray(jax.jit(jm.model)(params, jnp.asarray(x2d),
                                        jnp.asarray(x3d), jnp.asarray(t)))
    with torch.no_grad():
        got = pm.pose_estimator(torch.from_numpy(x2d), torch.from_numpy(x3d),
                                torch.from_numpy(t)).numpy()
    assert got.shape == (3, F, N, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("flip", [True, False])
def test_ddim_sample_matches_jax(models, flip):
    jm, params, pm = models
    x2d, init, step = _inputs(seed=int(flip))
    x2d_flip = x2d[..., jm.flip_permutation, :] * np.array(
        [-1, 1], np.float32) if flip else None
    want = np.asarray(jm.ddim_sample(
        params, jax.random.PRNGKey(0), jnp.asarray(x2d),
        None if x2d_flip is None else jnp.asarray(x2d_flip),
        init_noise=init, step_noise=step))
    got = pm.ddim_sample(
        torch.from_numpy(x2d),
        None if x2d_flip is None else torch.from_numpy(x2d_flip),
        init_noise=torch.from_numpy(init),
        step_noise=torch.from_numpy(step)).numpy()
    assert got.shape == (B, S, H, F, N, 3)
    assert np.all(np.abs(got) <= 1.1 + 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_ddim_sample_draws_from_generator(models):
    _, _, pm = models
    x2d = torch.from_numpy(_inputs()[0])
    a, b = (pm.ddim_sample(x2d, generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (B, S, H, F, N, 3)


@pytest.mark.parametrize("S_", [1, 2, 3])
def test_ddim_sample_draws_through_ddim_noise(models, S_):
    """``diffusion.ddim_noise`` is the one owner of DDIM's draw order (the
    sharded evaluation draws the global batch through it): sampling that
    draws for itself equals sampling handed ``ddim_noise``'s draws from an
    equally seeded generator, bit for bit, with the generator left in the
    same state; the last step adds no noise."""
    _, _, pm = models
    x2d = torch.from_numpy(_inputs()[0])
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    own = pm.ddim_sample(x2d, sampling_timesteps=S_, generator=g1)
    init, steps = ddim_noise(pm.cfg, x2d.shape, H, S_, "cpu", g2)
    given = pm.ddim_sample(x2d, sampling_timesteps=S_, init_noise=init,
                           step_noise=steps)
    assert torch.equal(own, given)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert steps.shape == (S_, B, H, F, N, 3) and not steps[-1].any()
