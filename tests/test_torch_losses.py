"""Port metrics (pafuse_tpu_torch.losses) and camera geometry against their
JAX twins on the same seeded tensors.

Hypotheses are (B, S, H, F, N, 3) with the 134 H3WB joints, so the
part-based variants use the real part tables.  Tolerance: 1e-5 relative
(float32 means over up to ~10^4 terms, summed in another order; the
argmin-selected metrics compare selections made on the same float32
errors).  The protocol #2 family is NumPy on both sides and must agree
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pafuse_tpu import geometry as jgeo, losses as jl
from pafuse_tpu_torch import geometry as tgeo, losses as tl

torch.set_num_threads(2)

RTOL = 1e-5
B, S, H, F, N = 3, 2, 4, 5, 134


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def data():
    r = np.random.RandomState(0)
    pred = (0.3 * r.randn(B, S, H, F, N, 3)).astype(np.float32)
    gt = (0.3 * r.randn(B, F, N, 3)).astype(np.float32)
    reproj = r.randn(B, S, H, F, N, 2).astype(np.float32)
    x2d = r.randn(B, F, N, 2).astype(np.float32)
    return pred, gt, reproj, x2d


CASES = [
    ("mpjpe_diffusion_all_min", {}),
    ("mpjpe_diffusion_all_min", {"mean_pos": True}),
    ("mpjpe_diffusion_all_min", {"part_based": True}),
    ("mpjpe_diffusion_all_min", {"mean_pos": True, "part_based": True}),
    ("mpjpe_diffusion", {}),
    ("mpjpe_diffusion", {"mean_pos": True}),
    ("mpjpe_diffusion", {"part_based": True}),
    ("mpjpe_diffusion", {"mean_pos": True, "part_based": True}),
]


@pytest.mark.parametrize("name,kw", CASES)
def test_hypothesis_metrics_match_jax(data, name, kw):
    pred, gt = data[:2]
    want = getattr(jl, name)(jnp.asarray(pred), jnp.asarray(gt), **kw)
    got = getattr(tl, name)(torch.from_numpy(pred), torch.from_numpy(gt), **kw)
    _close(got, want)


def test_p_best_part_errors_follow_the_argmin(data):
    """The part errors of P_Best are those of the hypothesis with the least
    whole-body error, not each part's own minimum."""
    from pafuse_tpu_torch import skeleton as sk
    pred, gt = data[:2]
    pb, parts = tl.mpjpe_diffusion(torch.from_numpy(pred),
                                   torch.from_numpy(gt), part_based=True)
    centred = [tgeo.center_pose_parts(torch.from_numpy(a)).numpy().astype(np.float64)
               for a in (pred, gt)]
    err = np.linalg.norm(centred[0] - centred[1][:, None, None], axis=-1)
    best = err.mean(axis=(0, 3, 4)).argmin(axis=1)            # (S,)
    np.testing.assert_allclose(pb.numpy(), err.mean(axis=(0, 3, 4)).min(1),
                               rtol=RTOL)
    assert set(parts) == set(sk.PARTS_JOINT_INDICES)
    for p, idx in sk.PARTS_JOINT_INDICES.items():
        want = [err[:, s, best[s]][..., idx].mean() for s in range(S)]
        np.testing.assert_allclose(parts[p].numpy(), want, rtol=RTOL)


def test_reprojection_metric_matches_jax(data):
    pred, gt, reproj, x2d = data
    want = jl.mpjpe_diffusion_reproj(*map(jnp.asarray, data))
    got = tl.mpjpe_diffusion_reproj(*map(torch.from_numpy, data))
    _close(got, want)


@pytest.mark.parametrize("mean_pos", [False, True])
def test_3dhp_masked_metric_matches_jax(data, mean_pos):
    pred, gt = data[:2]
    valid = np.random.RandomState(1).rand(B, F) > 0.3
    want = jl.mpjpe_diffusion_3dhp(jnp.asarray(pred), jnp.asarray(gt),
                                   jnp.asarray(valid), mean_pos=mean_pos)
    got = tl.mpjpe_diffusion_3dhp(torch.from_numpy(pred), torch.from_numpy(gt),
                                  torch.from_numpy(valid), mean_pos=mean_pos)
    _close(got, want)


def test_pose_metrics_match_jax(data):
    pred, gt = data[0][:, 0, 0], data[1]           # (B, F, N, 3)
    jp, jt, tp, tt = (jnp.asarray(pred), jnp.asarray(gt),
                      torch.from_numpy(pred), torch.from_numpy(gt))
    w = np.linspace(0.5, 2.0, N).astype(np.float32)
    for mse in (False, True):
        _close(tl.mpjpe(tp, tt, torch.from_numpy(w), mse_loss=mse),
               jl.mpjpe(jp, jt, w, mse_loss=mse))
    _close(tl.mpjpe_per_joint(tp, tt), jl.mpjpe_per_joint(jp, jt))
    _close(tl.n_mpjpe(tp, tt), jl.n_mpjpe(jp, jt))
    _close(tl.mean_velocity_error_train(tp, tt),
           jl.mean_velocity_error_train(jp, jt))
    assert tl.mean_velocity_error(pred, gt) == jl.mean_velocity_error(pred, gt)


def test_procrustes_family_matches_jax(data):
    pred, gt, reproj, x2d = data
    assert tl.p_mpjpe(pred[:, 0, 0, 0], gt[:, 0]) == jl.p_mpjpe(
        pred[:, 0, 0, 0], gt[:, 0])
    for mean_pos in (False, True):
        np.testing.assert_array_equal(
            tl.p_mpjpe_diffusion_all_min(pred, gt, mean_pos=mean_pos),
            jl.p_mpjpe_diffusion_all_min(pred, gt, mean_pos=mean_pos))
        np.testing.assert_array_equal(
            tl.p_mpjpe_diffusion(pred, gt, mean_pos=mean_pos),
            jl.p_mpjpe_diffusion(pred, gt, mean_pos=mean_pos))
    np.testing.assert_array_equal(
        tl.p_mpjpe_diffusion_reproj(pred, gt, reproj, x2d),
        jl.p_mpjpe_diffusion_reproj(pred, gt, reproj, x2d))


def _cams(n, seed):
    r = np.random.RandomState(seed)
    cam = np.concatenate([r.uniform(1.0, 2.5, (n, 2)), r.uniform(-0.1, 0.1, (n, 2)),
                          r.uniform(-0.2, 0.2, (n, 3)), r.uniform(-0.01, 0.01, (n, 2))],
                         axis=1)
    return cam.astype(np.float32)


def test_projection_matches_jax(data):
    """Camera-space points (metres, in front of the camera) through the
    distortion model and the pinhole model, intrinsics broadcast over the
    (S, H, F, N) axes as the eval step does."""
    pred = data[0] + np.array([0, 0, 4.0], np.float32)
    cam = _cams(B, seed=2)
    for name in ("project_to_2d", "project_to_2d_linear"):
        want = getattr(jgeo, name)(jnp.asarray(pred), jnp.asarray(cam))
        got = getattr(tgeo, name)(torch.from_numpy(pred), torch.from_numpy(cam))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tgeo.project_to_2d_np(pred, cam),
        np.asarray(jgeo.project_to_2d(pred, cam)), rtol=RTOL, atol=1e-6)


def test_uvd2xyz_and_intrinsics_flip_match_jax():
    r = np.random.RandomState(3)
    uvd = r.randn(2, 4, 17, 3).astype(np.float32)
    gt = (r.randn(2, 4, 17, 3) + [0, 0, 5]).astype(np.float32)
    cam = _cams(2, seed=4)
    np.testing.assert_allclose(
        tgeo.uvd2xyz(torch.from_numpy(uvd), torch.from_numpy(gt),
                     torch.from_numpy(cam)).numpy(),
        np.asarray(jgeo.uvd2xyz(uvd, gt, cam)), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(tgeo.flip_intrinsics_np(cam),
                                  jgeo.flip_intrinsics_np(cam))
