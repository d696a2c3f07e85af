"""Port serving path and its host-side helpers against the JAX package.

``LiftingService.lift`` of the port and of the JAX package serve the same
params and draw the same host noise for the same (request, seed), so their
poses agree to float32 noise: lone requests (port batching on, JAX off),
both batchers under four concurrent clients, the ``1x1`` tier of a
``["2x2", "1x1"]`` service, ``readback="mean"`` and streaming sessions
(fixed and per-frame noise, delay 0 and 3, world).  ``_window_seeds`` and
the host noise (any salt and base) are bit-equal.  Config: depth 1, 9
frames, P=2, T=2, buckets (1, 2).  Tolerance 1e-4 max abs, the DDIM bound of
tests/test_torch_diffusion.py; the camera->world rotation and floor rebase
of ``world=True`` are O(1) and add float32 rounding only.
"""

import concurrent.futures as cf
import threading

import numpy as np
import pytest
import torch

import jax

from pafuse_tpu import geometry as jax_geometry
from pafuse_tpu import serve as jax_serve
from pafuse_tpu import skeleton as jax_sk
from pafuse_tpu.data import windows as jax_windows
from pafuse_tpu.diffusion import D3DP as JaxD3DP
from pafuse_tpu.diffusion import D3DPConfig as JaxD3DPConfig
from pafuse_tpu_torch import checkpoints, geometry, serve, skeleton
from pafuse_tpu_torch.data import windows
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

TOL = 1e-4
KW = dict(frames=9, num_kps=134, timesteps=20, sampling_timesteps=2,
          num_proposals=2, depth=1)


@pytest.fixture(scope="module")
def jax_model_params():
    jm = JaxD3DP(JaxD3DPConfig(**KW))
    return jm, jax.device_get(jm.init_params(jax.random.PRNGKey(1)))


def _pair(jax_model_params, **kw):
    """(JAX service, port service) over the same params, ``kw`` to both."""
    jm, params = jax_model_params
    jsvc = jax_serve.LiftingService(jm, params, buckets=(1, 2), **kw)
    psvc = serve.LiftingService(D3DP(D3DPConfig(**KW), device="cpu"),
                                checkpoints.params_from_jax(params),
                                buckets=(1, 2), device="cpu",
                                **{k: v for k, v in kw.items()
                                   if k != "dynamic_batching"})
    return jsvc, psvc


@pytest.fixture(scope="module")
def services(jax_model_params):
    """JAX with batching off, the port with its default batcher on."""
    jsvc, psvc = _pair(jax_model_params, dynamic_batching=False)
    yield jsvc, psvc
    jsvc.close()
    psvc.close()


def _keypoints(frames, seed, pixels=False):
    r = np.random.RandomState(seed)
    kp = r.uniform(-1, 1, (frames, 134, 2)).astype(np.float32)
    return (kp + 1) * 320 if pixels else kp


@pytest.mark.parametrize("frames,kw", [
    (22, {}),                                     # 3 windows, tail, 2 chunks
    (5, {"all_hypotheses": True}),                # shorter than one window
    (13, {"width": 640, "height": 480}),
    (18, {"width": 640, "height": 480, "world": True,
          "all_hypotheses": True}),
])
def test_lift_matches_jax_service(services, frames, kw):
    jsvc, psvc = services
    kp = _keypoints(frames, seed=frames, pixels="width" in kw)
    want = jsvc.lift(kp, seed=7, **kw)["poses"]
    got = psvc.lift(kp, seed=7, **kw)
    assert got["poses"].shape == want.shape
    assert got["poses"].shape == ((2,) if kw.get("all_hypotheses") else ()) + (
        frames, 134, 3)
    assert got["num_frames"] == frames and got["num_hypotheses"] == 2
    np.testing.assert_allclose(got["poses"], want, rtol=0, atol=TOL)


def test_lift_deterministic_and_seeded(services):
    _, psvc = services
    kp = _keypoints(11, seed=3)
    a, b = psvc.lift(kp, seed=1)["poses"], psvc.lift(kp, seed=1)["poses"]
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, psvc.lift(kp, seed=2)["poses"])
    # body root comes out exactly zero (wb_pose_from_parts)
    assert np.all(a[:, 0] == 0)


@pytest.mark.parametrize("kw", [{}, {"salt": 0x51AE, "base": 17},
                                {"op_point": (1, 1), "base": 3}])
def test_request_noise_matches_jax(services, kw):
    jsvc, psvc = services
    for got, want in zip(psvc._request_noise(3, seed=9, **kw),
                         jsvc._request_noise(3, seed=9, **kw)):
        np.testing.assert_array_equal(got, want)


def test_window_seeds_match_jax():
    for kw in ({}, {"salt": 0x51AE}, {"base": 40}, {"salt": 7, "base": 2**31}):
        for seed in (0, 1, 12345, 2**32 - 1):
            np.testing.assert_array_equal(
                serve.LiftingService._window_seeds(6, seed, **kw),
                jax_serve.LiftingService._window_seeds(6, seed, **kw))


def test_batching_services_match_jax_under_concurrency(jax_model_params):
    """Both services with their dynamic batchers on, four concurrent
    clients each: every request's poses agree."""
    jsvc, psvc = _pair(jax_model_params)
    try:
        reqs = [(_keypoints(f, seed=f), i) for i, f in
                enumerate((9, 14, 5, 27, 9, 18, 3, 11))]

        def run(svc):
            with cf.ThreadPoolExecutor(4) as ex:
                futs = [ex.submit(svc.lift, kp, seed=s) for kp, s in reqs]
                return [f.result(timeout=300)["poses"] for f in futs]
        want, got = run(jsvc), run(psvc)
        assert psvc.health()["batch_calls"] <= len(reqs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    finally:
        jsvc.close()
        psvc.close()


def test_op_point_tiers_match_jax(jax_model_params):
    jsvc, psvc = _pair(jax_model_params, op_points=["2x2", "1x1"])
    try:
        kp = _keypoints(13, seed=4)
        for pt in ("1x1", None):
            want = jsvc.lift(kp, seed=6, op_point=pt)
            got = psvc.lift(kp, seed=6, op_point=pt)
            assert got["num_hypotheses"] == want["num_hypotheses"]
            np.testing.assert_allclose(got["poses"], want["poses"], rtol=0,
                                       atol=TOL, err_msg=str(pt))
    finally:
        jsvc.close()
        psvc.close()


def test_mean_readback_matches_jax(jax_model_params):
    jsvc, psvc = _pair(jax_model_params, readback="mean",
                       dynamic_batching=False)
    try:
        for frames, kw in ((13, {}), (7, {"world": True})):
            kp = _keypoints(frames, seed=frames)
            np.testing.assert_allclose(psvc.lift(kp, seed=2, **kw)["poses"],
                                       jsvc.lift(kp, seed=2, **kw)["poses"],
                                       rtol=0, atol=TOL)
    finally:
        jsvc.close()
        psvc.close()


@pytest.mark.parametrize("kw", [
    {},
    {"per_frame_noise": True},
    {"delay": 3, "world": True},
    {"delay": 3, "per_frame_noise": True, "world": True,
     "all_hypotheses": True},
])
def test_streaming_matches_jax(services, kw):
    """The same pushes through a JAX and a port session: one frame at a
    time, then three at once; every emit and frame index agrees."""
    jsvc, psvc = services
    js = jax_serve.StreamingSession(jsvc, seed=4, **kw)
    ps = serve.StreamingSession(psvc, seed=4, **kw)
    kp = _keypoints(8, seed=5)
    for push in (kp[0], kp[1], kp[2], kp[3], kp[4], kp[5:8]):
        want, got = js.push(push), ps.push(push)
        assert got["frame_indices"] == want["frame_indices"]
        assert got["poses"].shape == want["poses"].shape
        np.testing.assert_allclose(got["poses"], want["poses"], rtol=0,
                                   atol=TOL)


def test_lift_validation_and_health(services):
    _, psvc = services
    with pytest.raises(ValueError):
        psvc.lift(np.zeros((4, 133, 2), np.float32))
    with pytest.raises(ValueError):
        psvc.lift(np.zeros((4, 134, 2), np.float32), width=640)
    with pytest.raises(ValueError):
        psvc.lift(np.zeros((0, 134, 2), np.float32))
    h = psvc.health()
    assert h["status"] == "ok" and h["buckets"] == [1, 2]
    assert h["device"] == "cpu" and h["requests"] >= 1


def test_health_does_not_wait_for_a_running_request(services):
    """health() reads the stats without the request lock, as the JAX
    service does: it returns while a request (here: the test) holds it."""
    _, psvc = services
    out, done = {}, threading.Event()

    def check():
        out.update(psvc.health())
        done.set()

    with psvc._lock:
        thread = threading.Thread(target=check, daemon=True)
        thread.start()
        assert done.wait(timeout=30), "health() waited for the request lock"
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert out["status"] == "ok" and out["buckets"] == [1, 2]


def test_bucket_for_matches_jax():
    for n in range(1, 40):
        for buckets in ((1, 2, 4, 8, 16), (4,), (1, 3)):
            assert serve.bucket_for(n, buckets) == jax_serve.bucket_for(
                n, buckets)


def test_skeleton_tables_equal_jax():
    assert skeleton.NUM_JOINTS == jax_sk.NUM_JOINTS
    np.testing.assert_array_equal(skeleton.FLIP_PERMUTATION,
                                  jax_sk.FLIP_PERMUTATION)
    np.testing.assert_array_equal(skeleton.CONNECTION_OF_JOINT,
                                  jax_sk.CONNECTION_OF_JOINT)
    for merge in (True, False):
        assert skeleton.parts_table(merge) == jax_sk.parts_table(merge)
    merged = skeleton.parts_table(True)
    assert merged["body"] == list(range(24))
    assert merged["face"] == list(range(24, 92))
    assert merged["hands"] == list(range(92, 134))


def test_geometry_matches_jax():
    r = np.random.RandomState(0)
    pose = r.randn(2, 5, 134, 3).astype(np.float32)
    perm = skeleton.FLIP_PERMUTATION
    np.testing.assert_array_equal(
        geometry.flip_pose(torch.from_numpy(pose), perm).numpy(),
        np.asarray(jax_geometry.flip_pose(pose, perm)))
    np.testing.assert_array_equal(geometry.flip_pose_np(pose, perm),
                                  jax_geometry.flip_pose_np(pose, perm))
    np.testing.assert_allclose(
        geometry.wb_pose_from_parts(torch.from_numpy(pose)).numpy(),
        np.asarray(jax_geometry.wb_pose_from_parts(pose)), rtol=0, atol=0)
    px = (r.rand(7, 134, 2) * 640).astype(np.float32)
    np.testing.assert_allclose(
        geometry.normalize_screen_coordinates(px, 640, 480),
        jax_geometry.normalize_screen_coordinates(px, 640, 480),
        rtol=0, atol=1e-6)
    rot = serve._WORLD_ROT
    np.testing.assert_allclose(
        geometry.camera_to_world(torch.from_numpy(pose), rot, 0.0).numpy(),
        np.asarray(jax_geometry.camera_to_world(pose, rot, 0.0)),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("frames", [1, 8, 9, 10, 27, 40])
def test_windows_match_jax(frames):
    rf = 9
    x = np.random.RandomState(frames).randn(frames, 134, 2).astype(np.float32)
    np.testing.assert_array_equal(windows.window_indices(frames, rf),
                                  jax_windows.window_indices(frames, rf))
    w, _ = windows.eval_data_prepare(rf, x)
    jw, _ = jax_windows.eval_data_prepare(rf, x)
    np.testing.assert_array_equal(w, jw)
    preds = np.random.RandomState(1).randn(2, w.shape[0], rf, 134, 3)
    np.testing.assert_array_equal(
        windows.stitch_windows(preds, frames, rf),
        jax_windows.stitch_windows(preds, frames, rf))
