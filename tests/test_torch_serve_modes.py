"""The port's serving modes on the CPU: streaming sessions (and their HTTP
endpoints), device noise, mean readback and op-point tiers.

Twins of the single-device cases of ``tests/test_serve.py``.  Config: depth
1, 9 frames, P=2, T=2, buckets (1, 2, 4), seeded weights.  Device noise is a
noise universe of its own (``torch.Generator`` per window), so its tests
hold the rule, not the bits: a window's noise depends only on (seed, window
index, salt), never on chunking or co-batching.  Bounds: 2e-5 max abs where
rows run at another row count (as the JAX tests), 1e-5 for a device-side
hypothesis mean against the host's (another order of float32 sums), 1e-6
for a tier against a dedicated service (the same calls).
"""

import concurrent.futures as cf
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pafuse_tpu_torch import geometry, serve
from pafuse_tpu_torch.data import windows as win
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

TINY = D3DPConfig(frames=9, num_kps=134, timesteps=20, sampling_timesteps=2,
                  num_proposals=2, depth=1)


def _service(**kw):
    model = D3DP(TINY, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    return serve.LiftingService(model, device="cpu", **{
        "buckets": (1, 2, 4), **kw})


@pytest.fixture(scope="module")
def service():
    svc = _service()
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def device_noise_service(service):
    svc = serve.LiftingService(service.model, buckets=(1, 2, 4),
                               noise_mode="device", device="cpu")
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def mean_readback_service(service):
    svc = serve.LiftingService(service.model, buckets=(1, 2, 4),
                               readback="mean", device="cpu")
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def tiered_service(service):
    svc = serve.LiftingService(service.model, buckets=(1, 2),
                               op_points=[(2, 2), "1x1", "2X2"],
                               device="cpu")
    svc.warmup()
    yield svc
    svc.close()


def _http(svc, **kw):
    server = serve.make_http_server(svc, port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            f"{base}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()
    return base, post, stop


# -- streaming sessions -------------------------------------------------------

def test_streaming_final_emit_matches_batch_lift(service):
    """After exactly rf pushes (fixed noise, delay 0) the last emit equals
    the batch lift's last frame: the trailing window is the batch request's
    one window and the fixed noise its window-0 draw."""
    rf = service.receptive_field
    kps = np.random.RandomState(7).randn(rf, 134, 2).astype(np.float32)
    sess = serve.StreamingSession(service, seed=3)
    emits = [sess.push(kps[t])["poses"][0] for t in range(rf)]
    batch = service.lift(kps, seed=3)["poses"]
    np.testing.assert_allclose(emits[-1], batch[-1], atol=2e-5)
    assert sess.frames_pushed == rf

    sess_d = serve.StreamingSession(service, seed=3, delay=2)
    for t in range(rf):
        out = sess_d.push(kps[t])
    assert out["frame_indices"] == [rf - 1 - 2]
    np.testing.assert_allclose(out["poses"][0], batch[rf - 1 - 2], atol=2e-5)


def test_streaming_multi_frame_push_matches_per_frame(service):
    kps = np.random.RandomState(8).randn(6, 134, 2).astype(np.float32)
    one = serve.StreamingSession(service, seed=1)
    per = np.concatenate([one.push(k)["poses"] for k in kps])
    many = serve.StreamingSession(service, seed=1).push(kps)
    np.testing.assert_allclose(many["poses"], per, atol=2e-5)
    assert many["frame_indices"] == list(range(6))

    # fixed noise: identical trailing windows -> identical poses
    const = serve.StreamingSession(service, seed=1)
    np.testing.assert_allclose(const.push(kps[0])["poses"],
                               const.push(kps[0])["poses"], atol=2e-5)

    # per-frame noise: same window, another draw per t, reproducible
    varied = serve.StreamingSession(service, seed=1, per_frame_noise=True)
    a = varied.push(kps[0])["poses"]
    assert np.abs(a - varied.push(kps[0])["poses"]).max() > 0
    again = serve.StreamingSession(service, seed=1, per_frame_noise=True)
    np.testing.assert_array_equal(again.push(kps[0])["poses"], a)


def test_streaming_validation_and_stats(service):
    with pytest.raises(ValueError):
        serve.StreamingSession(service, delay=service.receptive_field)
    with pytest.raises(ValueError):
        serve.StreamingSession(service, width=640)  # height missing
    sess = serve.StreamingSession(service)
    with pytest.raises(ValueError):
        sess.push(np.zeros((17, 2), np.float32))    # wrong joint count
    with pytest.raises(ValueError):
        sess.push(np.zeros((134, 3), np.float32))   # not 2D keypoints
    before = service.health()["stream_frames"]
    sess.push(np.zeros((134, 2), np.float32))
    health = service.health()
    assert health["stream_frames"] == before + 1
    assert health["stream_sessions"] >= 1


def test_streaming_world_floor_is_causal(service):
    """World mode rebases z against the running minimum: z >= 0 always,
    and the floor only moves down."""
    rng = np.random.RandomState(9)
    sess = serve.StreamingSession(service, seed=2, world=True,
                                  all_hypotheses=True)
    floors = []
    for _ in range(4):
        out = sess.push(rng.randn(134, 2).astype(np.float32))
        assert out["poses"].shape == (1, 2, 134, 3)
        assert float(out["poses"][..., 2].min()) >= -1e-6
        floors.append(sess._floor)
    assert floors == sorted(floors, reverse=True)


def test_http_stream_endpoints(service):
    base, post, stop = _http(service)
    try:
        made = post("/stream", {"seed": 5, "delay": 1})
        sid = made["session"]
        assert made["receptive_field"] == service.receptive_field
        assert made["delay"] == 1
        kps = np.zeros((134, 2), np.float32).tolist()
        out = post(f"/stream/{sid}", {"keypoints": kps})
        assert out["shape"] == [1, 134, 3] and out["frame_indices"] == [0]
        out = post(f"/stream/{sid}",
                   {"keypoints": np.zeros((3, 134, 2)).tolist()})
        assert out["shape"] == [3, 134, 3]

        req = urllib.request.Request(f"{base}/stream/{sid}", method="DELETE")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"closed": True, "frames": 4}
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(f"/stream/{sid}", {"keypoints": kps})
        assert ei.value.code == 404
        bad = urllib.request.Request(f"{base}/nope", method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 404

        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/stream", {"delay": 99})         # malformed -> 400
        assert ei.value.code == 400
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        stop()


def test_http_stream_idle_eviction(service):
    base, post, stop = _http(service, stream_idle_timeout=0.0)
    try:
        sid = post("/stream", {})["session"]
        time.sleep(0.01)
        post("/stream", {})                        # creation sweeps idle ones
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(f"/stream/{sid}",
                 {"keypoints": np.zeros((134, 2), np.float32).tolist()})
        assert ei.value.code == 404
    finally:
        stop()


# -- device noise -------------------------------------------------------------

def test_device_noise_determinism_and_layout_invariance(device_noise_service):
    """Same seed, same poses; another seed, other poses; and a window's noise
    depends only on (seed, window index): the request through buckets=(1,)
    (three one-window chunks) and co-batched behind another request give
    the same poses."""
    svc = device_noise_service
    kps = np.random.RandomState(3).randn(20, 134, 2).astype(np.float32)
    out = svc.lift(kps, seed=7)["poses"]
    assert out.shape == (20, 134, 3) and np.all(np.isfinite(out))
    np.testing.assert_array_equal(out, svc.lift(kps, seed=7)["poses"])
    assert np.abs(out - svc.lift(kps, seed=8)["poses"]).max() > 0

    one = serve.LiftingService(svc.model, buckets=(1,), noise_mode="device",
                               device="cpu")
    try:
        np.testing.assert_allclose(one.lift(kps, seed=7)["poses"], out,
                                   rtol=0, atol=2e-5)
    finally:
        one.close()

    # co-batched: another request's rows first, then this one's
    w2d = np.random.RandomState(4).randn(1, 9, 134, 2).astype(np.float32)
    flip = geometry.flip_pose_np(kps, svc.model.flip_permutation)
    mine = svc._request_arrays(win.eval_data_prepare(9, kps)[0],
                               win.eval_data_prepare(9, flip)[0], seed=7)
    b = serve._DynamicBatcher(svc, autostart=False)
    f_other = b.submit(svc._request_arrays(w2d, w2d, seed=99))
    f_mine = b.submit(mine)
    calls = svc.stats["batch_calls"]
    b._thread.start()
    try:
        rows = f_mine.result(timeout=120)
        f_other.result(timeout=120)
    finally:
        b.stop()
        b._thread.join(timeout=60)
    assert svc.stats["batch_calls"] == calls + 1
    np.testing.assert_allclose(rows, svc._device_run(*mine), rtol=0,
                               atol=2e-5)


def test_device_noise_draws_per_window(device_noise_service):
    """The noise itself: window k's draw is the same whichever rows it
    travels with, and differs between windows and seeds."""
    svc = device_noise_service
    seeds = svc._window_seeds(4, seed=1)
    init, stepn = svc._device_noise(seeds, (2, 2))
    assert init.shape == (4, 2, 9, 134, 3)
    assert stepn.shape == (2, 4, 2, 9, 134, 3)
    init2, stepn2 = svc._device_noise(seeds[2:], (2, 2))
    torch.testing.assert_close(init2, init[2:], rtol=0, atol=0)
    torch.testing.assert_close(stepn2, stepn[:, 2:], rtol=0, atol=0)
    assert not torch.equal(init[0], init[1])
    other, _ = svc._device_noise(svc._window_seeds(1, seed=2), (2, 2))
    assert not torch.equal(other[0], init[0])


def test_device_noise_streaming_matches_batch(device_noise_service):
    svc = device_noise_service
    rf = svc.receptive_field
    kps = np.random.RandomState(4).randn(rf, 134, 2).astype(np.float32)
    batch = svc.lift(kps, seed=5)["poses"]
    sess = serve.StreamingSession(svc, seed=5)
    for t in range(rf):
        last = sess.push(kps[t])
    np.testing.assert_allclose(last["poses"][0], batch[-1], atol=2e-5)


def test_device_noise_per_frame_streaming(device_noise_service):
    svc = device_noise_service
    kps = np.random.RandomState(5).randn(4, 134, 2).astype(np.float32)
    s1 = serve.StreamingSession(svc, seed=9, per_frame_noise=True)
    s2 = serve.StreamingSession(svc, seed=9, per_frame_noise=True)
    outs = []
    for t in range(4):
        a = s1.push(kps[t])["poses"]
        np.testing.assert_array_equal(a, s2.push(kps[t])["poses"])
        outs.append(a)
    # per frame: one push of all four frames draws the same seeds
    many = serve.StreamingSession(svc, seed=9, per_frame_noise=True)
    np.testing.assert_allclose(many.push(kps)["poses"],
                               np.concatenate(outs), atol=2e-5)


def test_window_seeds_keying():
    s = serve.LiftingService._window_seeds
    a = s(4, seed=1)
    assert a.dtype == np.uint32 and a.shape == (4,)
    assert len(set(a.tolist())) == 4           # distinct per window
    np.testing.assert_array_equal(a, s(4, seed=1))
    assert set(s(4, seed=2).tolist()) != set(a.tolist())
    np.testing.assert_array_equal(s(2, seed=1, base=2), a[2:])
    assert s(4, seed=1, salt=serve.STREAM_SALT).tolist() != a.tolist()


def test_invalid_noise_mode():
    with pytest.raises(ValueError, match="noise_mode"):
        serve.LiftingService(None, None, noise_mode="banana", device="cpu")


# -- mean readback ------------------------------------------------------------

def test_mean_readback_matches_host_mean(service, mean_readback_service):
    rng = np.random.RandomState(3)
    for frames in (5, 20):  # sub-window and multi-window requests
        kps = rng.randn(frames, 134, 2).astype(np.float32)
        ref = service.lift(kps, seed=7)["poses"]
        got = mean_readback_service.lift(kps, seed=7)["poses"]
        assert got.shape == (frames, 134, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    kps = rng.randn(12, 134, 2).astype(np.float32)
    np.testing.assert_allclose(
        mean_readback_service.lift(kps, seed=2, world=True)["poses"],
        _world_mean(service, kps, seed=2), rtol=0, atol=1e-5)


def _world_mean(svc, kps, seed):
    """World-mode reference on an 'all' service: rotate, rebase against the
    floor of the hypothesis mean (a mean service sees only the mean)."""
    full = svc.lift(kps, seed=seed, all_hypotheses=True)["poses"].mean(axis=0)
    out = geometry.camera_to_world(torch.from_numpy(full), serve._WORLD_ROT,
                                   0.0).numpy()
    out[..., 2] -= out[..., 2].min()
    return out


def test_mean_readback_rejects_all_hypotheses(mean_readback_service):
    kps = np.zeros((5, 134, 2), np.float32)
    with pytest.raises(ValueError, match="all_hypotheses"):
        mean_readback_service.lift(kps, all_hypotheses=True)
    with pytest.raises(ValueError, match="all_hypotheses"):
        serve.StreamingSession(mean_readback_service, all_hypotheses=True)
    with pytest.raises(ValueError, match="readback"):
        serve.LiftingService(None, None, readback="median", device="cpu")


def test_mean_readback_streaming_and_health(service, mean_readback_service):
    svc = mean_readback_service
    kps = np.random.RandomState(4).randn(4, 134, 2).astype(np.float32)
    s_mean = serve.StreamingSession(svc, seed=9)
    s_all = serve.StreamingSession(service, seed=9)
    for t in range(4):
        a = s_mean.push(kps[t])["poses"]
        assert a.shape == (1, 134, 3)
        np.testing.assert_allclose(a, s_all.push(kps[t])["poses"], rtol=0,
                                   atol=1e-5)
    assert svc.health()["readback"] == "mean"
    assert service.health()["readback"] == "all"


def test_fast_path_device_noise_mean_readback(service):
    """Device noise with mean readback == the device-noise service's host
    mean."""
    svc_all = serve.LiftingService(service.model, buckets=(1, 2),
                                   noise_mode="device", device="cpu")
    svc_fast = serve.LiftingService(service.model, buckets=(1, 2),
                                    noise_mode="device", readback="mean",
                                    device="cpu")
    try:
        kps = np.random.RandomState(21).randn(12, 134, 2).astype(np.float32)
        np.testing.assert_allclose(svc_fast.lift(kps, seed=4)["poses"],
                                   svc_all.lift(kps, seed=4)["poses"],
                                   rtol=0, atol=1e-5)
        assert svc_fast.health()["noise_mode"] == "device"
        assert svc_fast.health()["readback"] == "mean"
    finally:
        svc_all.close()
        svc_fast.close()


# -- op-point tiers -----------------------------------------------------------

def test_op_point_normalization_and_validation(service, tiered_service):
    assert tiered_service.op_points == ((2, 2), (1, 1))   # deduplicated
    assert tiered_service.default_op_point == (2, 2)
    assert tiered_service.health()["op_points"] == ["2x2", "1x1"]
    assert set(tiered_service._batchers) == {(2, 2), (1, 1)}
    assert service.op_points == ((2, 2),)   # the model config's (P, T)
    with pytest.raises(ValueError, match="not served"):
        tiered_service.lift(np.zeros((5, 134, 2), np.float32),
                            op_point="3x1")
    with pytest.raises(ValueError, match=">= 1"):
        serve.LiftingService(service.model, op_points=[(0, 1)],
                             device="cpu")


def test_tier_matches_dedicated_service(service, tiered_service):
    """A tier produces what a service of that op point alone produces, on
    the same weights; the default tier matches the single-tier service."""
    kps = np.random.RandomState(11).randn(12, 134, 2).astype(np.float32)
    ref_default = service.lift(kps, seed=3)
    got_default = tiered_service.lift(kps, seed=3)
    np.testing.assert_allclose(got_default["poses"], ref_default["poses"],
                               rtol=0, atol=1e-6)
    assert got_default["num_hypotheses"] == 2

    model11 = D3DP(dataclasses.replace(TINY, num_proposals=1,
                                       sampling_timesteps=1), device="cpu")
    svc11 = serve.LiftingService(
        model11, service.model.pose_estimator.state_dict(), buckets=(1, 2),
        device="cpu")
    try:
        ref_11 = svc11.lift(kps, seed=3)
        got_11 = tiered_service.lift(kps, seed=3, op_point="1x1")
        np.testing.assert_allclose(got_11["poses"], ref_11["poses"],
                                   rtol=0, atol=1e-6)
        assert got_11["num_hypotheses"] == 1
    finally:
        svc11.close()
    assert np.abs(got_11["poses"] - got_default["poses"]).max() > 0


def test_tiers_do_not_mix_under_concurrency(tiered_service):
    """Concurrent requests at two tiers co-batch only within their tier and
    reproduce the sequential results."""
    rng = np.random.RandomState(12)
    kps = [rng.randn(9, 134, 2).astype(np.float32) for _ in range(6)]
    pts = [None, "1x1"] * 3
    seq = [tiered_service.lift(k, seed=i, op_point=p)["poses"]
           for i, (k, p) in enumerate(zip(kps, pts))]
    with cf.ThreadPoolExecutor(6) as ex:
        futs = [ex.submit(tiered_service.lift, kps[t], seed=t,
                          op_point=pts[t]) for t in range(6)]
        conc = [f.result(timeout=300)["poses"] for f in futs]
    for s, c in zip(seq, conc):
        np.testing.assert_allclose(c, s, rtol=0, atol=2e-5)


def test_streaming_op_point(tiered_service):
    kps = np.random.RandomState(13).randn(3, 134, 2).astype(np.float32)
    s = serve.StreamingSession(tiered_service, seed=5, op_point=(1, 1))
    out = s.push(kps)
    assert out["poses"].shape == (3, 134, 3)
    assert out["num_hypotheses"] == 1
    with pytest.raises(ValueError, match="not served"):
        serve.StreamingSession(tiered_service, op_point="9x9")
