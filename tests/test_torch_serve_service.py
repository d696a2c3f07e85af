"""The port's serving stack on the CPU: LiftingService with its dynamic
batcher, the HTTP server and ``cli/serve.py``.

Twins of the single-device cases of ``tests/test_serve.py``, on the port
alone (the JAX parity cases are in ``tests/test_torch_serve.py``).  Config:
depth 1, 9 frames, P=2, T=2, buckets (1, 2, 4), seeded weights.  Co-batched
or chunked rows run through matmuls with another row count, so they may
differ from a lone run at rounding level: 2e-5 max abs, as the JAX tests
bound it.
"""

import concurrent.futures as cf
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pafuse_tpu_torch import config as cfg_mod
from pafuse_tpu_torch import serve
from pafuse_tpu_torch.cli.serve import build_service
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = D3DPConfig(frames=9, num_kps=134, timesteps=20, sampling_timesteps=2,
                  num_proposals=2, depth=1)
TINY_ARGS = ["gpu.device=cpu", "model.number_of_frames=9", "model.dep=1",
             "ft2d.timestep=20", "ft2d.num_proposals=2",
             "ft2d.sampling_timesteps=2", "serve.buckets=[1,2]"]


def _model():
    return D3DP(TINY, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def service():
    svc = serve.LiftingService(_model(), buckets=(1, 2, 4), device="cpu")
    svc.warmup()
    yield svc
    svc.close()


def _serve_in_thread(svc, **kw):
    server = serve.make_http_server(svc, port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(base, path, payload, timeout=120):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_bucket_for():
    assert serve.bucket_for(1, (1, 4, 16)) == 1
    assert serve.bucket_for(3, (1, 4, 16)) == 4
    assert serve.bucket_for(4, (1, 4, 16)) == 4
    assert serve.bucket_for(17, (1, 4, 16)) == 16  # chunked at max bucket
    assert serve.bucket_for(2, (4,)) == 4
    with pytest.raises(ValueError):
        serve.LiftingService(None, None, buckets=(), device="cpu")


def test_lift_shapes_and_determinism(service):
    kps = np.random.RandomState(0).randn(20, 134, 2).astype(np.float32)
    out = service.lift(kps, seed=7)
    assert out["poses"].shape == (20, 134, 3)
    assert np.all(np.isfinite(out["poses"]))
    assert out["num_frames"] == 20 and out["num_hypotheses"] == 2
    np.testing.assert_array_equal(out["poses"],
                                  service.lift(kps, seed=7)["poses"])
    assert np.abs(out["poses"] - service.lift(kps, seed=8)["poses"]).max() > 0
    full = service.lift(kps, seed=7, all_hypotheses=True)
    assert full["poses"].shape == (2, 20, 134, 3)
    np.testing.assert_allclose(full["poses"].mean(axis=0), out["poses"],
                               rtol=0, atol=1e-6)


def test_lift_pixel_input_and_world(service):
    rng = np.random.RandomState(1)
    kps_px = (rng.rand(5, 134, 2) * [640, 480]).astype(np.float32)
    out = service.lift(kps_px, width=640, height=480, world=True,
                       all_hypotheses=True)
    assert out["poses"].shape == (2, 5, 134, 3)
    # floor rebase over all hypotheses, before their mean
    assert abs(float(out["poses"][..., 2].min())) < 1e-6


def test_lift_chunking_matches_single_bucket(service):
    """6 windows in chunks of the max bucket 4 == one 6-window chunk."""
    kps = np.random.RandomState(2).randn(9 * 6, 134, 2).astype(np.float32)
    out = service.lift(kps, seed=3)
    big = serve.LiftingService(service.model, buckets=(6,), device="cpu")
    try:
        np.testing.assert_allclose(out["poses"],
                                   big.lift(kps, seed=3)["poses"], atol=2e-5)
    finally:
        big.close()


def test_lift_input_validation(service):
    errors = service.health()["errors"]
    with pytest.raises(ValueError):
        service.lift(np.zeros((5, 134, 3), np.float32))  # not 2D keypoints
    with pytest.raises(ValueError):
        service.lift(np.zeros((5, 17, 2), np.float32))   # wrong joint count
    with pytest.raises(ValueError):
        service.lift(np.zeros((0, 134, 2), np.float32))  # zero frames
    with pytest.raises(ValueError):
        service.lift(np.zeros((5, 134, 2), np.float32), width=640)
    small = serve.LiftingService(service.model, buckets=(1,), max_frames=10,
                                 device="cpu")
    try:
        with pytest.raises(ValueError, match="max_frames"):
            small.lift(np.zeros((11, 134, 2), np.float32))
    finally:
        small.close()
    health = service.health()
    assert health["status"] == "ok"
    assert health["errors"] == errors  # validation rejects before the lift


def test_http_server(service):
    server, thread, base = _serve_in_thread(service)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["buckets"] == [1, 2, 4]
        assert health["device"] == "cpu" and health["mesh_devices"] == 1

        kps = np.zeros((3, 134, 2), np.float32).tolist()
        out = _post(base, "/lift", {"keypoints": kps, "width": 640,
                                    "height": 480, "seed": 1})
        assert out["shape"] == [3, 134, 3]
        poses = np.asarray(out["poses"], np.float32)
        assert poses.shape == (3, 134, 3) and np.all(np.isfinite(poses))

        for bad in ({"keypoints": 1}, {"nope": 1}):   # malformed -> 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/lift", bad, timeout=30)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404

        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["requests"] >= 1
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            metrics = r.read().decode()
        assert "# TYPE pafuse_requests counter" in metrics
        assert f"pafuse_requests {health['requests']}" in metrics
        assert "# TYPE pafuse_busy_seconds gauge" in metrics
        assert "pafuse_mesh_devices 1" in metrics
        assert "pafuse_dynamic_batching" not in metrics   # booleans skipped
    finally:
        _stop(server, thread)


def test_dynamic_batcher_coalesces_and_matches(service):
    """Queued requests are concatenated into ONE sampler call and each gets
    exactly its own rows back (the values of a direct run)."""
    rng = np.random.RandomState(5)
    reqs = [service._request_arrays(
                rng.randn(w, 9, 134, 2).astype(np.float32),
                rng.randn(w, 9, 134, 2).astype(np.float32), seed=i)
            for i, w in enumerate([1, 2, 1])]
    direct = [service._device_run(*r) for r in reqs]

    calls0 = service.stats["batch_calls"]
    b = serve._DynamicBatcher(service, autostart=False)
    futures = [b.submit(r) for r in reqs]     # all queued before dispatch
    b._thread.start()
    try:
        outs = [f.result(timeout=120) for f in futures]
    finally:
        b.stop()
        b._thread.join(timeout=60)
    assert not b._thread.is_alive()
    assert service.stats["batch_calls"] == calls0 + 1   # one coalesced call
    for out, ref in zip(outs, direct):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=2e-5)
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(reqs[0])


def test_device_dispatch_returns_valid_rows(service):
    """Nothing is padded: ``_device_dispatch`` returns the pending readback
    of exactly the rows given, equal to the chunked path's; rows beyond the
    largest bucket are refused."""
    rng = np.random.RandomState(11)
    for n in (1, 3, 4):
        arrs = service._request_arrays(
            rng.randn(n, 9, 134, 2).astype(np.float32),
            rng.randn(n, 9, 134, 2).astype(np.float32), seed=n)
        out = service._device_dispatch(*arrs).numpy()
        assert out.shape == (n, 2, 9, 134, 3)
        np.testing.assert_array_equal(out, service._device_run(*arrs))
    big = np.zeros((5, 9, 134, 2), np.float32)
    with pytest.raises(ValueError, match="largest bucket"):
        service._device_dispatch(*service._request_arrays(big, big, seed=0))


def test_concurrent_lifts_match_sequential(service):
    """Racing lift() calls through the service's batcher return the poses
    of sequential calls (co-batching changes the row count only)."""
    assert service.health()["dynamic_batching"] is True
    rng = np.random.RandomState(6)
    kps = [rng.randn(9 * w, 134, 2).astype(np.float32) for w in (1, 2, 1, 3)]
    seq = [service.lift(k, seed=i)["poses"] for i, k in enumerate(kps)]
    with cf.ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(service.lift, k, seed=i) for i, k in enumerate(kps)]
        par = [f.result(timeout=300)["poses"] for f in futs]
    for a, b in zip(seq, par):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_failed_batch_fails_every_future_and_http_500(service, monkeypatch):
    """An exception on the dispatch thread reaches every co-batched
    request's future, and over HTTP a 500; the server stays up."""
    svc = serve.LiftingService(service.model, buckets=(1, 2, 4),
                               device="cpu")

    def boom(*a, **k):
        raise RuntimeError("kernel exploded")
    monkeypatch.setattr(svc, "_call_chunk", boom)
    server, thread, base = _serve_in_thread(svc)
    try:
        x = np.zeros((1, 9, 134, 2), np.float32)
        b = svc._batchers[svc.default_op_point]
        futures = [b.submit(svc._request_arrays(x, x, seed=i))
                   for i in range(3)]
        for f in futures:
            with pytest.raises(RuntimeError, match="exploded"):
                f.result(timeout=120)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/lift", {"keypoints": np.zeros((3, 134, 2)).tolist()})
        assert ei.value.code == 500
        assert "kernel exploded" in json.loads(ei.value.read())["error"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["errors"] == 1
    finally:
        _stop(server, thread)
        svc.close()


def test_build_service_from_config():
    """CLI-level construction: config -> model -> service (no checkpoint)."""
    svc = build_service(cfg_mod.load_config(overrides=TINY_ARGS
                                            + ["serve.shard=off"]),
                        warmup=False)
    try:
        assert svc.buckets == (1, 2) and svc.device.type == "cpu"
        assert svc.health()["dynamic_batching"] is True  # serve.batching
        assert svc.max_frames == 100_000                 # serve.max_frames
        assert svc.readback == "all" and svc.noise_mode == "host"
        assert svc.op_points == ((2, 2),)                # ft2d's P and T
        assert svc.health()["mesh_devices"] == 1
        out = svc.lift(np.zeros((4, 134, 2), np.float32))
        assert out["poses"].shape == (4, 134, 3)
    finally:
        svc.close()

    mean = build_service(cfg_mod.load_config(overrides=TINY_ARGS + [
        "serve.readback=mean", "serve.noise=device",
        "serve.op_points=['2x2', '1x1']", "serve.max_frames=50"]),
        warmup=False)
    try:
        assert mean.readback == "mean" and mean.noise_mode == "device"
        assert mean.op_points == ((2, 2), (1, 1)) and mean.max_frames == 50
    finally:
        mean.close()

    off = build_service(cfg_mod.load_config(overrides=TINY_ARGS + [
        "serve.batching=off"]), warmup=False)   # YAML's bare off
    assert off.health()["dynamic_batching"] is False
    assert off.lift(np.zeros((4, 134, 2), np.float32))["poses"].shape == (
        4, 134, 3)

    with pytest.raises(ValueError, match="serve.shard"):
        build_service(cfg_mod.load_config(overrides=TINY_ARGS + [
            "serve.shard=mesh"]), warmup=False)


def test_build_service_loads_the_checkpoint(tmp_path):
    """``general.evaluate`` names a save_state checkpoint whose weights the
    service then serves."""
    from pafuse_tpu_torch import checkpoints
    src = _model()
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    checkpoints.save_state(str(tmp_path), "best", model=src, epoch=3,
                           lr=1e-4)
    svc = build_service(cfg_mod.load_config(overrides=TINY_ARGS + [
        f"general.checkpoint={tmp_path}", "general.evaluate=best.npz"]),
        warmup=False)
    try:
        got = dict(svc.model.pose_estimator.named_parameters())
        for name, p in src.pose_estimator.named_parameters():
            torch.testing.assert_close(got[name], p, rtol=0, atol=0)
    finally:
        svc.close()


def test_build_service_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the CPU-only refusal cannot be shown")
    args = cfg_mod.load_config(overrides=TINY_ARGS[1:])   # gpu.device=cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_service(args, warmup=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.LiftingService(_model(), buckets=(1,))      # device="cuda"


def test_params_are_on_the_service_device_once(service):
    """Weights given as a state dict are loaded once into the model on the
    service's device; requests never move them again and match a service
    built from the same weights in place."""
    sd = {k: v.clone() for k, v in service.model.pose_estimator.state_dict()
          .items()}
    svc2 = serve.LiftingService(_model(), sd, buckets=(1, 2), device="cpu")
    try:
        params = list(svc2.model.parameters())
        assert all(p.device == svc2.device for p in params)
        ptrs = [p.data_ptr() for p in params]
        kps = np.random.RandomState(3).rand(5, 134, 2).astype(np.float32)
        a = service.lift(kps, seed=7)["poses"]
        b = svc2.lift(kps, seed=7)["poses"]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert [p.data_ptr() for p in svc2.model.parameters()] == ptrs
    finally:
        svc2.close()


def test_cli_serve_main_answers_http(tmp_path):
    """``python -m pafuse_tpu_torch.cli.serve gpu.device=cpu ...`` warms up,
    listens, and answers /healthz, /lift, a /stream round trip and
    /metrics."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pafuse_tpu_torch.cli.serve", *TINY_ARGS,
         "serve.port=0"], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                break
        assert "listening on" in lines[-1], "".join(lines)
        assert any("no checkpoint" in line for line in lines)
        base = lines[-1].split()[3]            # http://127.0.0.1:<port>
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.loads(r.read())["device"] == "cpu"
        out = _post(base, "/lift",
                    {"keypoints": np.zeros((4, 134, 2)).tolist(), "seed": 2})
        assert out["shape"] == [4, 134, 3]
        sid = _post(base, "/stream", {"seed": 1})["session"]
        out = _post(base, f"/stream/{sid}",
                    {"keypoints": np.zeros((2, 134, 2)).tolist()})
        assert out["shape"] == [2, 134, 3] and out["frame_indices"] == [0, 1]
        req = urllib.request.Request(f"{base}/stream/{sid}", method="DELETE")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == {"closed": True, "frames": 2}
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        assert "pafuse_requests 1" in metrics
        assert "pafuse_stream_frames 2" in metrics
    finally:
        proc.kill()
        proc.communicate(timeout=60)
