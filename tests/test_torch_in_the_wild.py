"""The port's in-the-wild CLI (pafuse_tpu_torch.cli.in_the_wild) against
the JAX package's on the CPU, twins of tests/test_e2e.py's in-the-wild
tests: keypoint loading, ``lift_video`` (the H3WB part-based model at its
published widths, depth 1, 9 frames, 20 diffusion steps, P=2, T=2),
``lift_video`` with one injected noise table against JAX's on carried
weights, and the whole CLI's files.

Bound: poses 1e-4 max abs (metres, O(1) values): the denoisers agree to
~1e-6 per call and DDIM feeds each step back a few-fold
(tests/test_torch_diffusion.py); the world coordinates are one rotation
of those poses.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from pafuse_tpu import config as jcfg
from pafuse_tpu import geometry as jgeometry
from pafuse_tpu.cli import in_the_wild as jax_itw
from pafuse_tpu.cli.main_h3wb import build_model as jax_build_model
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch import config as tcfg
from pafuse_tpu_torch.cli import in_the_wild
from pafuse_tpu_torch.cli.main_h3wb import build_model

torch.set_num_threads(2)

TOL = 1e-4
TINY = ["model.number_of_frames=9", "model.dep=1", "model.batch_size=18",
        "ft2d.timestep=20", "ft2d.sampling_timesteps=2",
        "ft2d.num_proposals=2"]


def _write_json(path, frames, seed=0, empty=()):
    rng = np.random.RandomState(seed)
    lines = []
    for f in range(frames):
        kp = np.column_stack([rng.uniform(100, 900, 133),
                              rng.uniform(100, 900, 133),
                              np.full(133, 0.9)]).ravel().tolist()
        preds = [] if f in empty else [{"keypoints": kp}]
        lines.append(json.dumps({"predictions": preds}))
    path.write_text("\n".join(lines) + "\n")


def test_keypoint_loading_matches_jax(tmp_path):
    path = tmp_path / "vid.mp4.openpifpaf.json"
    _write_json(path, 5, empty=(2,))
    got = in_the_wild.load_openpifpaf_keypoints(str(path))
    want = jax_itw.load_openpifpaf_keypoints(str(path))
    assert got.shape == (5, 134, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[:, 0], 0.5 * (got[:, 12] + got[:, 13]),
                               atol=1e-6)
    assert not got[2].any()


@pytest.fixture(scope="module")
def models():
    """The JAX and the port's H3WB model (P=2, T=2) on the same weights."""
    jm = jax_build_model(jcfg.parse_cli(TINY), is_train=False,
                         num_proposals=2, sampling_timesteps=2)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(tcfg.parse_cli(TINY + ["gpu.device=cpu"]), "cpu")
    pm.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                      strict=True)
    return jm, params, pm


def test_lift_video_shape(models):
    _, _, pm = models
    kp = np.random.RandomState(0).randn(23, 134, 2).astype(np.float32)
    out = in_the_wild.lift_video(tcfg.parse_cli(TINY), kp, pm)
    assert out.shape == (2, 2, 23, 134, 3)
    assert np.all(np.isfinite(out))


def test_lift_video_with_injected_noise_matches_jax(models, monkeypatch):
    """23 frames = 3 windows, chunks of 18 // 9 = 2 windows: a full chunk
    and a 1-window tail (JAX pads it to 2 rows, the port runs 1).  One
    noise table feeds both (JAX: jit off, the model object's sampler
    patched to take each chunk's rows); the camera-space poses and the
    world coordinates agree within 1e-4."""
    jm, params, pm = models
    r = np.random.RandomState(1)
    kp_px = r.uniform(100, 900, (23, 134, 2)).astype(np.float32)
    table = (r.randn(3, 2, 9, 134, 3).astype(np.float32),
             r.randn(3, 2, 2, 9, 134, 3).astype(np.float32))
    pred, world, kp = in_the_wild.lift_to_world(
        tcfg.parse_cli(TINY), kp_px, pm, 1000, 1002, noise_table=table)

    chunks = iter(range(0, 3, 2))

    def eval_forward(params, key, x2d, x2d_flip, **kw):
        lo = next(chunks)
        rows = np.minimum(np.arange(lo, lo + 2), 2)   # JAX's edge padding
        return jm.ddim_sample(params, key, x2d, x2d_flip,
                              init_noise=table[0][rows],
                              step_noise=np.moveaxis(table[1][rows], 1, 0),
                              **kw)

    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(jm, "eval_forward", eval_forward)
    want_kp = np.asarray(jgeometry.normalize_screen_coordinates(
        kp_px, w=1000, h=1002), np.float32)
    want = jax_itw.lift_video(jcfg.parse_cli(TINY), want_kp, params, jm)
    want_world = np.array(jgeometry.camera_to_world(
        want, in_the_wild.WORLD_ROTATION, 0.0))
    want_world[..., 2] -= want_world[..., 2].min()
    np.testing.assert_allclose(kp, want_kp, rtol=0, atol=1e-6)
    assert pred.shape == want.shape == (2, 2, 23, 134, 3)
    np.testing.assert_allclose(pred, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(world, want_world, rtol=0, atol=TOL)


def _cli_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_writes_the_files_of_the_jax_cli(tmp_path, monkeypatch):
    """OpenPifPaf JSON -> lifting -> the two .npy files -> per-frame renders
    -> animated gif (no video file: the keypoints-only backdrop); the same
    files as the JAX CLI writes for the same overrides."""
    _write_json(tmp_path / "vid.mp4.openpifpaf.json", 12)
    run = [f"in_the_wild.video_path={tmp_path}/vid.mp4", "viz.viz_limit=2",
           "viz.viz_output=anim.gif", "viz.viz_downsample=2"] + TINY
    for side, main in (("port", in_the_wild.main), ("jax", jax_itw.main)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        main(run + (["gpu.device=cpu"] if side == "port" else []))
    out = tmp_path / "port" / "outputs" / "vid"
    assert np.load(out / "test_3d_vid_output.npy").shape == (2, 2, 12, 134, 3)
    world = np.load(out / "test_3d_output_vid_postprocess.npy")
    assert world.shape == (2, 2, 12, 134, 3) and world[..., 2].min() == 0.0
    assert list(out.glob("frame*_t*.png"))
    assert (out / "anim.gif").stat().st_size > 0
    assert _cli_files(tmp_path / "port") == _cli_files(tmp_path / "jax")


def test_cli_with_checkpoint(tmp_path, monkeypatch):
    """The checkpoint branch: a port ``save_state`` .npz loads and the
    pipeline runs to its files."""
    args = tcfg.parse_cli(TINY + ["gpu.device=cpu"])
    model = build_model(args, "cpu")
    checkpoints.save_state(str(tmp_path / "ckpt"), "tiny", model=model)
    _write_json(tmp_path / "vid.mp4.openpifpaf.json", 12, seed=2)
    monkeypatch.chdir(tmp_path)
    in_the_wild.main([f"in_the_wild.video_path={tmp_path}/vid.mp4",
                      f"general.checkpoint={tmp_path}/ckpt",
                      "general.evaluate=tiny.npz", "viz.viz_limit=0",
                      "gpu.device=cpu"] + TINY)
    out = tmp_path / "outputs" / "vid"
    assert (out / "test_3d_vid_output.npy").exists()
    assert (out / "test_3d_output_vid_postprocess.npy").exists()
