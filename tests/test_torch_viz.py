"""The port's rendering (pafuse_tpu_torch.viz) and draw CLI
(pafuse_tpu_torch.cli.draw_h3wb) on the CPU, twins of tests/test_viz.py:
the limb table against the JAX package's, the draw functions, the
animation, and the draw CLI's files against the JAX CLI's for the same
overrides (the H3WB model at depth 1, 9 frames, 20 diffusion steps, P=2,
T=1, on synthetic S8)."""

import os

import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use("Agg")

from pafuse_tpu import viz as jax_viz
from pafuse_tpu.cli import draw_h3wb as jax_draw
from pafuse_tpu_torch import config as tcfg
from pafuse_tpu_torch import skeleton as sk
from pafuse_tpu_torch import viz
from pafuse_tpu_torch.cli import draw_h3wb
from pafuse_tpu_torch.cli.main_h3wb import build_model
from pafuse_tpu_torch.data import h3wb

torch.set_num_threads(2)

DRAW = ["data.synthetic=true", "model.number_of_frames=9", "model.dep=1",
        "ft2d.timestep=20", "ft2d.sampling_timesteps=1",
        "ft2d.num_proposals=2", "viz.viz_subject=S8",
        "viz.viz_action=Walking"]


def test_limb_table_matches_jax():
    assert viz.LIMBS == jax_viz.LIMBS
    assert viz.PART_COLORS == jax_viz.PART_COLORS
    # every joint with a parent has a bone; face joints are dots
    assert {c for c, _, _ in viz.LIMBS} == {
        j for j in range(sk.NUM_JOINTS) if sk.PARENTS[j] >= 0}


def test_draw_3d_image(tmp_path):
    rng = np.random.RandomState(0)
    preds = rng.randn(2, 3, 2, 134, 3).astype(np.float32)  # (S,H,F,J,3)
    gt = rng.randn(2, 134, 3).astype(np.float32)
    viz.draw_3d_image(preds, gt, str(tmp_path), max_frames=1)
    assert sorted(os.listdir(tmp_path)) == ["frame0_t0.png", "frame0_t1.png"]


def test_draw_3d_image_select(tmp_path):
    rng = np.random.RandomState(1)
    preds = rng.randn(1, 2, 2, 134, 3).astype(np.float32)
    sel = rng.randn(1, 2, 134, 3).astype(np.float32)
    gt = rng.randn(2, 134, 3).astype(np.float32)
    viz.draw_3d_image_select(preds, sel, gt, str(tmp_path), max_frames=1)
    assert os.listdir(tmp_path) == ["select_f0_t0.png"]


def test_draw_3d_image_hypotheses(tmp_path):
    rng = np.random.RandomState(3)
    preds = rng.randn(2, 4, 7, 134, 3).astype(np.float32)
    gt = rng.randn(7, 134, 3).astype(np.float32)
    viz.draw_3d_image_hypotheses(preds, gt, str(tmp_path), frame_skip=5)
    # the last step only, frames 0 and 5
    assert sorted(os.listdir(tmp_path)) == ["hyp_f0_t1.png", "hyp_f5_t1.png"]
    viz.draw_3d_image_hypotheses(preds, gt, str(tmp_path), frame_skip=5,
                                 steps="all", prefix="all_", show_gt=False)
    assert (tmp_path / "all_hyp_f0_t0.png").exists()
    assert (tmp_path / "all_hyp_f5_t1.png").exists()


@pytest.mark.parametrize("backdrop", [False, True])
def test_render_animation(tmp_path, backdrop):
    rng = np.random.RandomState(4)
    poses = {"Ours": rng.randn(6, 134, 3).astype(np.float32)}
    kw = {}
    if backdrop:
        frames = [np.full((20, 20, 3), i * 20, np.uint8) for i in range(10)]
        kw = dict(keypoints_2d=rng.rand(6, 134, 2).astype(np.float32) * 100,
                  viewport=(100, 100), input_video_frames=frames,
                  input_video_skip=2, downsample=2)
    out = viz.render_animation(poses, fps=10,
                               output=str(tmp_path / "anim.gif"), size=3, **kw)
    assert out == str(tmp_path / "anim.gif")
    assert os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="Unsupported"):
        viz.render_animation(poses, fps=10, output=str(tmp_path / "a.avi"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_draw_cli_writes_the_files_of_the_jax_cli(tmp_path, monkeypatch):
    """viz.viz_limit=6 and viz.viz_downsample=2: selected renders on even
    frames, hypothesis renders every 10th, the export of the stitched
    hypotheses; the same files as the JAX CLI writes."""
    run = DRAW + ["viz.viz_limit=6", "viz.viz_downsample=2",
                  "viz.viz_export=preds.npy"]
    for side, main in (("port", draw_h3wb.main), ("jax", jax_draw.main)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        main(run + (["gpu.device=cpu"] if side == "port" else []))
    port = tmp_path / "port"
    assert np.load(port / "preds.npy").shape == (1, 2, 6, 134, 3)
    sel = sorted(p.name for p in (port / "plot").rglob("select_f*.png"))
    assert sel == ["select_f0_t0.png", "select_f2_t0.png", "select_f4_t0.png"]
    assert list((port / "plot").rglob("hyp_f0_t0.png"))
    assert _files(port) == _files(tmp_path / "jax")


def test_draw_poses_selects_the_nearest_reprojection():
    """draw_poses on synthetic S8: the stitched hypotheses carry the
    ground-truth trajectory, each selected joint is the hypothesis whose
    reprojection lies nearest the 2D input, and the world coordinates are
    the camera's rotation and translation of the camera-space poses."""
    from pafuse_tpu_torch import geometry
    args = tcfg.parse_cli(DRAW + ["gpu.device=cpu", "ft2d.num_proposals=3",
                                  "ft2d.sampling_timesteps=2"])
    dataset = h3wb.make_synthetic(subjects=("S8",), actions_per_subject=1,
                                  frames_per_action=20)
    keypoints = h3wb.prepare_data(dataset)
    model = build_model(args, "cpu", flip_permutation=dataset.flip_permutation)
    out = draw_h3wb.draw_poses(args, model, dataset, keypoints, "S8",
                               "Walking 1", 1)
    stitched, selected = out["stitched"], out["selected"]
    assert stitched.shape == (2, 3, 20, 134, 3)
    assert selected.shape == (2, 20, 134, 3)
    cam = dataset.cameras()["S8"][1]
    seq_2d = keypoints["S8"]["Walking 1"][1]
    reproj = geometry.project_to_2d_np(
        stitched.reshape(-1, 134, 3),
        np.tile(cam["intrinsic"][None], (2 * 3 * 20, 1))).reshape(
            2, 3, 20, 134, 2)
    err = np.linalg.norm(reproj - seq_2d, axis=-1)
    picked = np.take_along_axis(err, err.argmin(axis=1)[:, None], axis=1)
    assert np.all(picked[:, 0] == err.min(axis=1))
    assert np.all(np.any(np.all(selected[:, None] == stitched, axis=-1),
                         axis=1))
    gt_world = geometry.qrot_np(
        cam["orientation"],
        dataset["S8"]["Walking 1"]["positions_3d"][1]) + cam["translation"]
    np.testing.assert_allclose(out["gt_world"], gt_world, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dataset["S8"]["Walking 1"]["positions"] / 1000,
                               out["gt_world"], rtol=0, atol=1e-4)


def test_draw_poses_with_injected_noise_matches_jax(tmp_path, monkeypatch):
    """draw_poses against the JAX draw CLI's compute on synthetic S8
    (23 frames = 3 windows, P=2, T=2) with one noise table and the same
    weights (JAX: jit off, the model object's sampler patched to take the
    table; its arrays caught at the render calls, the export and
    camera_to_world): the stitched hypotheses, the J-Agg pick and the
    world coordinates agree within 1e-4 (metres)."""
    import jax
    from pafuse_tpu import geometry as jax_geometry
    from pafuse_tpu.cli import main_h3wb as jax_main_h3wb
    from pafuse_tpu_torch import checkpoints

    run = DRAW + ["ft2d.sampling_timesteps=2", "viz.viz_limit=23",
                  f"viz.viz_export={tmp_path}/preds.npy"]
    r = np.random.RandomState(5)
    table = (r.randn(3, 2, 9, 134, 3).astype(np.float32),
             r.randn(3, 2, 2, 9, 134, 3).astype(np.float32))
    built, seen = {}, {"to_world": []}
    real_build, real_to_world = (jax_main_h3wb.build_model,
                                 jax_geometry.camera_to_world)

    def build(*a, **kw):
        jm = built["model"] = real_build(*a, **kw)
        jm.eval_forward = lambda params, key, x2d, x2d_flip: jm.ddim_sample(
            params, key, x2d, x2d_flip, init_noise=table[0],
            step_noise=np.moveaxis(table[1], 1, 0))
        return jm

    def to_world(x, R, t):
        seen["to_world"].append(np.asarray(x))
        return real_to_world(x, R, t)

    def select(hyp_world, sel_world, gt_world, *a, **kw):
        seen.update(hyp_world=hyp_world, sel_world=sel_world,
                    gt_world=gt_world)

    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(jax_main_h3wb, "build_model", build)
    monkeypatch.setattr(jax_geometry, "camera_to_world", to_world)
    monkeypatch.setattr(jax_viz, "draw_3d_image_select", select)
    monkeypatch.setattr(jax_viz, "draw_3d_image_hypotheses",
                        lambda *a, **kw: None)
    monkeypatch.chdir(tmp_path)
    jax_draw.main(run)

    args = tcfg.parse_cli(run + ["gpu.device=cpu"])
    dataset = h3wb.load_dataset(args.data.data_dir, True)
    model = build_model(args, "cpu", flip_permutation=dataset.flip_permutation)
    params = jax.device_get(built["model"].init_params(jax.random.PRNGKey(0)))
    model.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                         strict=True)
    got = draw_h3wb.draw_poses(args, model, dataset, h3wb.prepare_data(dataset),
                               "S8", "Walking 1", 0, noise_table=table)
    want = {"stitched": np.load(tmp_path / "preds.npy"),
            "selected": seen["to_world"][0],
            **{k: np.asarray(seen[k])
               for k in ("hyp_world", "sel_world", "gt_world")}}
    assert got["stitched"].shape == (2, 2, 23, 134, 3)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4, err_msg=k)


def test_draw_cli_refuses_compare():
    with pytest.raises(ValueError, match="viz.compare"):
        draw_h3wb.main(DRAW + ["viz.compare=true", "gpu.device=cpu"])
