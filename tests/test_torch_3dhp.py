"""The port's 3DHP family (pafuse_tpu_torch.data.dhp3, cli.main_3dhp and
the monolithic millimetre-scale D3DP) against the JAX package on the CPU
at a tiny size: depth 1, 9 frames, 20 diffusion steps, ``model.cs`` 32 or
64, weights carried across by ``checkpoints.params_from_jax``.

Bounds: poses 1e-4 in metres, i.e. 0.1 mm after the x1000 of ``mm_scale``
(the denoisers agree to ~1e-6 per call in float32 and DDIM feeds each
step back a few-fold, as tests/test_torch_diffusion.py states); the
evaluation metrics (mm) within 1e-5 relative (means over ~10^3 joint
errors of poses that agree to ~1e-6 relative; the argmin over hypotheses
is taken on errors that agree as closely).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import checkpoints as jax_checkpoints
from pafuse_tpu import config as jcfg
from pafuse_tpu import diffusion as jdiff
from pafuse_tpu import skeleton as jsk
from pafuse_tpu.cli import main_3dhp as jax_main_3dhp
from pafuse_tpu.data import dhp3 as jax_dhp3
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch import config as tcfg
from pafuse_tpu_torch import skeleton as sk
from pafuse_tpu_torch.cli import main_3dhp
from pafuse_tpu_torch.data import dhp3
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

POSE_TOL = 1e-4                 # metres
METRIC_RTOL = 1e-5
F, P, T, J = 9, 2, 2, 17
KW = dict(frames=F, num_kps=J, timesteps=20, sampling_timesteps=T,
          num_proposals=P, depth=1, cs=32, part_based=False, mm_scale=True)
TINY = ["data.synthetic=true", "model.number_of_frames=9",
        "model.batch_size=18", "model.dep=1", "model.cs=32",
        "ft2d.timestep=20", "ft2d.sampling_timesteps=1",
        "ft2d.num_proposals=1"]


def _pair(seed=0, **kw):
    """A JAX D3DP, its params (NumPy) and the port's D3DP with the same
    weights, on the CPU."""
    cfg = dict(KW, **kw)
    flip = (jsk.FLIP_PERMUTATION_3DHP if cfg["num_kps"] == J else None)
    jm = jdiff.D3DP(jdiff.D3DPConfig(**cfg), flip_permutation=flip)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(seed)))
    kw = {} if flip is None else dict(flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    pm = D3DP(D3DPConfig(**cfg), device="cpu", **kw)
    pm.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                      strict=True)
    return jm, params, pm


def _noise(r, B, N, H=P, S=T):
    return (r.randn(B, H, F, N, 3).astype(np.float32),
            r.randn(S, B, H, F, N, 3).astype(np.float32))


def _flipped(x2d, perm):
    out = x2d[..., perm, :].copy()
    out[..., 0] *= -1
    return out


def test_monolithic_mm_scale_sampler_reports_millimetres():
    """The repaired fault: a monolithic 134-joint D3DPConfig(mm_scale=True)
    samples in millimetres, as the JAX sampler does (the port returned
    metres before)."""
    jm, params, pm = _pair(seed=1, num_kps=134, cs=64)
    r = np.random.RandomState(2)
    x2d = r.uniform(-1, 1, (2, F, 134, 2)).astype(np.float32)
    init, step = _noise(r, 2, 134)
    x2d_flip = _flipped(x2d, sk.FLIP_PERMUTATION)
    want = np.asarray(jm.ddim_sample(
        params, jax.random.PRNGKey(0), jnp.asarray(x2d), jnp.asarray(x2d_flip),
        init_noise=init, step_noise=step))
    got = pm.ddim_sample(torch.from_numpy(x2d), torch.from_numpy(x2d_flip),
                         init_noise=torch.from_numpy(init),
                         step_noise=torch.from_numpy(step)).numpy()
    assert got.shape == want.shape == (2, T, P, F, 134, 3)
    assert np.abs(want).max() > 10.0          # millimetres, not metres
    np.testing.assert_allclose(got / 1000.0, want / 1000.0, rtol=0,
                               atol=POSE_TOL)


def test_flip_permutation_is_chosen_as_jax_does():
    for num_kps, want in ((134, jsk.FLIP_PERMUTATION),
                          (133, jsk.FLIP_PERMUTATION_NO_ROOT)):
        cfg = D3DPConfig(frames=F, num_kps=num_kps, depth=1, cs=32,
                         part_based=False)
        np.testing.assert_array_equal(D3DP(cfg, device="cpu").flip_permutation,
                                      want)
    cfg = D3DPConfig(frames=F, num_kps=J, depth=1, cs=32, part_based=False)
    with pytest.raises(ValueError, match="No flip permutation"):
        D3DP(cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        D3DP(cfg, device="cpu", flip_permutation=np.arange(J + 1))
    model = D3DP(cfg, device="cpu", flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    np.testing.assert_array_equal(model.flip_permutation,
                                  jsk.FLIP_PERMUTATION_3DHP)
    # the part-based model keeps the 134-joint layout
    with pytest.raises(ValueError, match="134-joint"):
        D3DP(D3DPConfig(frames=F, num_kps=J, depth=1), device="cpu",
             flip_permutation=sk.FLIP_PERMUTATION_3DHP)


def test_skeleton_tables_match_jax():
    np.testing.assert_array_equal(sk.PARENTS, jsk.PARENTS)
    np.testing.assert_array_equal(sk.FLIP_PERMUTATION_NO_ROOT,
                                  jsk.FLIP_PERMUTATION_NO_ROOT)
    assert sk.NUM_JOINTS_3DHP == jsk.NUM_JOINTS_3DHP == J
    assert sk.JOINTS_LEFT_3DHP == jsk.JOINTS_LEFT_3DHP
    assert sk.JOINTS_RIGHT_3DHP == jsk.JOINTS_RIGHT_3DHP
    np.testing.assert_array_equal(sk.FLIP_PERMUTATION_3DHP,
                                  jsk.FLIP_PERMUTATION_3DHP)
    assert sk.FLIP_PERMUTATION_3DHP.dtype == np.int32


@pytest.mark.parametrize("kw", [{}, dict(num_train_seqs=4, num_test_seqs=3,
                                         frames=50, seed=7)])
def test_make_synthetic_is_bit_equal_to_jax(kw):
    for ours, theirs in zip(dhp3.make_synthetic(**kw),
                            jax_dhp3.make_synthetic(**kw)):
        assert list(ours) == list(theirs)
        for key in theirs:
            assert ours[key].keys() == theirs[key].keys()
            for name, want in theirs[key].items():
                assert ours[key][name].dtype == want.dtype
                np.testing.assert_array_equal(ours[key][name], want)


def test_load_dataset_reads_the_real_npz_layout_as_jax_does(tmp_path):
    r = np.random.RandomState(0)

    def seq(frames):
        return {"data_2d": r.randn(frames, J, 2),
                "data_3d": r.randn(frames, J, 3) * 100}

    train = {("S1", "Seq1"): {0: seq(5), 2: seq(4)},
             ("S2", "Seq2"): {1: seq(6)}}
    test = {"TS1": dict(seq(5), valid=r.rand(5) > 0.3),
            "TS2": dict(seq(3), valid_frame=(r.rand(1, 3) > 0.3)[None])}
    for name, data in (("data_train_3dhp.npz", train),
                       ("data_test_3dhp.npz", test)):
        np.savez(tmp_path / name, data=np.array(data, dtype=object))
    ours = dhp3.load_dataset(str(tmp_path), "auto")
    theirs = jax_dhp3.load_dataset(str(tmp_path), "auto")
    assert list(ours[0]) == list(theirs[0]) == [
        ("S1", "Seq1_cam0"), ("S1", "Seq1_cam2"), ("S2", "Seq2_cam1")]
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for key in b:
            for name in b[key]:
                assert a[key][name].dtype == b[key][name].dtype
                np.testing.assert_array_equal(a[key][name], b[key][name])
    assert ours[1]["TS2"]["valid"].shape == (3,)
    p3, p2 = dhp3.train_arrays(ours[0])
    assert [a.shape for a in p3] == [(5, J, 3), (4, J, 3), (6, J, 3)]
    assert [a.shape for a in p2] == [(5, J, 2), (4, J, 2), (6, J, 2)]
    with pytest.raises(FileNotFoundError):
        dhp3.load_dataset(str(tmp_path / "none"), False)


@pytest.fixture(scope="module")
def dhp():
    return _pair(seed=3)


def test_train_forward_matches_jax(dhp):
    """mm in, mm out: the ground truth in mm is noised in metres and the
    prediction scaled back (drop-path 0, injected t and noise)."""
    jm, params, pm = dhp
    r = np.random.RandomState(4)
    B = 3
    x2d = r.uniform(-1, 1, (B, F, J, 2)).astype(np.float32)
    x3d = (r.randn(B, F, J, 3) * 300).astype(np.float32)
    t = np.array([0, 7, 19], np.int32)
    noise = r.randn(B, F, J, 3).astype(np.float32)
    want = np.asarray(jm.train_forward(params, jax.random.PRNGKey(0),
                                       jnp.asarray(x2d), jnp.asarray(x3d),
                                       t=jnp.asarray(t), noise=jnp.asarray(noise)))
    pm.train()
    try:
        got = pm.train_forward(torch.from_numpy(x2d), torch.from_numpy(x3d),
                               t=torch.from_numpy(t),
                               noise=torch.from_numpy(noise)).detach().numpy()
    finally:
        pm.eval()
    assert got.shape == (B, F, J, 3)
    np.testing.assert_allclose(got / 1000.0, want / 1000.0, rtol=0,
                               atol=POSE_TOL)


@pytest.mark.parametrize("flip", [True, False])
def test_ddim_sample_matches_jax(dhp, flip):
    jm, params, pm = dhp
    r = np.random.RandomState(5 + flip)
    x2d = r.uniform(-1, 1, (2, F, J, 2)).astype(np.float32)
    init, step = _noise(r, 2, J)
    x2d_flip = _flipped(x2d, sk.FLIP_PERMUTATION_3DHP) if flip else None
    want = np.asarray(jm.ddim_sample(
        params, jax.random.PRNGKey(0), jnp.asarray(x2d),
        None if x2d_flip is None else jnp.asarray(x2d_flip),
        init_noise=init, step_noise=step))
    got = pm.ddim_sample(
        torch.from_numpy(x2d),
        None if x2d_flip is None else torch.from_numpy(x2d_flip),
        init_noise=torch.from_numpy(init),
        step_noise=torch.from_numpy(step)).numpy()
    assert got.shape == (2, T, P, F, J, 3)
    assert np.abs(got).max() <= 1100.0 + 1e-3
    np.testing.assert_allclose(got / 1000.0, want / 1000.0, rtol=0,
                               atol=POSE_TOL)


def _jax_evaluate_with_noise(monkeypatch, jm, params, test, args, table,
                             **kw):
    """JAX ``evaluate_3dhp`` with the DDIM noise of ``table`` (port window
    order): jit off, and the model object's sampler patched to take each
    sequence's rows (its padded rows get zeros, which the mask ignores)."""
    init_tab, step_tab = table
    counts = [-(-v["data_2d"].shape[0] // F) for v in test.values()]
    bs = 1 << (max(counts) - 1).bit_length()
    offsets = iter(np.cumsum([0] + counts[:-1]))

    def eval_forward(params, key, x2d, x2d_flip, **sample_kw):
        lo = next(offsets)
        init = np.zeros((bs,) + init_tab.shape[1:], np.float32)
        step = np.zeros((bs,) + step_tab.shape[1:], np.float32)
        n = min(bs, init_tab.shape[0] - lo)
        init[:n], step[:n] = init_tab[lo:lo + n], step_tab[lo:lo + n]
        return jm.ddim_sample(params, key, x2d, x2d_flip,
                              init_noise=init,
                              step_noise=np.moveaxis(step, 1, 0), **sample_kw)

    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(jm, "eval_forward", eval_forward)
    return jax_main_3dhp.evaluate_3dhp(jm, params, test, args, **kw)


@pytest.mark.parametrize("window_batch", [64, 2])
def test_evaluate_3dhp_matches_jax(dhp, monkeypatch, window_batch):
    """Two test sequences of 25 frames (3 windows each; JAX pads them to 4,
    the port runs them unpadded, in calls of ``window_batch`` windows), P=2,
    T=2, one injected noise table: both metric vectors within 1e-5
    relative."""
    jm, params, pm = dhp
    _, test = dhp3.make_synthetic(num_train_seqs=0, num_test_seqs=2,
                                  frames=25, seed=8)
    overrides = ["model.number_of_frames=9"]
    r = np.random.RandomState(9)
    table = (r.randn(6, P, F, J, 3).astype(np.float32),
             r.randn(6, T, P, F, J, 3).astype(np.float32))
    timings = {}
    got = main_3dhp.evaluate_3dhp(
        pm, test, tcfg.parse_cli(overrides), num_proposals=P,
        sampling_timesteps=T, window_batch=window_batch, noise_table=table,
        timings=timings)
    assert timings["windows"] == 6
    want = _jax_evaluate_with_noise(monkeypatch, jm, params, test,
                                    jcfg.parse_cli(overrides), table,
                                    num_proposals=P, sampling_timesteps=T)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w) == (T,)
        assert np.all(np.isfinite(g)) and np.all(np.asarray(w) > 1.0)
        np.testing.assert_allclose(g, np.asarray(w), rtol=METRIC_RTOL)


def test_evaluate_3dhp_needs_eval_mode(dhp):
    _, _, pm = dhp
    _, test = dhp3.make_synthetic(num_train_seqs=0, frames=12)
    pm.train()
    try:
        with pytest.raises(RuntimeError, match="eval mode"):
            main_3dhp.evaluate_3dhp(pm, test, tcfg.parse_cli([]))
    finally:
        pm.eval()


def _numbers_masked(lines):
    return [re.sub(r"-?\d+\.\d+", "<x>", ln) for ln in lines]


def test_cli_train_then_evaluate(tmp_path, monkeypatch):
    """The twin of tests/test_3dhp.py::test_3dhp_cli_debug: one quick-debug
    epoch writes the report and an epoch_1 checkpoint; the report has the
    JAX CLI's lines (numbers aside) and file name; evaluate-only from that
    checkpoint gives the same metrics as the evaluation after training."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ck")
    run = TINY + ["gpu.device=cpu", f"general.checkpoint={ckpt}"]
    out = main_3dhp.main(run + ["model.epochs=1", "ft2d.debug=true",
                                "general.checkpoint_frequency=1"])
    report = os.path.join(ckpt, "3dhp_test_log_H1_K1.txt")
    assert out["report"] == report and os.path.exists(report)
    assert os.path.exists(os.path.join(ckpt, "epoch_1.npz"))
    with open(report) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("step 0 : 3DHP MPJPE P_Best: ")
    assert lines[1].startswith("step 0 : 3DHP MPJPE P_Agg: ")
    assert np.all(np.isfinite(out["P_Best"])) and out["windows"] == 9

    jax_dir = str(tmp_path / "jax")
    jax_main_3dhp.main(TINY + ["model.epochs=1", "ft2d.debug=true",
                               f"general.checkpoint={jax_dir}"])
    with open(os.path.join(jax_dir, "3dhp_test_log_H1_K1.txt")) as f:
        assert _numbers_masked(f.read().splitlines()) == _numbers_masked(lines)

    again = main_3dhp.main(run + ["ft2d.debug=true",
                                  "general.evaluate=epoch_1.npz"])
    np.testing.assert_array_equal(again["P_Best"], out["P_Best"])
    np.testing.assert_array_equal(again["P_Agg"], out["P_Agg"])
    with open(report) as f:
        assert len(f.read().splitlines()) == 2 * len(lines)


@pytest.mark.parametrize("overrides,path", [
    (["gpu.compute_dtype=bfloat16"], "kernels #5/#6"),
    (["gpu.train_kernel=false", "gpu.remat=true", "model.dropout=0.1",
      "gpu.compute_dtype=bfloat16"], "autodiff, remat"),
])
def test_cli_training_paths_train_and_evaluate(tmp_path, monkeypatch, capsys,
                                               overrides, path):
    """bf16 compute, the autodiff path with remat and dropout through the
    3DHP CLI: one quick-debug epoch (the log names the path), finite
    metrics, the report and epoch_1."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ck")
    out = main_3dhp.main(TINY + overrides + [
        "gpu.device=cpu", f"general.checkpoint={ckpt}", "model.epochs=1",
        "ft2d.debug=true", "general.checkpoint_frequency=1"])
    assert f"INFO: Training path: {path} (" in capsys.readouterr().out
    assert np.all(np.isfinite(out["P_Best"])) and out["windows"] == 9
    assert os.path.exists(os.path.join(ckpt, "epoch_1.npz"))
    assert os.path.exists(out["report"])


def test_cli_evaluates_a_jax_exported_bin(tmp_path, monkeypatch):
    """A monolithic 17-joint reference ``.bin`` (JAX
    ``export_torch_state_dict(part_based=False)`` under ``module.``) loads
    through the CLI's ``.bin`` path: the denoiser then agrees with the JAX
    model's (1e-5, float32) and the CLI evaluates the file at P=2, T=2."""
    monkeypatch.chdir(tmp_path)
    jm, params, _ = _pair(seed=5)
    sd = jax_checkpoints.export_torch_state_dict(
        params, part_based=False, schedule_timesteps=20)
    torch.save({"model_pos": {f"module.{k}": torch.from_numpy(np.asarray(v))
                              for k, v in sd.items()}}, tmp_path / "mono.bin")
    run = TINY + ["gpu.device=cpu", "ft2d.num_proposals=2",
                  "ft2d.sampling_timesteps=2", f"general.checkpoint={tmp_path}/ck"]
    model = main_3dhp.build_model_3dhp(tcfg.parse_cli(run), "cpu")
    assert [s.name for s in model.pose_estimator.specs] == ["whole_body"]
    checkpoints.load_weights(model, str(tmp_path / "mono.bin"))
    r = np.random.RandomState(6)
    x2d = r.uniform(-1, 1, (3, F, J, 2)).astype(np.float32)
    x3d = r.randn(3, F, J, 3).astype(np.float32)
    t = np.array([0, 7, 19], np.int32)
    want = np.asarray(jax.jit(jm.model)(params, x2d, x3d, t))
    with torch.no_grad():
        got = model.pose_estimator(torch.from_numpy(x2d),
                                   torch.from_numpy(x3d),
                                   torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    out = main_3dhp.main(run + [f"general.evaluate={tmp_path}/mono.bin"])
    assert out["P_Best"].shape == out["P_Agg"].shape == (2,)
    assert np.all(np.isfinite(out["P_Best"])) and out["windows"] == 2 * 9
    assert os.path.exists(tmp_path / "ck" / "3dhp_test_log_H2_K2.txt")


def test_build_model_3dhp_follows_the_gpu_rules():
    args = tcfg.parse_cli(TINY + ["gpu.use_pallas=true"])
    model = main_3dhp.build_model_3dhp(args, "cpu")
    cfg = model.cfg
    assert (cfg.num_kps, cfg.cs, cfg.part_based, cfg.mm_scale,
            cfg.drop_path_rate) == (J, 32, False, True, 0.1)
    np.testing.assert_array_equal(model.flip_permutation,
                                  sk.FLIP_PERMUTATION_3DHP)
    assert model.train_path == "kernels"
    model = main_3dhp.build_model_3dhp(tcfg.parse_cli(TINY + [
        "gpu.compute_dtype=bfloat16", "gpu.train_kernel=false",
        "gpu.remat=true"]), "cpu")
    net = model.pose_estimator["whole_body"]
    assert (net.compute_dtype, model.train_path, net.remat) == (
        torch.bfloat16, "autodiff", True)
    assert main_3dhp.build_model_3dhp(tcfg.parse_cli(
        TINY + ["model.dropout=0.1"]), "cpu").train_path == "autodiff"
    for bad in ("gpu.compute_dtype=float16", "gpu.train_kernel=maybe"):
        with pytest.raises(ValueError):
            main_3dhp.build_model_3dhp(tcfg.parse_cli(TINY + [bad]), "cpu")
    with pytest.raises(ValueError, match="experimental"):
        main_3dhp.build_model_3dhp(
            tcfg.parse_cli(TINY + ["gpu.use_pallas=layer"]), "cpu")
