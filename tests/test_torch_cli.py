"""The port's H3WB CLI (pafuse_tpu_torch.cli.main_h3wb) and its config, on
the CPU at a tiny size (depth 1, 9 frames, 20 diffusion steps, one
hypothesis and one DDIM step) on synthetic H3WB in quick-debug mode, as
tests/test_e2e.py drives the JAX CLI; and the config against the JAX
package's (same reference groups and defaults, same value parsing)."""

import os

import numpy as np
import pytest
import torch

import jax

from pafuse_tpu import checkpoints as jax_checkpoints
from pafuse_tpu import config as jcfg
from pafuse_tpu.diffusion import D3DP as JaxD3DP
from pafuse_tpu.diffusion import D3DPConfig as JaxD3DPConfig
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch import config as tcfg
from pafuse_tpu_torch.cli import main_h3wb

torch.set_num_threads(2)

TINY = ["gpu.device=cpu", "data.synthetic=true", "data.synthetic_actions=1",
        "data.synthetic_frames=30", "model.number_of_frames=9",
        "model.batch_size=36", "model.dep=1", "ft2d.timestep=20",
        "ft2d.sampling_timesteps=1", "ft2d.num_proposals=1",
        "ft2d.debug=true", "general.nolog=true"]
REPORT = "h36m_test_log_H1_K1.txt"


def _report_lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_train_then_evaluate_from_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = main_h3wb.main(TINY + ["model.epochs=1", "gpu.use_pallas=true",
                                 f"general.checkpoint={ckpt}",
                                 "general.checkpoint_frequency=1"])
    for name in ("best_epoch.npz", "epoch_1.npz", "training_log.txt", REPORT):
        assert os.path.exists(os.path.join(ckpt, name)), name
    log = _report_lines(os.path.join(ckpt, "training_log.txt"))
    assert log[0].startswith("[1] time ") and "3d_pos_valid" in log[0]
    assert log[1] == "best epoch"
    lines = _report_lines(os.path.join(ckpt, REPORT))
    assert lines[0] == "----Walking----"
    assert lines[1].startswith("step 0 : Protocol #1 Error (MPJPE) J_Best: ")
    assert any(line.startswith("step 0 Protocol #1   (MPJPE) action-wise "
                               "average P_Agg (Part-Based) RIGHT HAND: ")
               for line in lines)
    avg = out["final"]["all"]
    assert all(np.all(np.isfinite(v)) for v in avg.values())
    assert out["windows"] > 0 and out["eval_seconds"] > 0

    # evaluate only, from the saved best epoch: the same weights give the
    # same report as the evaluation after training
    again = main_h3wb.main(TINY + ["gpu.use_pallas=true",
                                   f"general.checkpoint={ckpt}",
                                   "general.evaluate=best_epoch.npz"])
    for k, v in avg.items():
        np.testing.assert_array_equal(again["final"]["all"][k], v, err_msg=k)
    assert len(_report_lines(os.path.join(ckpt, REPORT))) == 2 * len(lines)

    # resume=auto continues from epoch_1 and trains epoch 2
    main_h3wb.main(TINY + ["model.epochs=2", "general.resume=auto",
                           "general.checkpoint_frequency=1",
                           f"general.checkpoint={ckpt}"])
    assert _report_lines(os.path.join(ckpt, "training_log.txt"))[2].startswith(
        "[2] time ")
    assert os.path.exists(os.path.join(ckpt, "epoch_2.npz"))


def test_evaluate_reference_bin(tmp_path, monkeypatch):
    """A reference-named torch checkpoint (``model_pos`` with
    ``module.pose_estimator.`` keys) evaluates through ``.bin`` loading, at
    use_pallas=auto and per subject."""
    monkeypatch.chdir(tmp_path)
    args = tcfg.load_config(overrides=TINY)
    model = main_h3wb.build_model(args, "cpu")
    sd = {f"module.pose_estimator.{k}": v
          for k, v in model.pose_estimator.state_dict().items()}
    torch.save({"model_pos": sd}, tmp_path / "ref.bin")
    out = main_h3wb.main(TINY + [f"general.evaluate={tmp_path}/ref.bin",
                                 f"general.checkpoint={tmp_path}/ck",
                                 "general.by_subject=true"])
    assert set(out["final"]) == {"S8"}
    assert os.path.exists(tmp_path / "ck" / REPORT)


def test_evaluate_monolithic_reference_bin(tmp_path, monkeypatch):
    """A monolithic reference checkpoint (keys ``module.pose_estimator.
    STEblocks...`` and the schedule buffers, written by the JAX package's
    ``export_torch_state_dict(part_based=False)``) loads through the CLI's
    ``.bin`` path into the port's one-part model at
    general.part_based_model=false, depth 1: the denoiser then agrees with
    the JAX model's on the same input within 1e-5 (float32; the same
    float32 arithmetic, sums in another order), and the CLI evaluates the
    file."""
    monkeypatch.chdir(tmp_path)
    run = TINY + ["general.part_based_model=false", "model.cs=64"]
    jm = JaxD3DP(JaxD3DPConfig(frames=9, timesteps=20, depth=1, cs=64,
                               part_based=False, sampling_timesteps=1,
                               num_proposals=1))
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(3)))
    sd = jax_checkpoints.export_torch_state_dict(
        params, part_based=False, schedule_timesteps=20)
    torch.save({"model_pos": {f"module.{k}": torch.from_numpy(np.asarray(v))
                              for k, v in sd.items()}}, tmp_path / "mono.bin")

    model = main_h3wb.build_model(tcfg.load_config(overrides=run), "cpu")
    parts = [spec.name for spec in model.pose_estimator.specs]
    assert parts == ["whole_body"]
    model.pose_estimator.load_state_dict(checkpoints.load_reference_bin(
        str(tmp_path / "mono.bin"), parts), strict=True)
    r = np.random.RandomState(6)
    x2d = r.uniform(-1, 1, (3, 9, 134, 2)).astype(np.float32)
    x3d = r.randn(3, 9, 134, 3).astype(np.float32)
    t = np.array([0, 7, 19], np.int32)
    want = np.asarray(jax.jit(jm.model)(params, x2d, x3d, t))
    with torch.no_grad():
        got = model.pose_estimator(torch.from_numpy(x2d), torch.from_numpy(x3d),
                                   torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    out = main_h3wb.main(run + [f"general.evaluate={tmp_path}/mono.bin",
                                f"general.checkpoint={tmp_path}/ck"])
    assert all(np.all(np.isfinite(v)) for v in out["final"]["all"].values())
    assert os.path.exists(tmp_path / "ck" / REPORT)


def test_evaluate_reference_bin_with_random_state(tmp_path, monkeypatch):
    """A reference ``.bin`` as the reference's ``save_state`` writes it:
    ``model_pos`` (here the JAX package's ``export_torch_state_dict`` of
    the part-based model under ``module.``) beside ``epoch``, ``lr``,
    ``optimizer`` and ``random_state``, a pickled ``np.random.RandomState``.
    It loads with ``weights_only=True`` (the RandomState's NumPy globals
    allowed), the denoiser then agrees with the JAX model's on the same
    input within 1e-5 (float32; the same float32 arithmetic, sums in
    another order), and the CLI evaluates the file."""
    monkeypatch.chdir(tmp_path)
    jm = JaxD3DP(JaxD3DPConfig(frames=9, timesteps=20, depth=1,
                               sampling_timesteps=1, num_proposals=1))
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(4)))
    sd = jax_checkpoints.export_torch_state_dict(params, schedule_timesteps=20)
    rs = np.random.RandomState(11)
    rs.permutation(50)
    torch.save({"epoch": 7, "lr": 5e-5, "random_state": rs,
                "optimizer": {"state": {0: {"step": torch.tensor(3.0)}},
                              "param_groups": [{"lr": 5e-5, "params": [0]}]},
                "model_pos": {f"module.{k}": torch.from_numpy(np.asarray(v))
                              for k, v in sd.items()}}, tmp_path / "rs.bin")

    model = main_h3wb.build_model(tcfg.load_config(overrides=TINY), "cpu")
    model.pose_estimator.load_state_dict(checkpoints.load_reference_bin(
        str(tmp_path / "rs.bin"),
        [spec.name for spec in model.pose_estimator.specs]), strict=True)
    r = np.random.RandomState(7)
    x2d = r.uniform(-1, 1, (2, 9, 134, 2)).astype(np.float32)
    x3d = r.randn(2, 9, 134, 3).astype(np.float32)
    t = np.array([3, 18], np.int32)
    want = np.asarray(jax.jit(jm.model)(params, x2d, x3d, t))
    with torch.no_grad():
        got = model.pose_estimator(torch.from_numpy(x2d), torch.from_numpy(x3d),
                                   torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    out = main_h3wb.main(TINY + [f"general.evaluate={tmp_path}/rs.bin",
                                 f"general.checkpoint={tmp_path}/ck"])
    assert all(np.all(np.isfinite(v)) for v in out["final"]["all"].values())
    assert os.path.exists(tmp_path / "ck" / REPORT)


def test_logging_tee_is_restored(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    import sys
    stdout = sys.stdout
    main_h3wb.main([a for a in TINY if a != "general.nolog=true"]
                   + ["model.epochs=1", f"general.log={tmp_path}/log",
                      f"general.checkpoint={tmp_path}/ck"])
    assert sys.stdout is stdout
    logs = [d for d in os.listdir(tmp_path) if d.startswith("log_")]
    assert len(logs) == 1
    with open(tmp_path / logs[0] / "logging.log") as f:
        assert "Train!" in f.read()


@pytest.mark.parametrize("override,error", [
    ("ft2d.sampling_timestep=5", KeyError),        # a typo
    ("tpu.use_pallas=true", KeyError),            # the TPU group is gone
    ("gpu.mesh_shape=[2]", ValueError),           # not the world's size
    ("gpu.mesh_axis_names=[model]", ValueError),  # only 'data' is sharded
    ("gpu.donate_buffers=true", KeyError),        # TPU-only keys are absent
    ("experiment.warmup=5", ValueError),
    ("model.diff_model=X", ValueError),
    ("gpu.use_pallas=block_t", ValueError),       # without the gate
    ("gpu.use_pallas=layer", ValueError),
    ("gpu.compute_dtype=float16", ValueError),
    ("gpu.train_kernel=maybe", ValueError),
    ("mlflow.mlflow_on=true", NotImplementedError),
])
def test_cli_rejects(tmp_path, monkeypatch, override, error):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error):
        main_h3wb.main(TINY + [override, f"general.checkpoint={tmp_path}/ck"])


@pytest.mark.parametrize("overrides,path", [
    (["gpu.compute_dtype=bfloat16"], "kernels #5/#6"),
    (["gpu.train_kernel=false"], "autodiff"),
    (["model.dropout=0.1"], "autodiff"),
    (["gpu.train_kernel=false", "gpu.remat=true",
      "gpu.compute_dtype=bfloat16"], "autodiff, remat"),
])
def test_training_paths_train_and_evaluate(tmp_path, monkeypatch, capsys,
                                           overrides, path):
    """bf16 compute, the autodiff path, dropout and remat through the CLI:
    one epoch of training (the log names the path), the per-epoch and the
    final evaluation with finite metrics, the report and the checkpoint."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = main_h3wb.main(TINY + overrides + [
        "model.epochs=1", f"general.checkpoint={ckpt}",
        "general.checkpoint_frequency=1"])
    assert f"INFO: Training path: {path} (" in capsys.readouterr().out
    assert all(np.all(np.isfinite(v)) for v in out["final"]["all"].values())
    for name in ("epoch_1.npz", "training_log.txt", REPORT):
        assert os.path.exists(os.path.join(ckpt, name)), name


def test_bf16_evaluation_tracks_float32(tmp_path, monkeypatch):
    """Evaluating one checkpoint at gpu.compute_dtype=bfloat16 gives metrics
    near the float32 evaluation's (the same weights and noise; bf16 moves
    these tiny-model metrics by well under 1%) but not equal to them."""
    monkeypatch.chdir(tmp_path)
    args = tcfg.load_config(overrides=TINY)
    model = main_h3wb.build_model(args, "cpu")
    checkpoints.save_state(str(tmp_path), "w", model=model)
    run = TINY + [f"general.evaluate={tmp_path}/w.npz"]
    f32 = main_h3wb.main(run + [f"general.checkpoint={tmp_path}/f32"])
    bf16 = main_h3wb.main(run + ["gpu.compute_dtype=bfloat16",
                                 f"general.checkpoint={tmp_path}/bf16"])
    a, b = f32["final"]["all"]["P_Best"], bf16["final"]["all"]["P_Best"]
    np.testing.assert_allclose(b, a, rtol=1e-2)
    assert not np.array_equal(a, b)


def test_experimental_modes_evaluate_as_the_plain_block(tmp_path, monkeypatch):
    """Behind gpu.experimental_kernels=true, use_pallas=block_t and layer
    evaluate a checkpoint as use_pallas=false does: the same weights and
    noise give metrics within 1e-5 relative (the blocks agree to ~1e-6)."""
    monkeypatch.chdir(tmp_path)
    args = tcfg.load_config(overrides=TINY)
    model = main_h3wb.build_model(args, "cpu")
    sd = {f"module.pose_estimator.{k}": v
          for k, v in model.pose_estimator.state_dict().items()}
    torch.save({"model_pos": sd}, tmp_path / "ref.bin")
    run = TINY + [f"general.evaluate={tmp_path}/ref.bin",
                  "gpu.experimental_kernels=true"]
    want = main_h3wb.main(run + ["gpu.use_pallas=false",
                                 f"general.checkpoint={tmp_path}/false"])
    for mode in ("block_t", "layer"):
        got = main_h3wb.main(run + [f"gpu.use_pallas={mode}",
                                    f"general.checkpoint={tmp_path}/{mode}"])
        assert os.path.exists(tmp_path / mode / REPORT)
        for k, v in want["final"]["all"].items():
            np.testing.assert_allclose(got["final"]["all"][k], v, rtol=1e-5,
                                       atol=0, err_msg=f"{mode} {k}")


def test_cli_refuses_missing_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the CPU-only refusal cannot be shown")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_h3wb.main([a for a in TINY if a != "gpu.device=cpu"])
    assert not os.listdir(tmp_path)


def test_defaults_match_the_jax_config():
    """The reference groups and ``serve`` keep the JAX package's keys and
    defaults; the TPU group becomes ``gpu``."""
    want = jcfg.load_config().to_dict()
    got = tcfg.load_config().to_dict()
    for group in ("general", "mlflow", "data", "model", "experiment", "viz",
                  "ft2d", "in_the_wild", "serve"):
        assert got[group] == want[group], group
    assert set(got) - set(want) == {"gpu"}
    assert set(want) - set(got) == {"tpu"}
    assert set(got["gpu"]) == {"device", "use_pallas", "experimental_kernels",
                               "train_kernel", "compute_dtype", "remat",
                               "seed", "mesh_shape", "mesh_axis_names",
                               "profile"}
    for key in ("use_pallas", "experimental_kernels", "train_kernel",
                "compute_dtype", "remat", "seed", "mesh_shape",
                "mesh_axis_names", "profile"):
        assert got["gpu"][key] == want["tpu"][key], key


@pytest.mark.parametrize("raw", [
    "true", "True", "FALSE", "yes", "off", "1", "-3", "0.00006", "1.5",
    "[1, 2, 4]", "['5x2', '1x1']", "[]", "'S8'", '"0"', "S1,S5,S6,S7",
    "auto", "", "null", "~", "best_epoch.npz", "log/default"])
def test_override_values_parse_as_the_jax_config(raw):
    assert tcfg._parse_value(raw) == jcfg._parse_value(raw)


def test_overrides_and_printer():
    cfg = tcfg.load_config(overrides=["model.dep=2", "+extra.key=[1, 'a']",
                                      "general.evaluate="])
    assert cfg.model.dep == 2 and cfg.extra.key == [1, "a"]
    assert cfg.general.evaluate is None
    with pytest.raises(KeyError, match="already exists"):
        tcfg.apply_overrides(cfg, ["+model.dep=3"])
    with pytest.raises(KeyError, match="is a value"):
        tcfg.apply_overrides(cfg, ["+model.dep.x=3"])
    text = tcfg.to_yaml(cfg)
    assert "model:\n  diff_model: MixSTE2\n" in text
    assert "  subjects_train: S1,S5,S6,S7\n" in text
    assert "  gpu: '0'\n" in text and "  checkpoint: ''\n" in text
    assert cfg.to_dict()["gpu"]["use_pallas"] == "auto"
