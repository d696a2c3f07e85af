"""Data parallel on torch.distributed (pafuse_tpu_torch.parallel.mesh) on the
CPU (sharded evaluation: tests/test_torch_parallel_eval.py, which uses
this file's launcher and worker): two processes in a gloo world, launched as torchrun launches them
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR/PORT``), against one
process and against the JAX package's sharded step and evaluation on the
conftest's 8-device CPU mesh.

Every launch has a subprocess deadline and every process group the mesh's
own timeout, so a rank that dies or misses a collective fails the test
instead of hanging the run.

Bounds:
  DDP step vs one process on the global batch: loss, gradients (x max|g|
  per tensor) and params after AdamW within 1e-5 (the gradients are the
  mean of the two ranks' halves instead of one sum over 8 rows; measured
  ~1e-7).  Against JAX's sharded step: tests/test_torch_train.py's bounds
  (loss 1e-5 relative, params 0.1 x lr; that file holds the gradients).
  Replicas: equal bit for bit across ranks.
  Sharded evaluation vs one process: metrics within 1e-5 relative (each
  rank's sampler call has half the rows, and the PyTorch GEMMs of the
  embedding and head on the CPU round a row's sums differently at
  another row count; measured ~1e-7); vs JAX's sharded evaluation
  1e-5, as tests/test_mesh.py holds JAX's own.
  Serving over two replicas vs one: 1e-5 max abs on poses, for the same
  reason (bit for bit where the row counts match).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import serve as jserve, train as jtr
from pafuse_tpu.diffusion import D3DP as JaxD3DP, D3DPConfig as JaxConfig
from pafuse_tpu.models import mixste as jmixste
from pafuse_tpu.ops.block_grad import select_train_block_fn
from pafuse_tpu.parallel import mesh as jmesh
from pafuse_tpu_torch import checkpoints, serve, train as tr
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from pafuse_tpu_torch.parallel import mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(frames=9, depth=2, timesteps=50, drop_path_rate=0.1)
EVAL_KW = dict(frames=9, timesteps=20, depth=1, num_proposals=2,
               sampling_timesteps=2)
B, LR, SEED = 8, 1e-4, 3
DEADLINE = 80           # seconds a two-rank launch may take

WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from pafuse_tpu_torch.parallel import mesh

mode, workdir = sys.argv[1], sys.argv[2]
world = mesh.make_mesh(device="cpu")
assert world.distributed and world.size == 2
inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
out = {}
if mode == "train":
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

    def fresh():
        m = D3DP(D3DPConfig(**inp["kw"]), device="cpu")
        m.pose_estimator.load_state_dict(inp["params"])
        st = tr.create_train_state(m, seed=inp["seed"], device="cpu")
        return m, st, tr.build_train_step(m, st.optimizer,
                                          weights=inp["weights"], world=world)

    def snap(m, grads=False):
        return {n: (p.grad if grads else p).detach().clone()
                for n, p in m.pose_estimator.named_parameters()}

    m, st, step = fresh()
    loss = step(st, inp["lr"], inp["x2d"], inp["x3d"], t=inp["t"],
                noise=inp["noise"], masks=inp["masks"])
    out["injected"] = dict(loss=float(loss), grads=snap(m, True),
                           params=snap(m))
    m, st, step = fresh()
    losses = [float(step(st, inp["lr"], inp["x2d"], inp["x3d"]))]
    out["drawn_params"] = snap(m)
    losses.append(float(step(st, inp["lr"], inp["x2d"], inp["x3d"])))
    out["drawn"] = dict(losses=losses, params2=snap(m))
elif mode == "eval":
    from pafuse_tpu_torch import evaluate as ev
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    m = D3DP(D3DPConfig(**inp["eval_kw"]), device="cpu")
    m.pose_estimator.load_state_dict(inp["params"])
    kw = dict(receptive_field=9, num_proposals=2, sampling_timesteps=2,
              world=world)
    acc, _ = ev.evaluate_sequences(m, inp["seqs"], noise_table=inp["table"],
                                   **kw)
    acc2, p2 = ev.evaluate_sequences(m, inp["seqs"], collect_p2=True, **kw)
    from pafuse_tpu_torch import config
    from pafuse_tpu_torch.cli import main_3dhp
    args3 = config.parse_cli(inp["args_3dhp"])
    m3 = main_3dhp.build_model_3dhp(args3, "cpu")
    m3.load_state_dict(inp["params_3dhp"])
    dhp = main_3dhp.evaluate_3dhp(m3.eval(), inp["test_3dhp"],
                                  args3, num_proposals=2,
                                  sampling_timesteps=2, window_batch=5,
                                  world=world)
    out = dict(injected=acc.means_mm(), drawn=acc2.means_mm(),
               p2=p2.means_mm(), dhp3=dhp)
torch.save(out, os.path.join(workdir, f"out_{mode}_{world.rank}.pt"))
mesh.close(world)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, cwd):
    """Run ``argv`` as ranks 0 and 1 of a torchrun-style launch; wait at
    most DEADLINE seconds for both, kill what is left, and return their
    outputs (each must exit 0)."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(argv(rank), cwd=cwd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs, end = [], time.time() + DEADLINE
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, end - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


def _worker(mode, workdir):
    return _launch(lambda rank: [sys.executable, "-c", WORKER, mode,
                                 str(workdir)], cwd=str(workdir))


def _replay_draws(model, rng, x3d):
    """t, noise and branch masks of the JAX step whose state key is ``rng``
    (tests/test_torch_train.py's replay, for a batch of B)."""
    _, step_rng = jax.random.split(rng)
    r_targets, r_drop = jax.random.split(step_rng)
    rt, rn = jax.random.split(r_targets)
    t = np.array(jax.random.randint(rt, (B,), 0, KW["timesteps"]))
    noise = np.array(jax.random.normal(rn, x3d.shape, jnp.float32))
    masks = {}
    specs = model.model.specs
    for s, key in zip(specs, jax.random.split(r_drop, len(specs))):
        keys = jax.random.split(key, 2 * s.config.depth)
        rates = s.config.drop_path_rates
        masks[s.name] = [
            tuple(np.array(m) for m in jmixste._branch_masks(
                keys[j], float(rates[j // 2]), B, 1))
            for j in range(2 * s.config.depth)]
    return t, noise, masks


@pytest.fixture(scope="module")
def ddp_train(tmp_path_factory):
    """The JAX step on the 8-device mesh, one port process, and the
    two-rank DDP step, from equal params and batch."""
    jm = JaxD3DP(JaxConfig(**KW),
                 train_block_fn=select_train_block_fn("auto"))
    state, tx = jtr.create_train_state(jm, seed=0)
    weights = jtr.mixste_weight_table()
    r = np.random.RandomState(0)
    x2d = r.randn(B, 9, 134, 2).astype(np.float32)
    x3d = (r.randn(B, 9, 134, 3) * 0.1).astype(np.float32)
    t, noise, masks = _replay_draws(jm, state.rng, x3d)
    jax_mesh = jmesh.make_mesh((8,), ("data",))
    jstep = jtr.build_train_step(jm, tx, weights=weights, mesh=jax_mesh,
                                 donate=False)
    state2, jloss = jstep(state, jnp.float32(LR),
                          *jmesh.shard_batch((x2d, x3d), jax_mesh))
    params = checkpoints.params_from_jax(jax.device_get(state.params))

    def one_process(**draws):
        pm = D3DP(D3DPConfig(**KW), device="cpu")
        pm.pose_estimator.load_state_dict(params, strict=True)
        st = tr.create_train_state(pm, seed=SEED, device="cpu")
        step = tr.build_train_step(pm, st.optimizer, weights=weights)
        loss = float(step(st, LR, x2d, x3d, **draws))
        return pm, loss

    workdir = tmp_path_factory.mktemp("ddp_train")
    torch.save(dict(kw=KW, params=params, seed=SEED, weights=weights, lr=LR,
                    x2d=x2d, x3d=x3d, t=t, noise=noise, masks=masks),
               workdir / "inputs.pt")
    _worker("train", workdir)
    ranks = [torch.load(workdir / f"out_train_{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(
        jax=dict(loss=float(jloss),
                 params=checkpoints.params_from_jax(
                     jax.device_get(state2.params))),
        injected=one_process(t=t, noise=noise, masks=masks),
        drawn=one_process(), ranks=ranks)


def _named(pm, grads=False):
    return {n: (p.grad if grads else p).detach()
            for n, p in pm.pose_estimator.named_parameters()}


def _max_rel(got, want):
    return max(float((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for n, w in want.items())


def _max_abs(got, want):
    return max(float((got[n] - w).abs().max()) for n, w in want.items())


def test_ddp_step_equals_one_process_on_the_global_batch(ddp_train):
    pm, loss = ddp_train["injected"]
    for out in ddp_train["ranks"]:
        got = out["injected"]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        assert _max_rel(got["grads"], _named(pm, grads=True)) <= 1e-5
        assert _max_abs(got["params"], _named(pm)) <= 1e-5


def test_every_parameter_gets_a_gradient(ddp_train):
    """replicate() passes find_unused_parameters=False: every parameter must
    get a gradient on every step (a zero one where stochastic depth drops
    a branch), on one process and on each rank."""
    pm, _ = ddp_train["injected"]
    assert all(p.grad is not None for p in pm.parameters())
    names = {n for n, _ in pm.pose_estimator.named_parameters()}
    for out in ddp_train["ranks"]:
        assert set(out["injected"]["grads"]) == names


def test_ddp_step_equals_jax_sharded_step(ddp_train):
    want = ddp_train["jax"]
    for out in ddp_train["ranks"]:
        got = out["injected"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"]
        assert _max_abs(got["params"], want["params"]) <= 0.1 * LR


def test_ddp_step_draws_the_global_batch_randomness(ddp_train):
    """Without injected draws every rank draws the global batch's t, noise
    and masks from the same seed and takes its rows: the step equals one
    process drawing them itself."""
    pm, loss = ddp_train["drawn"]
    for out in ddp_train["ranks"]:
        assert abs(out["drawn"]["losses"][0] - loss) <= 1e-5 * abs(loss)
        assert _max_abs(out["drawn_params"], _named(pm)) <= 1e-5


def test_ddp_replicas_stay_equal_bit_for_bit(ddp_train):
    a, b = (out["drawn"] for out in ddp_train["ranks"])
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["params2"][n], b["params2"][n])
               for n in a["params2"])


@pytest.mark.parametrize("world_size", [1, 2, 3, 8])
def test_per_rank_batch_rounds_as_jax(world_size):
    seqs = 1024 // 27
    jax_rounded = max(world_size, (seqs // world_size) * world_size)
    world = mesh.World(size=world_size)
    assert mesh.per_rank_batch(seqs, world) * world_size == jax_rounded


def test_make_mesh_without_a_launcher_is_a_world_of_one(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    world = mesh.make_mesh(device="cpu")
    assert (world.rank, world.size, world.distributed) == (0, 1, False)
    assert world.main and world.device == torch.device("cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_rows(x, world) is x
    assert torch.equal(mesh.shard_rows([x], world)[0], x)
    with pytest.raises(ValueError):
        mesh.make_mesh((2,), device="cpu")
    with pytest.raises(ValueError):
        mesh.make_mesh((-1,), ("model",), device="cpu")
    with pytest.raises(ValueError):
        mesh.replicate(torch.nn.Linear(2, 2), world)


def test_shard_rows_takes_each_ranks_rows_in_order():
    x = np.arange(12).reshape(6, 2)
    got = [mesh.shard_rows([x], mesh.World(rank=r, size=3))[0]
           for r in range(3)]
    np.testing.assert_array_equal(np.concatenate(got), x)
    with pytest.raises(ValueError):
        mesh.shard_rows([x[:5]], mesh.World(rank=0, size=2))


def test_cli_on_two_ranks_writes_from_rank_0_only(tmp_path):
    """A 1-epoch quick-debug training run of the H3WB CLI on two ranks, each
    rank given its own checkpoint and log directories: rank 0 writes the
    checkpoints, training log, report, logging.log, the TensorBoard event
    file and the profile trace; rank 1 writes nothing."""
    def argv(rank):
        return [sys.executable, "-m", "pafuse_tpu_torch.cli.main_h3wb",
                "gpu.device=cpu", "data.synthetic=true",
                "data.synthetic_actions=1", "data.synthetic_frames=40",
                "model.number_of_frames=9", "model.batch_size=36",
                "model.dep=1", "ft2d.timestep=20", "ft2d.num_proposals=1",
                "ft2d.sampling_timesteps=1", "ft2d.debug=true",
                "model.epochs=1", "general.checkpoint_frequency=1",
                "gpu.profile=true", f"general.log={tmp_path}/log{rank}",
                f"general.checkpoint={tmp_path}/ck{rank}"]
    outs = _launch(argv, cwd=str(tmp_path))
    assert all("data-parallel world: rank" in o for o in outs)
    ck0, ck1 = tmp_path / "ck0", tmp_path / "ck1"
    for name in ("epoch_1.npz", "best_epoch.npz", "training_log.txt",
                 "h36m_test_log_H1_K1.txt"):
        assert (ck0 / name).exists(), name
    assert any((ck0 / "profile").iterdir())
    assert os.listdir(ck1) == []
    logs = [d for d in os.listdir(tmp_path) if d.startswith("log")]
    assert len(logs) == 1 and logs[0].startswith("log0_")
    files = os.listdir(tmp_path / logs[0])
    assert "logging.log" in files
    assert any(f.startswith("events.out.tfevents") for f in files)

    # resume=auto on both ranks from rank 0's directory: each rank loads
    # epoch_1 and trains epoch 2; rank 0 alone writes epoch_2
    def resume(rank):
        return [a for a in argv(rank) if not a.startswith(
            ("general.checkpoint=", "model.epochs=", "gpu.profile="))] + [
            f"general.checkpoint={ck0}", "model.epochs=2",
            "general.resume=auto", "general.nolog=true"]
    outs = _launch(resume, cwd=str(tmp_path))
    assert all(f"Auto-resume from {ck0 / 'epoch_1.npz'}" in o
               and "This model was trained for 1 epochs" in o for o in outs)
    assert (ck0 / "epoch_2.npz").exists()
    with open(ck0 / "training_log.txt") as f:
        assert [ln.split()[0] for ln in f if ln.startswith("[")] == [
            "[1]", "[2]"]


@pytest.fixture(scope="module")
def model_and_service_cfg():
    cfg = D3DPConfig(frames=9, timesteps=20, sampling_timesteps=2,
                     num_proposals=2, depth=1)
    return cfg


def test_serving_rows_split_over_two_replicas(model_and_service_cfg):
    cfg = model_and_service_cfg

    def service(**kw):
        return serve.LiftingService(
            D3DP(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
            buckets=(1, 3, 4, 8), **kw)

    one, two = service(device="cpu"), service(devices=["cpu", "cpu"])
    try:
        assert two.health()["mesh_devices"] == 2 and two.buckets == (2, 4, 8)
        assert len(two.replicas) == 2 and two.replicas[1] is not two.model
        kp = np.random.RandomState(0).uniform(-1, 1, (100, 134, 2))
        for frames, kw in ((9, {}), (27, {"all_hypotheses": True}),
                           (100, {})):      # 1, 3 and 12 windows
                a = one.lift(kp[:frames], seed=4, **kw)["poses"]
                b = two.lift(kp[:frames], seed=4, **kw)["poses"]
                assert a.shape == b.shape
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    finally:
        one.close()
        two.close()


def test_serving_buckets_equal_jax_mesh_buckets(model_and_service_cfg):
    jm = JaxD3DP(JaxConfig(frames=9, timesteps=20, depth=1))
    jparams = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    for n, buckets in ((2, (1, 3, 4, 8)), (4, (1, 2, 4, 6, 16))):
        jsvc = jserve.LiftingService(jm, jparams, buckets=buckets,
                                     mesh=jmesh.make_mesh((n,), ("data",)),
                                     dynamic_batching=False)
        svc = serve.LiftingService(
            D3DP(model_and_service_cfg, device="cpu"), buckets=buckets,
            devices=["cpu"] * n, dynamic_batching=False)
        assert svc.buckets == tuple(jsvc.buckets)
        assert svc.health()["mesh_devices"] == jsvc.health()["mesh_devices"]
