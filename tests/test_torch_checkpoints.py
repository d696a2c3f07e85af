"""Optimizer state across the two packages: a checkpoint written by one
resumes in the other and takes the same next step.  And the export to the
reference layout (``export_reference_state_dict``) against the JAX
``export_torch_state_dict``: the same keys and the same arrays, bit for
bit, part-based and monolithic, with and without the schedule buffers, and
back through ``load_reference_bin`` strictly.

JAX -> port: the JAX ``build_train_step`` takes two steps at depth 1 and
``save_state`` writes params and ``opt_state``; the port's ``load_state``
restores both into its model and AdamW, and the port and JAX each take step
3 from that file with the same draws (the port is handed the JAX step's
t, noise and stochastic-depth masks, replayed from its key as in
tests/test_torch_train.py).  Port -> JAX: the port takes two steps and
saves; the JAX ``load_state`` restores the file into its optax template and
both packages take step 3 the same way.

Tolerance: params after step 3 within 0.1 x lr max abs, the bound of
tests/test_torch_train.py (1e-5 at lr 1e-4).  A fresh Adam in place of the
restored one moves every weight by about lr on its first step, ten times
the bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import checkpoints as jax_ckpt, train as jtr
from pafuse_tpu.diffusion import D3DP as JaxD3DP, D3DPConfig as JaxConfig
from pafuse_tpu_torch import checkpoints, train as tr
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from test_torch_train import B, LR, _replay_draws

torch.set_num_threads(2)

KW = dict(frames=9, depth=1, timesteps=50, drop_path_rate=0.1)
TOL = 0.1 * LR


def _batches():
    r = np.random.RandomState(11)
    return [(r.randn(B, 9, 134, 2).astype(np.float32),
             (r.randn(B, 9, 134, 3) * 0.1).astype(np.float32))
            for _ in range(3)]


def _jax_step3(jm, tx, params, opt_state, x2d, x3d):
    """Step 3 in JAX from restored state and a fixed key; returns the new
    params (port names) and the draws the port must replay."""
    state = jtr.TrainState(params, opt_state, jax.random.PRNGKey(7))
    _, t, noise, masks = _replay_draws(jm, state.rng, x3d)
    jstep = jtr.build_train_step(jm, tx, donate=False)
    state3, _ = jstep(state, jnp.float32(LR), jnp.asarray(x2d),
                      jnp.asarray(x3d))
    return (checkpoints.params_from_jax(jax.device_get(state3.params)),
            dict(t=t, noise=noise, masks=masks))


def _port_step3(path, draws, x2d, x3d):
    pm = D3DP(D3DPConfig(**KW), device="cpu",
              generator=torch.Generator().manual_seed(5))
    st = tr.create_train_state(pm, seed=5, device="cpu")
    out = checkpoints.load_state(path, pm, st.optimizer)
    tr.build_train_step(pm, st.optimizer)(st, LR, x2d, x3d, **draws)
    return pm, st, out


def _assert_params_close(pm, want):
    named = dict(pm.pose_estimator.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= TOL, f"{name}: {err:.2e}"


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jm = JaxD3DP(JaxConfig(**KW))
    state, tx = jtr.create_train_state(jm, seed=0)
    jstep = jtr.build_train_step(jm, tx, donate=False)
    batches = _batches()
    for x2d, x3d in batches[:2]:
        state, _ = jstep(state, jnp.float32(LR), jnp.asarray(x2d),
                         jnp.asarray(x3d))
    path = jax_ckpt.save_state(str(tmp_path), "epoch_2", params=state.params,
                               opt_state=state.opt_state, epoch=2, lr=LR)
    tmpl, _ = jtr.create_train_state(jm, seed=1)
    restored = jax_ckpt.load_state(path, tmpl.params, tmpl.opt_state)
    want, draws = _jax_step3(jm, tx, restored["params"],
                             restored["opt_state"], *batches[2])

    pm, st, out = _port_step3(path, draws, *batches[2])
    assert out["epoch"] == 2
    steps = {float(s["step"]) for s in st.optimizer.state.values()}
    assert steps == {3.0}
    _assert_params_close(pm, want)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    batches = _batches()
    pm = D3DP(D3DPConfig(**KW), device="cpu",
              generator=torch.Generator().manual_seed(3))
    st = tr.create_train_state(pm, seed=3, device="cpu")
    step = tr.build_train_step(pm, st.optimizer)
    for x2d, x3d in batches[:2]:
        step(st, LR, x2d, x3d)
    path = checkpoints.save_state(str(tmp_path), "epoch_2", model=pm,
                                  optimizer=st.optimizer, epoch=2, lr=LR)

    jm = JaxD3DP(JaxConfig(**KW))
    tmpl, tx = jtr.create_train_state(jm, seed=1)
    restored = jax_ckpt.load_state(path, tmpl.params, tmpl.opt_state)
    opt = restored["opt_state"]
    assert int(opt.count) == 2 and int(opt.inner_state[0].count) == 2
    assert float(opt.hyperparams["learning_rate"]) == np.float32(LR)
    assert float(opt.hyperparams["weight_decay"]) == np.float32(0.1)
    want, draws = _jax_step3(jm, tx, restored["params"], opt, *batches[2])
    step(st, LR, *batches[2], **draws)
    _assert_params_close(pm, want)


def test_opt_state_helpers_are_inverse(tmp_path):
    """opt_state_to_jax gives the JAX make_optimizer() tree's leaves and
    keys; opt_state_from_jax maps it back onto the AdamW state exactly."""
    pm = D3DP(D3DPConfig(**KW), device="cpu")
    st = tr.create_train_state(pm, seed=2, device="cpu")
    tr.build_train_step(pm, st.optimizer)(st, LR, *_batches()[0])
    tree = checkpoints.opt_state_to_jax(pm, st.optimizer)
    jm = JaxD3DP(JaxConfig(**KW))
    want = jax_ckpt._flatten_tree(jax.device_get(
        jtr.create_train_state(jm, seed=0)[0].opt_state))
    got = checkpoints._flatten(tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    back = checkpoints.opt_state_from_jax(tree)
    names = {id(p): n for n, p in pm.pose_estimator.named_parameters()}
    for p, s in st.optimizer.state.items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(back[names[id(p)]][k], s[k]), (names[id(p)], k)


def test_unmapped_optimizer_entries_raise(tmp_path):
    """A file whose opt/ entries map to no parameter of the model raises;
    the model never silently starts from a fresh Adam."""
    pm = D3DP(D3DPConfig(**KW), device="cpu")
    st = tr.create_train_state(pm, seed=2, device="cpu")
    tr.build_train_step(pm, st.optimizer)(st, LR, *_batches()[0])
    path = checkpoints.save_state(str(tmp_path), "a", model=pm,
                                  optimizer=st.optimizer, lr=LR)
    with np.load(path) as raw:
        arrays = dict(raw)
    for key in [k for k in arrays if k.startswith("opt/3/0/1/body/")]:
        arrays[key.replace("/body/", "/torso/")] = arrays.pop(key)
    np.savez(tmp_path / "b.npz", **arrays)
    with pytest.raises(ValueError, match="no parameter"):
        checkpoints.load_state(str(tmp_path / "b.npz"), pm, st.optimizer)


def test_older_port_optimizer_entries_still_load(tmp_path):
    """The opt/{parameter}/{exp_avg,exp_avg_sq,step} entries that earlier
    port checkpoints hold restore the same AdamW state."""
    pm = D3DP(D3DPConfig(**KW), device="cpu")
    st = tr.create_train_state(pm, seed=2, device="cpu")
    tr.build_train_step(pm, st.optimizer)(st, LR, *_batches()[0])
    path = checkpoints.save_state(str(tmp_path), "a", model=pm, lr=LR)
    with np.load(path) as raw:
        arrays = dict(raw)
    names = {id(p): n for n, p in pm.pose_estimator.named_parameters()}
    for p, s in st.optimizer.state.items():
        for k, v in s.items():
            arrays[f"opt/{names[id(p)]}/{k}"] = v.numpy()
    np.savez(tmp_path / "old.npz", **arrays)
    st2 = tr.create_train_state(pm, seed=2, device="cpu")
    checkpoints.load_state(str(tmp_path / "old.npz"), pm, st2.optimizer)
    by_name = {names[id(p)]: s for p, s in st.optimizer.state.items()}
    for p, s in st2.optimizer.state.items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], by_name[names[id(p)]][k])


@pytest.mark.parametrize("part_based", [True, False],
                         ids=["part_based", "monolithic"])
@pytest.mark.parametrize("timesteps", [None, 50], ids=["params", "schedule"])
def test_reference_export_matches_jax_and_loads_back(tmp_path, part_based,
                                                      timesteps):
    kw = dict(frames=9, depth=1, part_based=part_based, cs=32)
    jm = JaxD3DP(JaxConfig(**kw))
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(4)))
    want = jax_ckpt.export_torch_state_dict(
        params, part_based=part_based, schedule_timesteps=timesteps)
    model = D3DP(D3DPConfig(**kw), device="cpu")
    model.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                         strict=True)
    got = checkpoints.export_reference_state_dict(
        model, schedule_timesteps=timesteps)
    assert sorted(got) == sorted(want)
    assert ("log_one_minus_alphas_cumprod" in got) == (timesteps is not None)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    path = str(tmp_path / "exported.bin")
    torch.save({"model_pos": got, "epoch": 3}, path)
    fresh = D3DP(D3DPConfig(**kw), device="cpu",
                 generator=torch.Generator().manual_seed(9))
    checkpoints.load_weights(fresh, path)        # strict
    for (name, a), b in zip(model.pose_estimator.state_dict().items(),
                            fresh.pose_estimator.state_dict().values()):
        assert torch.equal(a, b), name
