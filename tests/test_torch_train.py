"""Port training (pafuse_tpu_torch.train) against the JAX package.

One training step from equal params: the JAX ``build_train_step`` (on the
CPU its train kernel declines, so it is XLA autodiff) and the port's step
(every block through ``ops.block_train``: its plain versions on the CPU) at
depth 2, 9 frames, the real part widths (384/224/256) and
``drop_path_rate=0.1``.  The port is handed the JAX step's own random draws,
replayed from its key without touching the JAX package: ``split(rng)`` ->
the step key -> ``r_targets, r_drop`` (``diffusion.py:239``); t and the
noise from ``split(r_targets)``; the stochastic-depth masks from
``split(r_drop, parts)`` (``parts.py:137``), ``split(., 2*depth)``
(``mixste.py:308``) and ``_branch_masks``.

Tolerances: loss 1e-5 relative; gradients 1e-4 x max|JAX gradient| per
tensor (measured ~1e-6: float32 sums in another order); params after AdamW
0.1 x lr max abs: Adam's first step moves each parameter by
lr * g / (|g| + 1e-8), so where |g| is near 1e-8 a float32 difference in g
changes the step by a sizable fraction of lr (measured ~0.04 x lr).
Loss pieces (``mpjpe``, weights, MSE) and the centring functions hold to
1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import geometry as jgeom, losses as jlosses, train as jtr
from pafuse_tpu.diffusion import D3DP as JaxD3DP, D3DPConfig as JaxConfig
from pafuse_tpu.models import mixste as jmixste
from pafuse_tpu.ops.block_grad import select_train_block_fn
from pafuse_tpu_torch import checkpoints, geometry, losses, train as tr
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

KW = dict(frames=9, depth=2, timesteps=50, drop_path_rate=0.1)
B = 2
LR = 1e-4


def _batch(seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, 9, 134, 2).astype(np.float32),
            (r.randn(B, 9, 134, 3) * 0.1).astype(np.float32))


def _replay_draws(model, rng, x3d):
    """t, noise and masks of the JAX step whose state key is ``rng``."""
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
    return step_rng, t, noise, masks


@pytest.fixture(scope="module")
def one_step():
    jm = JaxD3DP(JaxConfig(**KW),
                 train_block_fn=select_train_block_fn("auto"))
    state, tx = jtr.create_train_state(jm, seed=0)
    weights = jtr.mixste_weight_table()
    x2d, x3d = _batch(0)
    step_rng, t, noise, masks = _replay_draws(jm, state.rng, x3d)
    x3d_c = jgeom.center_pose_parts(jnp.asarray(x3d))

    def loss_fn(params):
        pred = jm.train_forward(params, step_rng, jnp.asarray(x2d), x3d_c)
        return jlosses.mpjpe(pred, x3d_c, weights=jnp.asarray(weights))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    jstep = jtr.build_train_step(jm, tx, weights=weights, donate=False)
    state2, jloss2 = jstep(state, jnp.float32(LR), jnp.asarray(x2d),
                           jnp.asarray(x3d))

    pm = D3DP(D3DPConfig(**KW), device="cpu")
    pm.pose_estimator.load_state_dict(
        checkpoints.params_from_jax(jax.device_get(state.params)), strict=True)
    st = tr.create_train_state(pm, seed=0, device="cpu")
    step = tr.build_train_step(pm, st.optimizer, weights=weights)
    loss = step(st, LR, x2d, x3d, t=t, noise=noise, masks=masks)
    return dict(jloss=float(jloss), jloss_step=float(jloss2), loss=float(loss),
                jgrads=checkpoints.params_from_jax(jax.device_get(jgrads)),
                jparams=checkpoints.params_from_jax(
                    jax.device_get(state2.params)),
                port=pm, masks=masks)


def test_replayed_masks_drop_some_branches(one_step):
    values = np.concatenate([np.concatenate(pair) for part in
                             one_step["masks"].values() for pair in part])
    assert np.any(values == 0.0) and np.any(values > 1.0)


def test_train_step_loss_matches_jax(one_step):
    assert one_step["jloss"] == one_step["jloss_step"]
    assert abs(one_step["loss"] - one_step["jloss"]) <= 1e-5 * one_step["jloss"]


def test_train_step_grads_match_jax(one_step):
    named = dict(one_step["port"].pose_estimator.named_parameters())
    assert named.keys() == one_step["jgrads"].keys()
    for name, p in named.items():
        want = one_step["jgrads"][name]
        err = (p.grad - want).abs().max() / want.abs().max().clamp_min(1e-30)
        assert err <= 1e-4, f"{name}: rel err {float(err):.2e}"


def test_train_step_params_after_adamw_match_jax(one_step):
    for name, p in one_step["port"].pose_estimator.named_parameters():
        err = float((p.detach() - one_step["jparams"][name]).abs().max())
        assert err <= 0.1 * LR, f"{name}: {err:.2e}"


@pytest.mark.parametrize("weighted,mse", [(False, False), (True, False),
                                          (True, True)])
def test_mpjpe_matches_jax(weighted, mse):
    r = np.random.RandomState(3)
    pred, target = (r.randn(2, 9, 134, 3).astype(np.float32) for _ in range(2))
    w = jtr.mixste_weight_table() if weighted else None
    got = losses.mpjpe(torch.from_numpy(pred), torch.from_numpy(target),
                       weights=None if w is None else torch.from_numpy(w),
                       mse_loss=mse)
    want = jlosses.mpjpe(jnp.asarray(pred), jnp.asarray(target), weights=w,
                         mse_loss=mse)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_centring_matches_jax():
    x = np.random.RandomState(4).randn(2, 9, 134, 3).astype(np.float32)
    np.testing.assert_allclose(
        geometry.center_pose_parts(torch.from_numpy(x)).numpy(),
        np.asarray(jgeom.center_pose_parts(x)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        geometry.center_pose_at_root(torch.from_numpy(x)).numpy(),
        np.asarray(jgeom.center_pose_at_root(x)), rtol=0, atol=1e-6)


def test_pad_batch_and_weight_table_match_jax():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for n in (3, 5):
        got, want = tr.pad_batch(a, n), jtr.pad_batch(a, n)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    np.testing.assert_array_equal(tr.mixste_weight_table(),
                                  jtr.mixste_weight_table())


def test_train_steps_are_deterministic_and_learn():
    """Two runs from the same seed (t and noise drawn from the state's
    generator) give identical losses and params; on one repeated batch
    (the same t and noise every step) the loss falls."""
    x2d, x3d = _batch(1)

    def run(steps, lr, **draws):
        m = D3DP(D3DPConfig(**dict(KW, depth=1)), device="cpu",
                 generator=torch.Generator().manual_seed(0))
        st = tr.create_train_state(m, seed=0, device="cpu")
        step = tr.build_train_step(m, st.optimizer)
        losses = [float(step(st, lr, x2d, x3d, **draws)) for _ in range(steps)]
        return losses, [p.detach().clone() for p in m.parameters()]

    (l1, p1), (l2, p2) = run(4, 1e-3), run(4, 1e-3)
    assert l1 == l2 and len(set(l1)) == 4
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    noise = np.random.RandomState(2).randn(*x3d.shape).astype(np.float32)
    fit, _ = run(8, 1e-4, t=np.array([3, 40]), noise=noise)
    assert np.mean(fit[-3:]) < fit[0], fit


def test_dropout_in_training_is_refused():
    """The training kernels have no dropout: a model with dropout > 0 is
    refused by them and trains on the autodiff path, with train_kernel at
    auto as JAX chooses (``mixste.py:326-332``); the kernel block is never
    called and the step is finite."""
    m = D3DP(D3DPConfig(**dict(KW, depth=1, dropout=0.1)), device="cpu")
    assert m.train_path == "autodiff"
    assert D3DP(D3DPConfig(**dict(KW, depth=1)),
                device="cpu").train_path == "kernels"

    def refuse(*_):
        raise AssertionError("the kernel block ran with dropout")

    for net in m.pose_estimator.values():
        net.train_block_fn = refuse
    st = tr.create_train_state(m, device="cpu")
    step = tr.build_train_step(m, st.optimizer)
    loss = float(step(st, 1e-4, *_batch(2)))
    assert np.isfinite(loss)


def test_train_forward_needs_train_mode():
    m = D3DP(D3DPConfig(**dict(KW, depth=1)), device="cpu")
    x2d, x3d = _batch(3)
    with pytest.raises(RuntimeError, match="train mode"):
        m.train_forward(torch.from_numpy(x2d), torch.from_numpy(x3d))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_forward_draws_through_draw_train(dropout):
    """``D3DP.draw_train`` is the one owner of a training forward's draw
    order (the data-parallel step draws the global batch through it): a
    forward that draws for itself equals one handed ``draw_train``'s draws
    from an equally seeded generator, bit for bit, and leaves the
    generator in the same state; the part networks draw nothing, so in
    train mode they refuse to run without masks."""
    m = D3DP(D3DPConfig(**dict(KW, depth=1, dropout=dropout)), device="cpu",
             generator=torch.Generator().manual_seed(0))
    m.train()
    x2d, x3d = (torch.from_numpy(a) for a in _batch(4))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    with torch.no_grad():
        own = m.train_forward(x2d, x3d, generator=g1)
        t, noise, masks, drop = m.draw_train(x3d.shape, "cpu", g2)
        given = m.train_forward(x2d, x3d, t=t, noise=noise, masks=masks,
                                dropout_masks=drop)
        assert (drop is not None) == (dropout > 0)
        assert torch.equal(own, given)
        assert torch.equal(g1.get_state(), g2.get_state())
        with pytest.raises(ValueError, match="mask pairs"):
            m.pose_estimator(x2d, x3d, t)
