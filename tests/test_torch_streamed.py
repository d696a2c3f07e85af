"""MixSTE's 243-frame, 512-wide monolithic model (``general.part_based_model=
false model.cs=512 model.number_of_frames=243``): one training step against
the JAX package, at depth 1 on 17 joints and one sequence, so that the
temporal attention's L = 243 at head size 64 (the shape the tensor-core
attention streams through shared memory on the card) appears at CPU cost.

The JAX step is ``build_train_step``'s loss (root-centred MPJPE, XLA
autodiff on the CPU, where its train kernel declines); the port's step runs
every block through ``ops.block_train``'s plain versions (the CPU path).
Both start from the same seeded JAX params, carried across by
``checkpoints.params_from_jax`` (which this also holds at C = 512: the
state dict round-trips through ``params_to_jax`` bit for bit), and the port
is handed the JAX step's t, noise and stochastic-depth masks, replayed from
its key as tests/test_torch_train.py replays them.

Tolerances are tests/test_torch_train_paths.py's float32 ones: loss 1e-5
relative, gradients 1e-4 x max|JAX gradient| per tensor (the same float32
function, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import geometry as jgeom, losses as jlosses
from pafuse_tpu import skeleton as jsk, train as jtr
from pafuse_tpu.diffusion import D3DP as JaxD3DP, D3DPConfig as JaxConfig
from pafuse_tpu.models import mixste as jmixste
from pafuse_tpu_torch import checkpoints, skeleton as sk, train as tr
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

KW = dict(frames=243, num_kps=17, cs=512, depth=1, part_based=False,
          timesteps=50, drop_path_rate=0.1)
B, LR = 1, 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _replay_draws(model, rng, x3d):
    """t, noise and masks of the JAX step whose state key is ``rng`` (the
    draws of tests/test_torch_train.py's replay at this batch)."""
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
    jm = JaxD3DP(JaxConfig(**KW), flip_permutation=jsk.FLIP_PERMUTATION_3DHP)
    state, _ = jtr.create_train_state(jm, seed=0)
    r = np.random.RandomState(0)
    x2d = r.uniform(-1, 1, (B, 243, 17, 2)).astype(np.float32)
    x3d = (r.randn(B, 243, 17, 3) * 0.1).astype(np.float32)
    step_rng, t, noise, masks = _replay_draws(jm, state.rng, x3d)
    x3d_c = jgeom.center_pose_at_root(jnp.asarray(x3d))

    def loss_fn(params):
        pred = jm.train_forward(params, step_rng, jnp.asarray(x2d), x3d_c)
        return jlosses.mpjpe(pred, x3d_c)

    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    params = jax.device_get(state.params)

    pm = D3DP(D3DPConfig(**KW), device="cpu",
              flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    sd = checkpoints.params_from_jax(params)
    pm.pose_estimator.load_state_dict(sd, strict=True)
    st = tr.create_train_state(pm, seed=0, device="cpu")
    step = tr.build_train_step(pm, st.optimizer, part_based=False)
    loss = step(st, LR, x2d, x3d, t=t, noise=noise, masks=masks)
    return dict(jloss=float(jloss), loss=float(loss), port=pm, sd=sd,
                jgrads=checkpoints.params_from_jax(jax.device_get(jgrads)))


def test_params_carry_across_at_512_channels(one_step):
    sd = one_step["sd"]
    for blocks in ("STEblocks", "TTEblocks"):
        assert sd[f"whole_body.{blocks}.0.attn.qkv.weight"].shape == (1536,
                                                                       512)
    back = checkpoints.params_from_jax(checkpoints.params_to_jax(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_243_frame_step_loss_matches_jax(one_step):
    assert np.isfinite(one_step["loss"])
    assert abs(one_step["loss"] - one_step["jloss"]) <= (
        LOSS_RTOL * abs(one_step["jloss"]))


def test_243_frame_step_grads_match_jax(one_step):
    named = dict(one_step["port"].pose_estimator.named_parameters())
    assert named.keys() == one_step["jgrads"].keys()
    for name, p in named.items():
        want = one_step["jgrads"][name]
        err = (p.grad - want).abs().max() / want.abs().max().clamp_min(1e-30)
        assert err <= GRAD_RTOL, f"{name}: rel err {float(err):.2e}"
