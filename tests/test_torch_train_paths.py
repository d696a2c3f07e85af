"""The port's training paths against the JAX package: kernels #5/#6 and
the autodiff path (``train_kernel=false``), float32 and bfloat16, dropout,
and ``remat``.

One step from equal params at depth 1, 9 frames, the published part widths
and ``drop_path_rate`` 0.1, as tests/test_torch_train.py does it: the port
is handed the JAX step's t, noise and stochastic-depth masks, replayed from
its key, and here also its dropout masks (``fold_in(part key, 0x0d0d)``,
``mixste.py:313-321``, and the splits of ``_block``, ``_attention`` and
``_mlp``).  The JAX side runs in a subprocess whose XLA rounds every
bfloat16 operation (``test_torch_bf16.run_strict_jax``); its kernel path is
``block_grad.block_train_apply`` with both Pallas kernels in interpret mode
(on the CPU the JAX selector would decline them).  The params after AdamW
come from the JAX optimizer's update on the JAX gradients.

Tolerances (loss relative; gradients per tensor relative to max|JAX
gradient|; params after AdamW max abs):
  float32 (autodiff; dropout): loss 1e-5, gradients 1e-4, the bounds of
      tests/test_torch_train.py (the same float32 function, sums in
      another order; measured 7e-8 and 1e-6); params 0.1 x lr but for at
      most one weight in 10^6, which may be 0.5 x lr apart: Adam's first
      step is lr x g / (|g| + 1e-8), so where |g| is near 1e-8 a float32
      difference in g moves the step by a sizable fraction of lr (measured
      one weight of 5.3 million at 0.14 x lr on the autodiff path, none
      with dropout);
  bfloat16, kernels and autodiff: loss 1e-4 (measured 1.1e-6 and 1.1e-5);
      gradients 3e-2 (measured at most 2.4e-2, on ``time_mlp.3``: its
      cotangent sums a bfloat16 one over F x N tokens, which this XLA adds
      in bfloat16 and torch in float32; median over tensors 4e-5 on the
      kernel path, 8e-4 on the autodiff path, bounded at 2e-3); params
      2.1 x lr: Adam's first step moves a weight by ~lr x sign(g), so a
      gradient near zero whose sign differs by a bfloat16 ulp moves it the
      other way, at most 2 lr apart, and at most 1% of the weights may be
      more than 0.1 x lr apart (measured 2.0 x lr, and 0.07% and 0.13%).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from pafuse_tpu_torch import checkpoints, train as tr
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from test_torch_bf16 import flat, run_strict_jax, unflat

torch.set_num_threads(2)

KW = dict(frames=9, depth=1, timesteps=50, drop_path_rate=0.1)
B, LR = 2, 1e-4
CASES = {"autodiff_f32": ("false", "float32", 0.0),
         "dropout_f32": ("auto", "float32", 0.1),
         "kernels_bf16": ("true", "bfloat16", 0.0),
         "autodiff_bf16": ("false", "bfloat16", 0.0)}
F32 = dict(loss=1e-5, grad=1e-4, grad_median=1e-4, param=0.5 * LR,
           param_frac=1e-6)
BF16 = dict(loss=1e-4, grad=3e-2, grad_median=2e-3, param=2.1 * LR,
            param_frac=1e-2)


def _batch():
    r = np.random.RandomState(0)
    return (r.randn(B, 9, 134, 2).astype(np.float32),
            (r.randn(B, 9, 134, 3) * 0.1).astype(np.float32))


def replay_dropout(jm, step_rng, batch):
    """The keep masks of the JAX model's dropout sites in the step whose key
    is ``step_rng``, in ``models.mixste.draw_dropout_masks``'s layout."""
    import jax
    _, r_drop = jax.random.split(step_rng)
    out = {}
    for s, key in zip(jm.model.specs, jax.random.split(r_drop,
                                                       len(jm.model.specs))):
        c = s.config
        F_, N, C, H = c.num_frames, c.num_joints, c.embed_dim, c.num_heads
        hidden = int(C * c.mlp_ratio)
        keep = 1.0 - c.drop_rate
        keys = jax.random.split(jax.random.fold_in(key, 0x0d0d),
                                2 * c.depth + 2)

        def draw(k, p, shape):
            return np.asarray(jax.random.bernoulli(k, p, shape))

        blocks = []
        for j in range(2 * c.depth):
            S, L = (F_, N) if j % 2 == 0 else (N, F_)
            d1, d2 = jax.random.split(keys[j])
            r_attn, r_proj = jax.random.split(d1)
            r1, r2 = jax.random.split(d2)
            lead = (batch, S)
            blk = {"proj": draw(r_proj, keep, lead + (L, C)),
                   "fc1": draw(r1, keep, lead + (L, hidden)),
                   "fc2": draw(r2, keep, lead + (L, C))}
            if c.attn_drop_rate > 0:
                blk["attn"] = draw(r_attn, 1.0 - c.attn_drop_rate,
                                   lead + (H, L, L))
            blocks.append({k: v.reshape((batch * S,) + v.shape[2:])
                           for k, v in blk.items()})
        out[s.name] = {"pos": [draw(keys[2 * c.depth + i], keep,
                                    (batch, F_, N, C)) for i in range(2)],
                       "blocks": blocks}
    return out


def jax_train_side(out: str) -> None:
    """The JAX step of every case (run by ``run_strict_jax``)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from pafuse_tpu import geometry as jgeom, losses as jlosses
    from pafuse_tpu import train as jtr
    from pafuse_tpu.diffusion import D3DP as JaxD3DP
    from pafuse_tpu.diffusion import D3DPConfig as JaxConfig
    from pafuse_tpu.ops import block_grad
    from test_torch_train import _replay_draws

    x2d, x3d = _batch()
    res = {}
    for name, (kernel, dtype, dropout) in CASES.items():
        jm = JaxD3DP(JaxConfig(**KW, dropout=dropout),
                     compute_dtype=getattr(jnp, dtype),
                     train_block_fn=(block_grad.block_train_apply
                                     if kernel == "true" else None))
        state, tx = jtr.create_train_state(jm, seed=0)
        step_rng, t, noise, masks = _replay_draws(jm, state.rng, x3d)
        x3d_c = jgeom.center_pose_parts(jnp.asarray(x3d))

        def loss_fn(params):
            pred = jm.train_forward(params, step_rng, jnp.asarray(x2d), x3d_c)
            return jlosses.mpjpe(pred, x3d_c)

        with mock.patch.object(block_grad.pl, "pallas_call",
                               functools.partial(pl.pallas_call,
                                                 interpret=True)):
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
        opt = state.opt_state
        opt.hyperparams["learning_rate"] = jnp.float32(LR)
        updates, _ = tx.update(grads, opt, state.params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                        updates)
        res.update(flat(f"{name}/params0", jax.device_get(state.params)))
        res.update(flat(f"{name}/grads", jax.device_get(grads)))
        res.update(flat(f"{name}/params1", jax.device_get(params)))
        res[f"{name}/loss"] = np.asarray(loss)
        res[f"{name}/t"], res[f"{name}/noise"] = t, noise
        res.update(flat(f"{name}/masks", masks))
        if dropout:
            res.update(flat(f"{name}/dropout",
                            replay_dropout(jm, step_rng, B)))
    np.savez(out, **res)


def _tree(arrays, prefix, leaf=np.asarray):
    """The nested dict/list tree saved by ``flat`` under ``prefix``."""
    root = {}
    for k, v in arrays.items():
        if k.startswith(prefix + "/"):
            *path, last = k[len(prefix) + 1:].split("/")
            node = root
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf(v)
    return checkpoints._lists(root)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_paths") / "jax.npz")
    return run_strict_jax("test_torch_train_paths", "jax_train_side", out)


def _port_step(ref, name, **kw):
    kernel, dtype, dropout = CASES[name]
    pm = D3DP(D3DPConfig(**KW, dropout=dropout), device="cpu",
              compute_dtype=dtype, train_kernel=kernel, **kw)
    pm.pose_estimator.load_state_dict(unflat(ref, f"{name}/params0"),
                                      strict=True)
    st = tr.create_train_state(pm, seed=0, device="cpu")
    masks = {part: [tuple(pair) for pair in pairs] for part, pairs in
             _tree(ref, f"{name}/masks", torch.from_numpy).items()}
    drop = (_tree(ref, f"{name}/dropout", torch.from_numpy)
            if dropout else None)
    loss = tr.build_train_step(pm, st.optimizer)(
        st, LR, *_batch(), t=ref[f"{name}/t"], noise=ref[f"{name}/noise"],
        masks=masks, dropout_masks=drop)
    return pm, float(loss)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax(jax_steps, name):
    pm, loss = _port_step(jax_steps, name)
    assert pm.train_path == ("kernels" if CASES[name][0] == "true"
                             and not CASES[name][2] else "autodiff")
    tol = BF16 if CASES[name][1] == "bfloat16" else F32
    want = float(jax_steps[f"{name}/loss"])
    assert abs(loss - want) <= tol["loss"] * want, (loss, want)

    grads, params = (unflat(jax_steps, f"{name}/{k}")
                     for k in ("grads", "params1"))
    named = dict(pm.pose_estimator.named_parameters())
    assert named.keys() == grads.keys()
    errs = {}
    for n, p in named.items():
        errs[n] = float((p.grad - grads[n]).abs().max()
                        / grads[n].abs().max().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["grad"], (worst, errs[worst])
    assert np.median(list(errs.values())) <= tol["grad_median"]
    diffs = torch.cat([(p.detach() - params[n]).abs().flatten()
                       for n, p in named.items()])
    assert float(diffs.max()) <= tol["param"], float(diffs.max())
    assert float((diffs > 0.1 * LR).float().mean()) <= tol["param_frac"]


def test_replayed_dropout_masks_drop_some_units(jax_steps):
    drop = _tree(jax_steps, "dropout_f32/dropout")
    kept = np.concatenate([b["fc1"].ravel() for part in drop.values()
                           for b in part["blocks"]])
    assert 0.85 < kept.mean() < 0.95


def test_remat_gives_identical_gradients(jax_steps):
    """``remat`` recomputes each layer of the autodiff path in the backward:
    the same loss and gradients bit for bit, float32 and bfloat16, with
    dropout too (its masks are drawn before the layers)."""
    for name in ("autodiff_f32", "autodiff_bf16", "dropout_f32"):
        runs = [_port_step(jax_steps, name, remat=remat)
                for remat in (False, True)]
        assert runs[0][1] == runs[1][1], name
        for (n, a), b in zip(runs[0][0].named_parameters(),
                             runs[1][0].parameters()):
            assert torch.equal(a.grad, b.grad), (name, n)


def test_dropout_steps_repeat_from_a_seed():
    """Dropout masks drawn from the step's generator: two runs from one
    seed take identical steps, and another seed differs."""
    x2d, x3d = _batch()

    def run(seed):
        m = D3DP(D3DPConfig(**dict(KW, dropout=0.2)), device="cpu")
        st = tr.create_train_state(m, seed=seed, device="cpu")
        step = tr.build_train_step(m, st.optimizer)
        return [float(step(st, 1e-3, x2d, x3d)) for _ in range(2)]

    assert run(4) == run(4) != run(5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_scales_round_as_the_keep_probability(dtype):
    """``_dropout`` and ``_drop_path`` divide by the keep probability
    rounded to x's dtype, filled on x's device (no host copy): bit for bit
    the division by ``torch.tensor(1 - rate, dtype=x.dtype)``, the form
    they had before, at rates whose keep probability rounds in bfloat16."""
    from pafuse_tpu_torch.models.mixste import _drop_path, _dropout
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 16, generator=g).to(dtype)
    keep = torch.rand(6, 5, 16, generator=g) >= 0.3
    rows = (torch.rand(6, generator=g) >= 0.3).float()
    for rate in (0.1, 0.2, 1 / 3, 0.37):
        scale = torch.tensor(1.0 - rate, dtype=dtype)
        assert torch.equal(_dropout(x, keep, rate),
                           torch.where(keep, x / scale, x.new_zeros(())))
        assert torch.equal(_drop_path(x, rows, rate),
                           x * rows.to(dtype).view(-1, 1, 1) / scale)
