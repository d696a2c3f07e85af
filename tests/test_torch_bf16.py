"""bfloat16 model compute (``compute_dtype=bfloat16``) of the port against
the JAX package.

The JAX side runs in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (:func:`run_strict_jax`): XLA on the
CPU otherwise keeps float32 across some of the model's bfloat16 roundings,
depending on how it fuses the operations around them (tests/
test_torch_layer.py:14-23), while with the flag every JAX operation rounds
as its source says.  Against that reference the port's plain bfloat16 path
(``use_pallas=false``: ``unfused_block`` with ``unfused_attention``) rounds
at the same points bit for bit; the model's outputs then differ only in
the float32 head (measured 4.8e-7 max abs).

Cases: ``MixSTE2`` at depth 2 (C = 64, 7 joints, 9 frames, perturbed
weights) at ``use_pallas`` false, true (kernel #2's plain version against
``pallas_attention`` in Pallas interpret mode) and auto (kernel #1's plain
version against ``pallas_block`` in interpret mode), block_t (#1's and
#3's plain versions against ``pallas_block`` and ``pallas_block_temporal``)
and layer (#4's plain version against ``pallas_layer``); the part router at
depth 1 and the published widths at auto; ``D3DP.ddim_sample`` with
injected noise, flip-TTA, two DDIM steps at auto.

Tolerances, max abs and mean abs on outputs of magnitude ~1-3 (one bf16
ulp of such values is 2^-7 to 2^-6).  The mean bounds sit below the
distance of the port's float32 model from the JAX bf16 one (mean 4.1e-3
and 4.4e-3 for MixSTE2 at true and auto, 2.4e-3 for the router, 1.8e-3
for the sampler), so a compute dtype that did not take fails them:
  false  max 1e-5 (measured 4.8e-7: float32 sums of the head in another
         order);
  true   max 1e-2, mean 5e-4 (measured 3.4e-3, 5.6e-5): kernel #2 computes
         in float32 and rounds its output once, so a float32 sum in
         another order flips an output ulp of a few elements, which then
         travels through the three later blocks;
  auto   max 2e-2, mean 2e-3 (measured 1.0e-2, 8.8e-4): kernel #1 rounds
         its output and five intermediates (tests/test_torch_block.py holds
         one block to two ulps), and four blocks deep each flip feeds the
         next block;
  block_t, layer  auto's bounds (measured 1.0e-2, 8.8e-4, as auto: in
         interpret mode ``pallas_block_temporal`` and ``pallas_layer`` give
         ``pallas_block``'s output bit for bit, and so do the port's plain
         versions of #3 and #4 that of #1);
  router max 1.5e-2, mean 1.2e-3 (measured 7.9e-3, 6.7e-4) and sampler max
         1.5e-2, mean 1.4e-3 (measured 7.6e-3, 1.07e-3), at auto: the same
         flips over three networks and two DDIM steps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from pafuse_tpu_torch.models.mixste import (MixSTE2, MixSTEConfig,
                                            unfused_attention)
from pafuse_tpu_torch.ops.attention import attention_reference

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
CFG = dict(num_frames=9, num_joints=7, in_chans=5, embed_dim=64, depth=2,
           num_heads=8, mlp_ratio=2.0)
KW = dict(frames=9, num_kps=134, timesteps=1000, sampling_timesteps=2,
          num_proposals=2, depth=1)
#: (max abs, mean abs) bounds
MODE_TOL = {"false": (1e-5, 1e-5), "true": (1e-2, 5e-4), "auto": (2e-2, 2e-3),
            "block_t": (2e-2, 2e-3), "layer": (2e-2, 2e-3)}
ROUTER_TOL = (1.5e-2, 1.2e-3)
SAMPLER_TOL = (1.5e-2, 1.4e-3)


def _assert_within(err, tol, what):
    assert err.max() <= tol[0] and err.mean() <= tol[1], (
        what, err.max(), err.mean())


def run_strict_jax(module: str, func: str, out: str,
                   timeout: int = 900) -> dict:
    """``{module}.{func}(out)`` in a subprocess whose XLA rounds every
    bfloat16 operation (no excess precision); returns the npz it writes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); import jax; "
            f"jax.config.update('jax_platforms', 'cpu'); import {module}; "
            f"{module}.{func}({out!r})")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=timeout, cwd=os.path.dirname(TESTS))
    with np.load(out) as f:
        return dict(f)


def flat(prefix: str, tree) -> dict:
    """A JAX tree as npz entries under ``prefix/``."""
    return {f"{prefix}/{k}": v for k, v in checkpoints._flatten(tree).items()}


def unflat(arrays: dict, prefix: str) -> dict:
    """The port state dict of the tree saved by :func:`flat`."""
    return checkpoints._state_dict({k[len(prefix) + 1:]: v
                                    for k, v in arrays.items()
                                    if k.startswith(prefix + "/")})


def _mixste_inputs():
    r = np.random.RandomState(0)
    return (r.randn(3, 9, 7, 2).astype(np.float32),
            r.randn(3, 9, 7, 3).astype(np.float32),
            np.array([0, 417, 999], np.int32))


def _router_inputs():
    r = np.random.RandomState(5)
    return (r.uniform(-1, 1, (3, 9, 134, 2)).astype(np.float32),
            r.randn(3, 9, 134, 3).astype(np.float32),
            np.array([0, 500, 999], np.int32))


def _sampler_inputs():
    r = np.random.RandomState(1)
    x2d = r.uniform(-1, 1, (2, 9, 134, 2)).astype(np.float32)
    return (x2d, r.randn(2, 2, 9, 134, 3).astype(np.float32),
            r.randn(2, 2, 2, 9, 134, 3).astype(np.float32))


def jax_forward_side(out: str) -> None:
    """The JAX references of this file (run by :func:`run_strict_jax`)."""
    import jax
    import jax.numpy as jnp
    from pafuse_tpu import diffusion as jd
    from pafuse_tpu.models import mixste
    from pafuse_tpu.ops import attention
    from test_torch_block_temporal import interpret_kernels
    from test_torch_mixste import _perturbed

    bf16 = jnp.bfloat16
    res = {}
    p = _perturbed(mixste.init_mixste(jax.random.PRNGKey(0),
                                      mixste.MixSTEConfig(**CFG)), 1)
    res.update(flat("mixste", p))
    x2d, x3d, t = _mixste_inputs()
    hooks = {"false": {}, "true": {"attention_fn": attention.pallas_attention},
             "auto": {"block_fn": attention.pallas_block},
             "block_t": {"block_fn": attention.pallas_block,
                         "block_t_fn": attention.pallas_block_temporal},
             "layer": {"layer_fn": attention.pallas_layer}}
    with interpret_kernels():
        for mode, h in hooks.items():
            fwd = jax.jit(lambda p, a, b, c, h=h: mixste.mixste_forward(
                p, mixste.MixSTEConfig(**CFG), a, b, c, compute_dtype=bf16,
                **h))
            res[f"mixste_{mode}"] = np.asarray(fwd(p, x2d, x3d, t))

        jm = jd.D3DP(jd.D3DPConfig(**KW), compute_dtype=bf16,
                     block_fn=attention.pallas_block)
        params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
        res.update(flat("router", params))
        res["router"] = np.asarray(jax.jit(
            lambda p, a, b, c: jm.model(p, a, b, c, compute_dtype=bf16,
                                        block_fn=attention.pallas_block))(
            params, *_router_inputs()))
        x2d, init, step = _sampler_inputs()
        x2d_flip = x2d[..., jm.flip_permutation, :] * np.array(
            [-1, 1], np.float32)
        res["sampler"] = np.asarray(jm.ddim_sample(
            params, jax.random.PRNGKey(0), jnp.asarray(x2d),
            jnp.asarray(x2d_flip), init_noise=init, step_noise=step))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bf16") / "jax.npz")
    return run_strict_jax("test_torch_bf16", "jax_forward_side", out)


@pytest.mark.parametrize("mode", ["false", "true", "auto", "block_t",
                                  "layer"])
def test_mixste2_bf16_matches_jax(jax_ref, mode):
    m = MixSTE2(MixSTEConfig(**CFG), device="cpu", use_pallas=mode,
                experimental_kernels=True, compute_dtype="bfloat16")
    m.load_state_dict(unflat(jax_ref, "mixste"), strict=True)
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in _mixste_inputs()))
    assert got.dtype == torch.float32 and got.shape == (3, 9, 7, 3)
    want = jax_ref[f"mixste_{mode}"]
    _assert_within(np.abs(got.numpy() - want), MODE_TOL[mode], mode)


def test_part_model_bf16_matches_jax(jax_ref):
    """The part router at depth 1, the published widths, auto."""
    pm = D3DP(D3DPConfig(**KW), device="cpu", compute_dtype="bfloat16")
    pm.pose_estimator.load_state_dict(unflat(jax_ref, "router"), strict=True)
    with torch.no_grad():
        got = pm.pose_estimator(*(torch.from_numpy(a)
                                  for a in _router_inputs())).numpy()
    _assert_within(np.abs(got - jax_ref["router"]), ROUTER_TOL, "router")


def test_ddim_sample_bf16_matches_jax(jax_ref):
    """Two DDIM steps, flip-TTA, injected noise, auto; the sampler's
    arithmetic is float32 on both sides."""
    pm = D3DP(D3DPConfig(**KW), device="cpu", compute_dtype="bfloat16")
    pm.pose_estimator.load_state_dict(unflat(jax_ref, "router"), strict=True)
    x2d, init, step = _sampler_inputs()
    x2d_flip = x2d[..., pm.flip_permutation, :] * np.array([-1, 1],
                                                          np.float32)
    got = pm.ddim_sample(torch.from_numpy(x2d), torch.from_numpy(x2d_flip),
                         init_noise=torch.from_numpy(init),
                         step_noise=torch.from_numpy(step))
    assert got.dtype == torch.float32
    _assert_within(np.abs(got.numpy() - jax_ref["sampler"]), SAMPLER_TOL,
                   "sampler")


def test_unfused_attention_is_attention_reference_in_float32():
    """In float32 every rounding of the model's attention is a no-op: it is
    kernel #2's plain version bit for bit, so use_pallas=false keeps its
    float32 results."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 17, 64, generator=g)
    w = [torch.randn(192, 64, generator=g) * 0.1,
         torch.randn(192, generator=g) * 0.1,
         torch.randn(64, 64, generator=g) * 0.1,
         torch.randn(64, generator=g) * 0.1]
    assert torch.equal(unfused_attention(x, *w, 8),
                       attention_reference(x, *w, 8))


def test_bf16_model_keeps_float32_parameters():
    m = MixSTE2(MixSTEConfig(**CFG), device="cpu", compute_dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        MixSTE2(MixSTEConfig(**CFG), device="cpu", compute_dtype="float16")
