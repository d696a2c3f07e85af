"""Packed-parts execution of the port (``models/packed.py``,
``PartModel(packed=)``, ``D3DP(packed_parts=)``) against the JAX package's
packed path and against the port's own unpacked path.

Weights: the JAX ``PartModel.init_params`` tree with every leaf perturbed
(non-zero position embeddings, non-trivial LayerNorm affines), carried to
the port by ``checkpoints.params_from_jax``.  Depth 2, 9 frames, B=2, with
merged and with split hands (three and four parts).  The JAX models are
built with ``PAFUSE_EXPERIMENTAL_KERNELS=1`` set for them alone; the port
passes ``experimental_kernels=True``.  The float32 JAX calls are jitted;
the bfloat16 ones run eagerly, so that every JAX operation rounds as its
source says (jitted XLA on the CPU keeps float32 across some bfloat16
roundings, ``tests/test_torch_bf16.py``).

Float32 bounds are ``tests/test_packed.py``'s: the forward within atol =
rtol = 1e-5 of JAX's ``packed_forward`` and of the port's unpacked path,
``ddim_sample`` with injected noise within atol 2e-5, rtol 1e-4.

bfloat16 (the JAX module's rounding points), max abs and mean abs, and the
share of elements that differ at all:
  one block  the first spatial block of every part from JAX's own bf16
             input (the embedded tokens): max 0.125, mean 1e-3, share 0.1
             (measured 0.0625, 2.3e-4, 0.035 on the real channels: float32
             sums in another order flip a bf16 ulp of ~3.5% of the
             outputs, and one ulp at |y| in [8, 16) is 2^-4).  The same
             block computed in float32 and rounded once differs in 65% of
             the elements with mean 4.7e-3, so a rounding point left out
             fails the mean and the share;
  forward    max 5e-2, mean 8e-3 (measured 2.4e-2, 4.7e-3).  Four blocks
             deep the flips grow to bf16's own noise: JAX's eager forward
             and its jit forward (both rounding every operation) differ by
             2.4e-2 / 4.6e-3, and the float32 forward is 5.8e-3 (mean)
             from the bf16 one, so this catches gross faults only (a wrong
             gather, a missing mask).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pafuse_tpu import diffusion as jd
from pafuse_tpu import skeleton as jsk
from pafuse_tpu.models import packed as jpk
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from pafuse_tpu_torch.models import packed as pk
from pafuse_tpu_torch.models.mixste import _layernorm
from test_torch_mixste import _perturbed

torch.set_num_threads(2)

B, F = 2, 9
KW = dict(frames=F, timesteps=20, sampling_timesteps=2, num_proposals=2,
          depth=2)
BLOCK_BF16_TOL = (0.125, 1e-3, 0.1)      # max, mean, share differing
FORWARD_BF16_TOL = (5e-2, 8e-3)          # max, mean


def _jax_model(merge, packed, compute_dtype=jnp.float32):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAFUSE_EXPERIMENTAL_KERNELS", "1")
        return jd.D3DP(jd.D3DPConfig(merge_hands=merge, **KW),
                       packed_parts=packed, compute_dtype=compute_dtype)


def _port_model(merge, params, packed=True, **kw):
    model = D3DP(D3DPConfig(merge_hands=merge, **KW), device="cpu",
                 packed_parts=packed, experimental_kernels=packed, **kw)
    model.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                         strict=True)
    return model


@pytest.fixture(scope="module", params=[True, False],
                ids=["merged_hands", "split_hands"])
def models(request):
    merge = request.param
    jax_packed = _jax_model(merge, True)
    params = _perturbed(jax_packed.init_params(jax.random.PRNGKey(0)), 1)
    return (merge, jax_packed, params, _port_model(merge, params),
            _port_model(merge, params, packed=False))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (B, F, 134, 2)).astype(np.float32),
            rng.randn(B, F, 134, 3).astype(np.float32),
            rng.randint(0, 20, (B,)).astype(np.int32))


def _port(model, x2d, x3d, t):
    with torch.no_grad():
        return model.pose_estimator(torch.from_numpy(x2d),
                                    torch.from_numpy(x3d),
                                    torch.from_numpy(t)).numpy()


def test_packed_forward_matches_jax(models):
    _, jax_packed, params, packed, _ = models
    x2d, x3d, t = _inputs()
    ref = np.asarray(jax.jit(jax_packed.model)(
        params, jnp.asarray(x2d), jnp.asarray(x3d), jnp.asarray(t)))
    out = _port(packed, x2d, x3d, t)
    assert out.shape == ref.shape == (B, F, 134, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_packed_forward_matches_unpacked(models):
    _, _, _, packed, unpacked = models
    x2d, x3d, t = _inputs(1)
    np.testing.assert_allclose(_port(packed, x2d, x3d, t),
                               _port(unpacked, x2d, x3d, t),
                               atol=1e-5, rtol=1e-5)


def test_packed_sampler_matches_jax_and_packs_once(models, monkeypatch):
    _, jax_packed, params, packed, _ = models
    rng = np.random.RandomState(1)
    x2d = rng.uniform(-1, 1, (B, F, 134, 2)).astype(np.float32)
    x2d_flip = (x2d[:, :, jsk.FLIP_PERMUTATION] * [-1, 1]).astype(np.float32)
    H, S = 2, 2
    init_noise = rng.randn(B, H, F, 134, 3).astype(np.float32)
    step_noise = rng.randn(S, B, H, F, 134, 3).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda p, a, b, i, s: jax_packed.ddim_sample(
            p, jax.random.PRNGKey(2), a, b, init_noise=i, step_noise=s))(
        params, x2d, x2d_flip, init_noise, step_noise))

    calls = []
    pack = pk.pack_params
    monkeypatch.setattr(pk, "pack_params",
                        lambda *a: calls.append(1) or pack(*a))
    out = packed.ddim_sample(torch.from_numpy(x2d),
                             torch.from_numpy(x2d_flip),
                             init_noise=torch.from_numpy(init_noise),
                             step_noise=torch.from_numpy(step_noise)).numpy()
    assert out.shape == ref.shape == (B, S, H, F, 134, 3)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
    assert len(calls) == 1, "ddim_sample packs once for its S steps"


@pytest.fixture(scope="module")
def bf16_models():
    jax_packed = _jax_model(True, True, jnp.bfloat16)
    params = _perturbed(jax_packed.init_params(jax.random.PRNGKey(0)), 1)
    return jax_packed, params, _port_model(True, params,
                                           compute_dtype=torch.bfloat16)


def _within(err, tol, what):
    assert err.max() <= tol[0] and err.mean() <= tol[1], (
        what, err.max(), err.mean())


def test_packed_bf16_block_matches_jax(bf16_models):
    jax_packed, params, model = bf16_models
    specs = jax_packed.model.specs
    plan = jpk.make_pack_plan(specs)
    pp_j = jpk.pack_params(params, specs, plan)
    x2d, x3d, t = _inputs(2)
    gather = jnp.asarray(plan.joint_gather)
    cd = jnp.bfloat16

    def embed(pp, a, b):            # the first lines of _forward_one_part
        x = jnp.concatenate([a, b], axis=-1).astype(cd)
        x = jpk._linear(pp["Spatial_patch_to_embedding"], x, cd)
        return x + pp["Spatial_pos_embed"][None].astype(cd)

    def block(pp, x, c_p, key_mask):
        return jpk._packed_block(pp["STEblocks"][0], x, plan.num_heads, cd,
                                 c_p, plan.c_max, key_mask)

    parts = [jnp.moveaxis(jnp.take(jnp.asarray(a), gather, axis=-2), -3, 0)
             for a in (x2d, x3d)]
    x_in = jax.vmap(embed)(pp_j, *parts)
    ref = np.asarray(jax.vmap(block)(
        pp_j, x_in, jnp.asarray(plan.c_real),
        jnp.asarray(plan.key_mask)).astype(jnp.float32))

    packed = model.pose_estimator.prepare()
    tab = packed["tables"]
    x = torch.tensor(np.asarray(x_in.astype(jnp.float32)))
    out = pk._packed_block(packed["STEblocks"][0], x.to(torch.bfloat16),
                           plan.num_heads, torch.bfloat16, tab["c_real"],
                           plan.c_max, tab["key_mask"]).float().numpy()
    real = np.zeros(ref.shape, bool)
    for p, (j, c) in enumerate(zip(plan.j_real, plan.c_real)):
        real[p, ..., :j, :c] = True
    err = np.abs(out - ref)[real]
    _within(err, BLOCK_BF16_TOL, "block")
    assert (err > 0).mean() <= BLOCK_BF16_TOL[2], (err > 0).mean()


def test_packed_bf16_forward_matches_jax(bf16_models):
    jax_packed, params, model = bf16_models
    x2d, x3d, t = _inputs()
    ref = np.asarray(jax_packed.model(params, jnp.asarray(x2d),
                                      jnp.asarray(x3d), jnp.asarray(t),
                                      compute_dtype=jnp.bfloat16))
    out = _port(model, x2d, x3d, t)
    assert out.dtype == np.float32 and out.shape == ref.shape
    _within(np.abs(out - ref), FORWARD_BF16_TOL, "forward")


def test_padded_channels_stay_zero():
    """The invariant the masked LayerNorm's closed form rests on: the
    packed stream's padded channels are exactly zero after the embedding
    and after the masked LayerNorm, which equals LayerNorm on the real
    channels."""
    model = D3DP(D3DPConfig(depth=1, frames=F), device="cpu",
                 generator=torch.Generator().manual_seed(3),
                 packed_parts=True, experimental_kernels=True)
    net = model.pose_estimator
    with torch.no_grad():
        for p in net.parameters():       # non-trivial affines and biases
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator()
                                      .manual_seed(p.numel())))
    packed, plan = net.prepare(), net._plan
    x2d, x3d, _ = _inputs(4)
    face = plan.names.index("face")
    c_p = int(plan.c_real[face])
    assert c_p == 224 < plan.c_max
    idx = torch.as_tensor(plan.joint_gather[face], dtype=torch.long)
    x = torch.cat([torch.from_numpy(x2d)[..., idx, :],
                   torch.from_numpy(x3d)[..., idx, :]], dim=-1)[None]
    emb = {k: v[face:face + 1]
           for k, v in packed["Spatial_patch_to_embedding"].items()}
    y = pk._linear(emb, x, torch.float32)
    assert torch.equal(y[..., c_p:], torch.zeros_like(y[..., c_p:]))
    norm = {k: v[face:face + 1]
            for k, v in packed["STEblocks"][0]["norm1"].items()}
    ln = pk._masked_layernorm(norm, y, torch.tensor([float(c_p)]),
                              plan.c_max)
    assert torch.equal(ln[..., c_p:], torch.zeros_like(ln[..., c_p:]))
    n1 = net["face"].STEblocks[0].norm1
    torch.testing.assert_close(ln[..., :c_p],
                               _layernorm(y[..., :c_p], n1.weight.detach(),
                                          n1.bias.detach()),
                               atol=1e-5, rtol=0)


def test_packed_parts_need_the_experimental_gate():
    with pytest.raises(ValueError, match="EXPERIMENTAL"):
        D3DP(D3DPConfig(**KW), device="cpu", packed_parts=True)
    # a monolithic model has one network: nothing to pack, no gate
    mono = D3DP(D3DPConfig(part_based=False, num_kps=17, cs=32, **KW),
                device="cpu", packed_parts=True,
                flip_permutation=np.arange(17))
    assert not mono.pose_estimator.packed
    assert mono.pose_estimator.prepare() is None


def test_train_mode_stays_unpacked():
    """Training runs the part networks (stochastic depth): a packed model's
    train step equals the unpacked one's bit for bit, and ``prepare`` packs
    nothing in train mode."""
    cfg = D3DPConfig(drop_path_rate=0.1, **KW)
    outs = []
    for packed in (True, False):
        model = D3DP(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0),
                     packed_parts=packed, experimental_kernels=packed,
                     train_kernel="false").train()
        assert model.pose_estimator.prepare(train=True) is None
        x2d, x3d, _ = _inputs(5)
        pred = model.train_forward(
            torch.from_numpy(x2d), torch.from_numpy(x3d) * 0.1,
            generator=torch.Generator().manual_seed(7))
        pred.square().mean().backward()
        outs.append((pred.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
