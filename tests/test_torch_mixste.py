"""Port MixSTE2 and checkpoint loaders against the JAX package.

Weights cross through ``checkpoints.params_from_jax``, a JAX
``export_torch_state_dict`` dict and a JAX ``save_state`` npz.  Tolerance:
float32 2e-5 max abs (the bound of tests/test_mixste.py against the torch
reference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pafuse_tpu import checkpoints as jax_ckpt
from pafuse_tpu.models import mixste
from pafuse_tpu.models.parts import PartModel as JaxPartModel
from pafuse_tpu.models.parts import build_part_specs as jax_part_specs
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.models.mixste import (MixSTE2, MixSTEConfig,
                                            sinusoidal_time_embedding)

torch.set_num_threads(2)

TOL = 2e-5
CFG = dict(num_frames=9, num_joints=7, in_chans=5, embed_dim=64, depth=2,
           num_heads=8, mlp_ratio=2.0)


def _perturbed(tree, seed):
    """Init params with every leaf perturbed (non-zero position embeddings,
    non-trivial LayerNorm affines)."""
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.randn(*np.shape(a))).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def jax_params():
    p = mixste.init_mixste(jax.random.PRNGKey(0), mixste.MixSTEConfig(**CFG))
    return _perturbed(p, seed=1)


def _inputs(B=3, seed=0):
    r = np.random.RandomState(seed)
    x2d = r.randn(B, 9, 7, 2).astype(np.float32)
    x3d = r.randn(B, 9, 7, 3).astype(np.float32)
    t = np.array([0, 417, 999][:B], np.int32)
    return x2d, x3d, t


def _port(state):
    m = MixSTE2(MixSTEConfig(**CFG), device="cpu")
    m.load_state_dict(state, strict=True)
    return m


def _run_port(m, x2d, x3d, t):
    with torch.no_grad():
        return m(torch.from_numpy(x2d), torch.from_numpy(x3d),
                 torch.from_numpy(t)).numpy()


def test_sinusoidal_embedding_matches_jax():
    t = np.array([0, 1, 500, 999], np.int32)
    want = np.asarray(mixste.sinusoidal_time_embedding(jnp.asarray(t), 64))
    got = sinusoidal_time_embedding(torch.from_numpy(t), 64).numpy()
    # sin/cos arguments reach 999 rad, where the f32 spacing is 6.1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_mixste2_matches_mixste_forward(jax_params):
    x2d, x3d, t = _inputs()
    want = np.asarray(mixste.mixste_forward(
        jax_params, mixste.MixSTEConfig(**CFG), jnp.asarray(x2d),
        jnp.asarray(x3d), jnp.asarray(t)))
    got = _run_port(_port(checkpoints.params_from_jax(jax_params)), x2d, x3d, t)
    assert got.shape == (3, 9, 7, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["block_t", "layer"])
def test_mixste2_experimental_modes_match_mixste_forward(jax_params, mode):
    """use_pallas=block_t (kernel #1 on spatial blocks, #3 on temporal ones)
    and layer (kernel #4 on every layer) against mixste_forward with the
    JAX package's kernels for that mode run in Pallas interpret mode, and
    against the port's plain block (use_pallas=false)."""
    from pafuse_tpu.ops import attention
    from test_torch_block_temporal import interpret_kernels
    x2d, x3d, t = _inputs()
    hooks = ({"block_fn": attention.pallas_block,
              "block_t_fn": attention.pallas_block_temporal}
             if mode == "block_t" else {"layer_fn": attention.pallas_layer})
    with interpret_kernels():
        want = np.asarray(mixste.mixste_forward(
            jax_params, mixste.MixSTEConfig(**CFG), jnp.asarray(x2d),
            jnp.asarray(x3d), jnp.asarray(t), **hooks))
    m = _port(checkpoints.params_from_jax(jax_params))
    with pytest.raises(ValueError, match="experimental_kernels"):
        m.set_use_pallas(mode)
    m.set_use_pallas(mode, experimental_kernels=True)
    got = _run_port(m, x2d, x3d, t)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    m.set_use_pallas("false")
    np.testing.assert_allclose(got, _run_port(m, x2d, x3d, t), rtol=0,
                               atol=TOL)


def test_exported_reference_state_dict_loads_strict(jax_params):
    """A reference-named dict (JAX export) loads once the
    pose_estimator.{part}. prefix is stripped, and equals the
    params_from_jax route."""
    exported = jax_ckpt.export_torch_state_dict({"body": jax_params})
    prefix = "pose_estimator.body."
    assert all(k.startswith(prefix) for k in exported)
    ref = {k[len(prefix):]: torch.from_numpy(v) for k, v in exported.items()}
    m = _port(ref)
    x2d, x3d, t = _inputs(B=2, seed=3)
    np.testing.assert_array_equal(
        _run_port(m, x2d, x3d, t),
        _run_port(_port(checkpoints.params_from_jax(jax_params)), x2d, x3d, t))


def test_load_state_npz_matches_params_from_jax(tmp_path):
    specs = jax_part_specs({"body": list(range(5)), "face": list(range(5, 9))},
                           num_frames=9, in_chans=5, depth=1)
    tree = JaxPartModel(specs).init_params(jax.random.PRNGKey(2))
    path = jax_ckpt.save_state(str(tmp_path), "epoch_3", params=tree, epoch=3)
    loaded = checkpoints.load_state_npz(path)
    direct = checkpoints.params_from_jax(jax.device_get(tree))
    assert sorted(loaded) == sorted(direct)
    assert "body.STEblocks.0.attn.qkv.weight" in loaded
    assert loaded["face.head.1.weight"].shape == (3, 224)
    for k in direct:
        torch.testing.assert_close(loaded[k], direct[k], rtol=0, atol=0)


def test_load_reference_bin(tmp_path, jax_params):
    exported = jax_ckpt.export_torch_state_dict({"body": jax_params},
                                                schedule_timesteps=20)
    path = tmp_path / "pafuse_model.bin"
    torch.save({"model_pos": {f"module.{k}": torch.from_numpy(v)
                              for k, v in exported.items()}}, path)
    sd = checkpoints.load_reference_bin(str(path))
    assert all(k.startswith("body.") for k in sd)   # schedule buffers dropped
    m = MixSTE2(MixSTEConfig(**CFG), device="cpu")
    m.load_state_dict({k[len("body."):]: v for k, v in sd.items()}, strict=True)
