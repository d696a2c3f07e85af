"""Port training data path and checkpoints against the JAX package.

* ``load_real`` on a fabricated release-format npz gives the JAX arrays
  and flip table exactly (NumPy on both sides).
* ``make_synthetic`` / ``prepare_data`` / ``fetch`` give the JAX arrays
  within 2e-6 x max|value| (float32; the JAX camera projection runs in XLA,
  whose cross products and fused multiply-adds round differently: measured
  ~4e-7 relative); world poses, sequence lengths, names and cameras are
  identical.
* ``ChunkedSampler`` with ``augment=True`` and the same seed gives
  **identical** batches (cameras, 3D, 2D) to the JAX sampler's NumPy path
  over two epochs, and ``PrefetchingLoader`` yields the same sequence.
* A port ``save_state`` is read by the JAX ``load_state`` into equal params;
  a port round trip restores params, AdamW state, epoch, lr, the sampler's
  RandomState and the training generator.
* ``chip_smoke.py``'s train phase runs end to end on the CPU at a small
  size (its checks hold there except the launch counts, which are 0).
"""

import numpy as np
import pytest
import torch

from pafuse_tpu import checkpoints as jax_ckpt
from pafuse_tpu.data import h3wb as jh3wb, sampling as jsampling
from pafuse_tpu.diffusion import D3DP as JaxD3DP, D3DPConfig as JaxConfig
from pafuse_tpu.runtime import PrefetchingLoader as JaxLoader
import jax

from pafuse_tpu_torch import checkpoints, train as tr
from pafuse_tpu_torch.data import h3wb, sampling
from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

torch.set_num_threads(2)

SYNTH = dict(subjects=("S1", "S5"), actions_per_subject=2,
             frames_per_action=61, seed=3)
REL = 2e-6


@pytest.fixture(scope="module")
def datasets():
    port, ref = h3wb.make_synthetic(**SYNTH), jh3wb.make_synthetic(**SYNTH)
    return port, ref, h3wb.prepare_data(port), jh3wb.prepare_data(ref)


def _close(a, b):
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=0, atol=REL * np.abs(b).max())


def test_synthetic_and_prepared_data_match_jax(datasets):
    port, ref, kp, jkp = datasets
    assert list(port.subjects()) == list(ref.subjects())
    np.testing.assert_array_equal(port.flip_permutation, ref.flip_permutation)
    for s in port.subjects():
        assert list(port[s].keys()) == list(ref[s].keys())
        for a in port[s]:
            np.testing.assert_array_equal(port[s][a]["positions"],
                                          ref[s][a]["positions"])
            for p, q in zip(port[s][a]["positions_3d"],
                            ref[s][a]["positions_3d"]):
                _close(p, q)
            for p, q in zip(kp[s][a], jkp[s][a]):
                _close(p, q)


@pytest.mark.parametrize("kw", [dict(), dict(stride=2),
                                dict(subset=0.5, action_filter=["Sitting"])])
def test_fetch_matches_jax(datasets, kw):
    port, ref, kp, jkp = datasets
    got = h3wb.fetch(["S1", "S5"], kp, port, **kw)
    want = jh3wb.fetch(["S1", "S5"], jkp, ref, **kw)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _close(a, b)


def test_fetch_actions_matches_jax(datasets):
    port, ref, kp, jkp = datasets
    actions = [("S5", a) for a in kp["S5"]]
    for g, w in zip(h3wb.fetch_actions(actions, kp, port, stride=3),
                    jh3wb.fetch_actions(actions, jkp, ref, stride=3)):
        for a, b in zip(g, w):
            _close(a, b)


@pytest.mark.parametrize("swap_right", [False, True])
def test_load_real_matches_jax(tmp_path, swap_right):
    """A fabricated release-format npz (133 joints, per-camera dicts,
    metadata) loads to the same arrays and flip table on both sides, also
    when the metadata pairs joints differently from the static tables."""
    from test_real_format import _make_reference_npz
    _make_reference_npz(tmp_path)
    if swap_right:
        raw = np.load(tmp_path / "train_h3wb.npz", allow_pickle=True)
        meta = raw["metadata"].item()
        meta["right_side"][:2] = meta["right_side"][1::-1]
        np.savez(tmp_path / "train_h3wb.npz", train_data=raw["train_data"],
                 metadata=np.array(meta, dtype=object))
    port = h3wb.load_dataset(str(tmp_path), synthetic="auto")
    ref = jh3wb.load_real(str(tmp_path))
    np.testing.assert_array_equal(port.flip_permutation, ref.flip_permutation)
    assert swap_right != np.array_equal(port.flip_permutation,
                                        jh3wb.sk.FLIP_PERMUTATION)
    assert list(port.subjects()) == list(ref.subjects())
    for s in port.subjects():
        for a in port[s]:
            for key in ("positions_3d", "pose_2d"):
                for p, q in zip(port[s][a][key], ref[s][a][key]):
                    np.testing.assert_array_equal(p, q)
            np.testing.assert_array_equal(port[s][a]["positions"],
                                          ref[s][a]["positions"])


def _samplers(datasets, batch_size=5):
    port, _, kp, _ = datasets
    cams, p3d, p2d = h3wb.fetch(["S1", "S5"], kp, port)
    mine = sampling.ChunkedSampler(batch_size, cams, p3d, p2d, 9,
                                   shuffle=True, augment=True)
    ref = jsampling.ChunkedSampler(batch_size, cams, p3d, p2d, 9,
                                   shuffle=True, augment=True,
                                   use_native=False)
    return mine, ref


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_chunked_sampler_gives_identical_batches(datasets):
    mine, ref = _samplers(datasets)
    np.testing.assert_array_equal(mine.pairs, ref.pairs)
    assert mine.batch_num() == ref.batch_num()
    for _ in range(2):          # the shuffle order advances per epoch
        got, want = list(mine.next_epoch()), list(ref.next_epoch())
        _assert_same_batches(got, want)
    assert any(np.any(b[2][..., 0] < 0) for b in got)    # flipped rows


def test_prefetching_loader_yields_the_same_sequence(datasets):
    mine, ref = _samplers(datasets)
    got = list(PrefetchingLoader(mine, depth=2).next_epoch())
    _assert_same_batches(got, list(JaxLoader(ref, depth=2).next_epoch()))
    assert PrefetchingLoader(mine).batch_num() == mine.batch_num()
    # leaving an epoch early stops the producer thread
    loader = PrefetchingLoader(mine, depth=1)
    for _ in loader.next_epoch():
        break


KW = dict(frames=9, depth=1, timesteps=50, drop_path_rate=0.1)


def test_port_checkpoint_loads_into_jax(tmp_path):
    model = D3DP(D3DPConfig(**KW), device="cpu",
                 generator=torch.Generator().manual_seed(4))
    path = checkpoints.save_state(str(tmp_path), "epoch_1", model=model,
                                  epoch=1, lr=3e-4)
    template = JaxD3DP(JaxConfig(**KW)).init_params(jax.random.PRNGKey(0))
    restored = jax_ckpt.load_state(path, template)
    assert restored["epoch"] == 1 and restored["lr"] == 3e-4
    got = checkpoints.params_from_jax(restored["params"])
    want = model.pose_estimator.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_port_checkpoint_round_trip(tmp_path, datasets):
    x2d = np.random.RandomState(0).randn(2, 9, 134, 2).astype(np.float32)
    x3d = np.random.RandomState(1).randn(2, 9, 134, 3).astype(np.float32) * .1
    model = D3DP(D3DPConfig(**KW), device="cpu")
    st = tr.create_train_state(model, seed=5, device="cpu")
    tr.build_train_step(model, st.optimizer)(st, 1e-3, x2d, x3d)
    mine, _ = _samplers(datasets)
    list(mine.next_epoch())
    path = checkpoints.save_state(str(tmp_path), "best_epoch", model=model,
                                  optimizer=st.optimizer, epoch=7, lr=2e-4,
                                  random_state=mine.random_state(),
                                  generator=st.generator)

    fresh = D3DP(D3DPConfig(**KW), device="cpu",
                 generator=torch.Generator().manual_seed(9))
    st2 = tr.create_train_state(fresh, seed=0, device="cpu")
    out = checkpoints.load_state(path, model=fresh, optimizer=st2.optimizer,
                                 generator=st2.generator)
    assert out["epoch"] == 7 and out["lr"] == 2e-4
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    s1, s2 = st.optimizer.state_dict(), st2.optimizer.state_dict()
    assert s1["state"].keys() == s2["state"].keys()
    for i in s1["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1["state"][i][k], s2["state"][i][k])
    assert all(g["lr"] == 2e-4 for g in st2.optimizer.param_groups)
    assert torch.equal(st.generator.get_state(), st2.generator.get_state())
    assert np.array_equal(out["random_state"].permutation(50),
                          mine.random_state().permutation(50))
    # the restored state takes the same next step
    step1 = tr.build_train_step(model, st.optimizer)
    step2 = tr.build_train_step(fresh, st2.optimizer)
    assert float(step1(st, 1e-3, x2d, x3d)) == float(step2(st2, 1e-3, x2d, x3d))


def test_chip_smoke_train_phase_rehearses_on_cpu(capsys):
    """chip_smoke.py's train phase end to end on the CPU at depth 1 and two
    sequences a step: synthetic H3WB through the sampler and the prefetch
    loader, finite losses, moved params, bit-identical repeat runs, kernel
    path (here the plain versions) vs plain path, and the loss falling on
    one batch.  Launch counts are 0 on the CPU."""
    import importlib.util
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.train_phase(0, device="cpu", depth=1, seqs=2,
                                  steps=2) == (0, 0)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == [
        "train", "train_determinism", "train_vs_plain", "train_overfit"]

