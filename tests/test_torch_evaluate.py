"""The port's evaluation slice (pafuse_tpu_torch.evaluate) against the JAX
package's ``evaluate_sequences`` on a tiny configuration: the part-based
model at its published widths (body 384, face 224, merged hands 256),
depth 2, 9 frames, 20 diffusion steps, P=3 hypotheses, T=2 DDIM steps, with
flip-TTA, on sequences of the synthetic H3WB test subject S8.

Both sides run ``use_pallas=true``: the JAX package's unfused block with
``pallas_attention`` (which runs its XLA path on the CPU), the port's
unfused block with ``fused_attention`` (its plain version on the CPU); and,
behind the experimental gate, ``block_t`` and ``layer``: the JAX package's
selection for each (its Pallas kernels decline on the CPU, so it runs XLA),
the port's kernels #1/#3 and #4 (their plain versions on the CPU).
Weights cross through ``checkpoints.params_from_jax``; one numpy-seeded
``noise_table`` feeds both samplers.  Batching is exercised pooled with a
tail bucket (3 windows dispatched at 3 rows of a 4-row batch), pooled
without it (a masked padded row), and per sequence (``sequence_batches``).

Bound: every metric (mm) within 1e-5 relative (measured: at most 7.3e-7).
The denoisers agree to ~1e-6 per call in float32 (tests/test_torch_mixste.py),
poses to ~1e-5 after DDIM (tests/test_torch_diffusion.py), and the metrics
are means over ~10^4 joint errors, so they agree to ~1e-6 relative; the
argmin selections (P_Best's hypothesis, J_Agg's per-joint hypothesis) are
made on errors that agree as closely.
"""

import numpy as np
import pytest
import torch

import jax

from pafuse_tpu import diffusion as jdiff, evaluate as jev
from pafuse_tpu.ops import attention as jatt
from pafuse_tpu.ops.attention import select_attention_fn, select_block_fn
from pafuse_tpu_torch import checkpoints, evaluate as tev
from pafuse_tpu_torch.data import h3wb
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from pafuse_tpu_torch.models.mixste import MixSTE2, select_block_fn as port_block

torch.set_num_threads(2)

RTOL = 1e-5
F, P, T, N = 9, 3, 2, 134
KW = dict(frames=F, timesteps=20, depth=2, num_proposals=P,
          sampling_timesteps=T)


@pytest.fixture(scope="module")
def setup():
    jm = jdiff.D3DP(jdiff.D3DPConfig(**KW),
                    attention_fn=select_attention_fn(True),
                    block_fn=select_block_fn(True))
    assert jm.block_fn is None and jm.attention_fn is not None
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    pm = D3DP(D3DPConfig(**KW), device="cpu", use_pallas="true")
    pm.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                      strict=True)
    # synthetic S8: camera 0 at 14 frames (2 windows), camera 1 cut to 7
    # frames (1 window, replicate-padded): 3 windows in all
    ds = h3wb.make_synthetic(subjects=("S8",), actions_per_subject=1,
                             frames_per_action=14, seed=0)
    kp = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(["S8"], kp, ds)
    seqs = [(cams[0], p3d[0], p2d[0]), (cams[1], p3d[1][:7], p2d[1][:7])]
    r = np.random.RandomState(7)
    table = (r.randn(3, P, F, N, 3).astype(np.float32),
             r.randn(3, T, P, F, N, 3).astype(np.float32))
    return jm, params, pm, seqs, table


def _both(setup, timings=None, **kw):
    jm, params, pm, seqs, table = setup
    ja, jsecond = jev.evaluate_sequences(
        jm, params, list(seqs), None, receptive_field=F, num_proposals=P,
        sampling_timesteps=T, noise_table=table, **kw)
    ta, tsecond = tev.evaluate_sequences(
        pm, list(seqs), receptive_field=F, num_proposals=P,
        sampling_timesteps=T, noise_table=table, timings=timings, **kw)
    return (ja, jsecond), (ta, tsecond)


def _assert_means(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["pooled_tail_bucket", "pooled_padded",
                                  "sequence_batches"])
def test_evaluate_sequences_matches_jax(setup, mode):
    kw = {"pooled_tail_bucket": dict(window_batch=4),
          "pooled_padded": dict(window_batch=4, tail_bucket=False),
          "sequence_batches": dict(window_batch=4, sequence_batches=True)}[mode]
    timings = {}
    (ja, _), (ta, _) = _both(setup, timings, **kw)
    assert ta.n == ja.n == 3 * F
    assert timings["windows"] == 3
    assert timings["batches"] == (1 if mode != "sequence_batches" else 2)
    means = ta.means_mm()
    assert means["J_Best"].shape == (T,)
    _assert_means(means, ja.means_mm())
    assert all(np.all(np.isfinite(v)) for v in means.values())


def _set_mode(model, mode):
    for m in model.modules():
        if isinstance(m, MixSTE2):
            m.set_use_pallas(mode, experimental_kernels=True)


@pytest.mark.parametrize("mode", ["block_t", "layer"])
def test_experimental_modes_match_jax(setup, mode):
    _, params, pm, seqs, table = setup
    jatt.set_experimental_kernels(True)
    try:
        jm = jdiff.D3DP(jdiff.D3DPConfig(**KW),
                        attention_fn=jatt.select_attention_fn(mode),
                        block_fn=jatt.select_block_fn(mode),
                        block_t_fn=jatt.select_block_t_fn(mode),
                        layer_fn=jatt.select_layer_fn(mode))
    finally:
        jatt.set_experimental_kernels(None)
    assert (jm.block_t_fn is not None) == (mode == "block_t")
    assert (jm.layer_fn is not None) == (mode == "layer")
    _set_mode(pm, mode)
    try:
        (ja, _), (ta, _) = _both((jm, params, pm, seqs, table),
                                 window_batch=4)
    finally:
        _set_mode(pm, "true")
    _assert_means(ta.means_mm(), ja.means_mm())


def test_protocol2_and_predictions_match_jax(setup):
    (ja, jp2), (ta, tp2) = _both(setup, window_batch=4, collect_p2=True)
    _assert_means(ta.means_mm(), ja.means_mm())
    _assert_means(tp2.means_mm(), jp2.means_mm())
    assert set(tp2.sums) == {"P2_J_Best", "P2_P_Best", "P2_P_Agg", "P2_J_Agg"}
    _, tpred = tev.evaluate_sequences(
        setup[2], list(setup[3]), receptive_field=F, num_proposals=P,
        sampling_timesteps=T, noise_table=setup[4], window_batch=4,
        return_predictions=True)
    assert tpred.shape == (3, T, P, F, N, 3)


def test_reports_are_identical_text(setup):
    r = np.random.RandomState(1)
    keys = ["J_Best", "P_Best", "P_Agg", "J_Agg", "P_Best_PB", "P_Agg_PB"] + [
        f"{m}_PB_{p}" for m in ("P_Best", "P_Agg") for p in tev.PART_NAMES]
    means = {k: 1000 * r.rand(T) for k in keys}
    p2 = {k: 1000 * r.rand(T) for k in ("P2_J_Best", "P2_P_Best", "P2_P_Agg",
                                        "P2_J_Agg")}
    for action, p2m in (("Walking", None), (None, p2)):
        assert (tev.format_report(means, action, p2m)
                == jev.format_report(means, action, p2m))
    for p2m in (None, p2):
        assert (tev.format_actionwise_average(means, p2m)
                == jev.format_actionwise_average(means, p2m))


def test_accumulator_and_window_batch_match_jax():
    a, b = tev.EvalAccumulator(), jev.EvalAccumulator()
    for w, v in ((27, [0.1, 0.2]), (9, [0.3, 0.05])):
        for acc in (a, b):
            acc.add({"J_Best": np.float32(v)}, w)
    assert a.n == b.n
    np.testing.assert_array_equal(a.means_mm()["J_Best"],
                                  b.means_mm()["J_Best"])
    for frames in ([5], [27, 54], [100] * 9, [30] * 100):
        seqs = [np.zeros((f, N, 2)) for f in frames]
        assert (tev.pinned_window_batch(seqs, 27)
                == jev.pinned_window_batch(seqs, 27))


def test_unfused_block_matches_fused_block():
    """use_pallas=true (unfused block, attention on the plain version of
    kernel #2 on the CPU) against use_pallas=auto (the plain version of
    kernel #1) on one part network at a part width: 2e-5 max abs, the
    float32 bound of the block tests (same function, sums in another
    order)."""
    from pafuse_tpu_torch.models.mixste import MixSTEConfig
    net = MixSTE2(MixSTEConfig(num_frames=F, num_joints=24, depth=2),
                  device="cpu", use_pallas="true")
    r = np.random.RandomState(2)
    x2d = torch.from_numpy(r.randn(2, F, 24, 2).astype(np.float32))
    x3d = torch.from_numpy(r.randn(2, F, 24, 3).astype(np.float32))
    t = torch.tensor([3, 17])
    with torch.no_grad():
        unfused = net(x2d, x3d, t)
        net.block_fn = port_block("auto")
        fused = net(x2d, x3d, t)
    torch.testing.assert_close(unfused, fused, rtol=0, atol=2e-5)


def test_block_selection():
    from pafuse_tpu_torch.models.mixste import MixSTEConfig
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.ops.block_temporal import fused_block_temporal
    from pafuse_tpu_torch.ops.layer import fused_layer
    assert port_block("auto") is fused_block and port_block("block") is fused_block
    for mode in (True, "true", "TRUE", False, "false"):
        assert port_block(mode).func.__name__ == "unfused_block"
    for mode in ("block_t", "layer"):
        # the experimental gate, as the JAX package's require_experimental
        with pytest.raises(ValueError, match="experimental_kernels"):
            port_block(mode)
        with pytest.raises(ValueError, match="experimental_kernels"):
            MixSTE2(MixSTEConfig(num_frames=F, num_joints=5, embed_dim=32,
                                 depth=1), device="cpu", use_pallas=mode)
    assert port_block("block_t", experimental_kernels=True) is fused_block
    assert port_block("layer", experimental_kernels=True).func.__name__ == (
        "unfused_block")
    net = MixSTE2(MixSTEConfig(num_frames=F, num_joints=5, embed_dim=32,
                               depth=1), device="cpu", use_pallas="layer",
                  experimental_kernels=True)
    assert net.layer_fn is fused_layer and net.block_t_fn is None
    net.set_use_pallas("block_t", experimental_kernels=True)
    assert net.block_t_fn is fused_block_temporal and net.layer_fn is None
    assert net.block_fn is fused_block
    net.set_use_pallas("auto")
    assert net.block_t_fn is None and net.layer_fn is None
    with pytest.raises(ValueError):
        port_block("heads")


def test_evaluate_needs_eval_mode(setup):
    pm, seqs = setup[2], setup[3]
    pm.train()
    try:
        with pytest.raises(RuntimeError, match="eval mode"):
            tev.evaluate_sequences(pm, list(seqs), receptive_field=F)
    finally:
        pm.eval()
