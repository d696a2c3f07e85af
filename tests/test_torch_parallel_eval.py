"""Sharded evaluation on torch.distributed on the CPU: two gloo ranks
(tests/test_torch_parallel.py's launcher and worker) against one process
and against JAX's ``evaluate_sequences(mesh=)`` on the conftest's 8-device
CPU mesh, and ``evaluate_3dhp`` over two ranks against one process.

Bounds: metrics within 1e-5 relative of one process (each rank's sampler
call has half the rows, and the PyTorch GEMMs of the embedding and head
on the CPU may round a row differently at another row count; measured
bit for bit here) and of JAX's sharded evaluation, as tests/test_mesh.py
holds JAX's own; the ranks' metrics equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from pafuse_tpu import evaluate as jev
from pafuse_tpu.diffusion import D3DP as JaxD3DP, D3DPConfig as JaxConfig
from pafuse_tpu.parallel import mesh as jmesh
from pafuse_tpu_torch import checkpoints, config as cfg_mod
from pafuse_tpu_torch import evaluate as tev
from pafuse_tpu_torch.cli import main_3dhp
from pafuse_tpu_torch.data import dhp3, h3wb
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

from test_torch_parallel import EVAL_KW, _worker

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sharded_eval(tmp_path_factory):
    """One process, the two-rank world and JAX's sharded evaluation on one
    set of sequences: 21 windows, one 32-row batch dispatched at its
    24-row tail bucket (12 rows a rank)."""
    jm = JaxD3DP(JaxConfig(**EVAL_KW))
    jparams = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    params = checkpoints.params_from_jax(jparams)
    ds = h3wb.make_synthetic(subjects=("S8",), actions_per_subject=2,
                             frames_per_action=45, seed=0)
    kp = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(["S8"], kp, ds)
    seqs = [(c, a, b) for c, a, b in zip(cams, p3d, p2d)][:5]
    seqs[-1] = tuple(x if i == 0 else x[:9] for i, x in enumerate(seqs[-1]))
    n = sum(-(-s[2].shape[0] // 9) for s in seqs)
    assert n == 16 + 5, n
    r = np.random.RandomState(5)
    table = (r.randn(n, 2, 9, 134, 3).astype(np.float32),
             r.randn(n, 2, 2, 9, 134, 3).astype(np.float32))
    kw = dict(receptive_field=9, num_proposals=2, sampling_timesteps=2)
    pm = D3DP(D3DPConfig(**EVAL_KW), device="cpu")
    pm.pose_estimator.load_state_dict(params, strict=True)
    one = tev.evaluate_sequences(pm, seqs, noise_table=table, **kw)[0]
    drawn, p2 = tev.evaluate_sequences(pm, seqs, collect_p2=True, **kw)
    jax_mesh = jmesh.make_mesh((8,), ("data",))
    jacc, _ = jev.evaluate_sequences(jm, jparams, seqs, None, mesh=jax_mesh,
                                     noise_table=table, **kw)
    # the 3DHP model: 2 sequences of 40 frames, 5 windows each, sampled in
    # calls of 5 windows (3 + 2 rows a rank, the noise of all 5 sliced)
    overrides3 = ["gpu.device=cpu", "model.number_of_frames=9",
                  "model.dep=1", "model.cs=64", "ft2d.timestep=20"]
    args3 = cfg_mod.parse_cli(overrides3)
    m3 = main_3dhp.build_model_3dhp(args3, "cpu").eval()
    _, test3 = dhp3.make_synthetic(num_train_seqs=0, num_test_seqs=2,
                                   frames=40, seed=3)
    dhp = main_3dhp.evaluate_3dhp(m3, test3, args3, num_proposals=2,
                                  sampling_timesteps=2, window_batch=5)
    workdir = tmp_path_factory.mktemp("sharded_eval")
    torch.save(dict(eval_kw=EVAL_KW, params=params, seqs=seqs, table=table,
                    args_3dhp=overrides3, params_3dhp=m3.state_dict(),
                    test_3dhp=test3), workdir / "inputs.pt")
    _worker("eval", workdir)
    ranks = [torch.load(workdir / f"out_eval_{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(one=one.means_mm(), drawn=drawn.means_mm(),
                p2=p2.means_mm(), jax=jacc.means_mm(), dhp3=dhp, ranks=ranks)


def _close(got, want, rtol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)


def test_sharded_evaluation_equals_one_process(sharded_eval):
    for out in sharded_eval["ranks"]:
        _close(out["injected"], sharded_eval["one"], 1e-5)
        # the global batch's noise drawn from the generator, rows sliced
        _close(out["drawn"], sharded_eval["drawn"], 1e-5)
        _close(out["p2"], sharded_eval["p2"], 1e-5)


def test_sharded_evaluate_3dhp_equals_one_process(sharded_eval):
    """evaluate_3dhp over two ranks (each sampler call's windows split,
    the generator's noise drawn for the whole call and sliced) gives one
    process's P_Best and P_Agg."""
    for out in sharded_eval["ranks"]:
        for got, want in zip(out["dhp3"], sharded_eval["dhp3"]):
            assert np.all(np.isfinite(want))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_sharded_evaluation_equals_jax_sharded_evaluation(sharded_eval):
    for out in sharded_eval["ranks"]:
        _close(out["injected"], sharded_eval["jax"], 1e-5)


def test_ranks_get_the_same_metrics(sharded_eval):
    a, b = sharded_eval["ranks"]
    for k in ("injected", "drawn", "p2"):
        assert all(np.array_equal(a[k][m], b[k][m]) for m in a[k])
