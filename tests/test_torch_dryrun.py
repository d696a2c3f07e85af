"""The port's dry run (``pafuse_tpu_torch/dryrun.py``) against the JAX
package's ``__graft_entry__.py``.

``entry``: the port's step (``use_pallas=auto``: kernel #1's plain version
on the CPU) and the JAX step (XLA, jitted), on the JAX entry's parameters
carried across and the same ``RandomState(0)`` inputs, agree within 1e-5
of the largest |x_start| (max abs difference over max abs value; x_start
is clamped to [-1.1, 1.1], and sixteen float32 blocks deep a sum in
another order moves it by ~1e-6).  The JAX side is one module-scoped
fixture: the flagship model at full width (depth 8, 27 frames, 134
joints), 16 windows with the flipped twins.

``dryrun_multichip`` finishes on the CPU in a world of one and in a
two-rank gloo world launched as torchrun launches it, with a finite loss
and J_Best and the JAX dry run's shapes (an 18-frame lift (18, 134, 3),
a 9-frame lift at 1x1 with one hypothesis, buckets (2,), tiers 2x2 and
1x1, three stream emits).
"""

import json
import sys

import numpy as np
import pytest
import jax
import torch

import __graft_entry__ as graft
from pafuse_tpu_torch import checkpoints, dryrun
from test_torch_parallel import _launch

torch.set_num_threads(2)

ENTRY_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = graft.entry()
    out = np.asarray(jax.jit(fn)(*args))
    return jax.device_get(args), out


def test_entry_matches_jax(jax_entry):
    (params, x_t, x2d, x2d_flip), want = jax_entry
    fn, args = dryrun.entry("cpu")
    model = args[0]
    for got, ref in zip(args[1:], (x_t, x2d, x2d_flip)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    model.pose_estimator.load_state_dict(checkpoints.params_from_jax(params),
                                         strict=True)
    out = fn(*args).numpy()
    assert out.shape == want.shape == (2, 4, 27, 134, 3)
    rel = np.abs(out - want).max() / np.abs(want).max()
    assert rel <= ENTRY_RTOL, rel          # measured 1.6e-6


def _check(result):
    assert np.isfinite(result["loss"]) and np.isfinite(result["J_Best"])
    assert tuple(result["poses"]) == (18, 134, 3)
    assert tuple(result["poses_1x1"]) == (9, 134, 3)
    assert result["num_hypotheses_1x1"] == 1
    assert tuple(result["buckets"]) == (2,)
    assert [tuple(p) for p in result["op_points"]] == [(2, 2), (1, 1)]
    assert result["stream_emits"] == 3


def test_dryrun_multichip_world_of_one():
    _check(dryrun.dryrun_multichip(1, device="cpu"))


def test_dryrun_multichip_two_gloo_ranks(tmp_path):
    code = ("import json, torch; torch.set_num_threads(1); "
            "from pafuse_tpu_torch import dryrun; "
            "r = dryrun.dryrun_multichip(2, device='cpu'); "
            "print('RESULT', json.dumps(r))")
    outs = _launch(lambda rank: [sys.executable, "-c", code],
                   cwd=str(tmp_path))
    results = [json.loads(o.split("RESULT ", 1)[1].splitlines()[0])
               for o in outs]
    for r in results:
        _check(r)
    # one loss (averaged over the ranks), one J_Best, one service
    assert results[0] == results[1]
