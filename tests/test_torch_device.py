"""The port's transfers and chunked execution (pafuse_tpu_torch.utils.device)
and its thread-safe launch counters, on the CPU.

``run_chunked`` queues each chunk's readback right behind its work and reads
chunk i only after chunk i+1 has been queued; on the CPU a handle is the
result tensor itself, so the chunked result must equal one unchunked call
exactly.  The card's half (chunk 0's copy ready while chunk 1 still runs)
is ``tests/test_torch_cuda.py::test_readback_waits_for_its_own_chunk_only_on_gpu``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.utils.device import run_chunked, to_device, to_host

torch.set_num_threads(2)


def _rows_fn():
    w = torch.from_numpy(np.random.RandomState(1).randn(6, 5)
                         .astype(np.float32))
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        x = torch.from_numpy(np.ascontiguousarray(a)) @ w
        return torch.tanh(x) + torch.from_numpy(np.ascontiguousarray(b))
    return fn, calls


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_run_chunked_equals_one_call(chunk):
    r = np.random.RandomState(0)
    a = r.randn(7, 6).astype(np.float32)
    b = r.randn(7, 5).astype(np.float32)
    fn, calls = _rows_fn()
    want = fn(a, b).numpy()
    calls.clear()
    got = run_chunked(fn, (a, b), chunk)
    np.testing.assert_array_equal(got, want)
    assert calls == [min(chunk, 7 - s) for s in range(0, 7, chunk)]


def test_run_chunked_rejects_empty():
    fn, _ = _rows_fn()
    with pytest.raises(ValueError, match="empty"):
        run_chunked(fn, (np.zeros((0, 6), np.float32),
                         np.zeros((0, 5), np.float32)), 2)


def test_cpu_transfers_are_plain_tensors():
    a = np.arange(6, dtype=np.int64)[::2]          # not contiguous
    t = to_device(a, torch.device("cpu"), torch.long)
    assert t.device.type == "cpu" and t.dtype == torch.long
    np.testing.assert_array_equal(t.numpy(), a)
    out = torch.ones(3)
    assert to_host(out) is out                     # the CPU handle


def test_launch_counter_keeps_every_launch_across_threads():
    """Eight threads add 20000 launches each through ``count_launch`` with
    a tiny switch interval; a lost update would leave fewer."""
    def wrapper():
        pass
    wrapper.launches = 0
    per_thread, n_threads = 20000, 8

    def work():
        for _ in range(per_thread):
            _build.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == per_thread * n_threads
