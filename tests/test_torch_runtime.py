"""The port's native runtime (``pafuse_tpu_torch/runtime``: the C++ batch
assembly and its loader) and the sampler's two assembly paths, against
NumPy and against the JAX package's ``ChunkedSampler``; twins of
``tests/test_runtime.py``.  The library builds here (g++ is on the PATH).
Every comparison is bit for bit (atol 0): both paths copy float32 values
and negate some, so no rounding separates them."""

import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from pafuse_tpu.data import sampling as jsampling
from pafuse_tpu_torch import runtime, skeleton as sk
from pafuse_tpu_torch.data import h3wb, sampling

torch.set_num_threads(2)


def test_native_library_builds():
    lib = runtime.get_library()
    assert lib is not None, "g++ is on the PATH here; the build must work"
    path = runtime.library_path(runtime.shutil.which(runtime.CXX))
    assert os.path.exists(path)
    assert os.path.commonpath([path, runtime.BUILD_ROOT]) == runtime.BUILD_ROOT
    assert runtime.get_library() is lib          # built once, then reused


def _expected(src, idx, flip, perm):
    out = src[idx].copy()
    if flip is not None and flip.any():
        fl = out[flip]
        fl[..., 0] *= -1
        out[flip] = fl[:, :, perm]
    return out


@pytest.mark.parametrize("flips", [True, False], ids=["flips", "no_flips"])
def test_assemble_matches_numpy(flips):
    rng = np.random.RandomState(0)
    src = rng.randn(100, 134, 3).astype(np.float32)
    idx = rng.randint(0, 100, size=(16, 9)).astype(np.int64)
    flip = (rng.rand(16) < 0.5) if flips else None
    perm = sk.FLIP_PERMUTATION if flips else None
    out = runtime.assemble_batch(src, idx, flip, perm)
    np.testing.assert_allclose(out, _expected(src, idx, flip, perm), atol=0)
    # 2D keypoints, one thread, into a given buffer
    src2 = rng.randn(50, 17, 2).astype(np.float32)
    idx2 = rng.randint(0, 50, size=(4, 27)).astype(np.int64)
    buf = np.empty((4, 27, 17, 2), np.float32)
    assert runtime.assemble_batch(src2, idx2, None, None, out=buf,
                                  n_threads=1) is buf
    np.testing.assert_allclose(buf, src2[idx2], atol=0)


def test_assemble_rejects_bad_arguments():
    src = np.zeros((10, 3, 2), np.float32)
    with pytest.raises(ValueError, match="frame_idx outside"):
        runtime.assemble_batch(src, np.array([[10]]), None, None)
    with pytest.raises(ValueError, match="perm"):
        runtime.assemble_batch(src, np.array([[1]]), np.array([1]),
                               np.array([0, 1]))
    with pytest.raises(ValueError, match="out must be"):
        runtime.assemble_batch(src, np.array([[1]]), None, None,
                               out=np.empty((1, 1, 3, 2), np.float64))


def _data(seed, frames=50):
    ds = h3wb.make_synthetic(subjects=("S1",), actions_per_subject=1,
                             frames_per_action=frames, seed=seed)
    return h3wb.fetch(["S1"], h3wb.prepare_data(ds), ds)


def _assert_same_epochs(a, b):
    n = 0
    for batch_a, batch_b in zip(a, b, strict=True):
        for x, y in zip(batch_a, batch_b):
            np.testing.assert_array_equal(x, y)
        n += 1
    return n


def test_sampler_paths_match_jax_bit_for_bit():
    """Cameras, 3D and 2D of a shuffled, flip-augmented epoch: the port's
    native and NumPy paths against JAX's sampler (its native path), the
    same seed and the same arrays."""
    kw = dict(chunk_length=27, augment=True, shuffle=True, random_seed=11)
    port_data = _data(5)
    jax_gen = jsampling.ChunkedSampler(6, *port_data, **kw)
    native = sampling.ChunkedSampler(6, *port_data, use_native=True, **kw)
    numpy_ = sampling.ChunkedSampler(6, *port_data, use_native=False, **kw)
    assert native._native is not None and numpy_._native is None
    n = jax_gen.batch_num()
    assert native.augment_enabled() and native.batch_num() == n > 1
    want = list(jax_gen.next_epoch())
    assert any(np.any(c[:, 2] < 0) for c, _, _ in want)   # flipped rows
    assert _assert_same_epochs(native.next_epoch(), want) == n
    assert _assert_same_epochs(numpy_.next_epoch(), want) == n
    # the next epoch's shuffle too
    assert _assert_same_epochs(native.next_epoch(),
                               jax_gen.next_epoch()) == n


def test_endless_resumes_where_it_stopped():
    kw = dict(chunk_length=9, augment=True, shuffle=True, random_seed=3,
              endless=True)
    port_data = _data(6, frames=40)
    port = sampling.ChunkedSampler(4, *port_data, **kw)
    jax_gen = jsampling.ChunkedSampler(4, *port_data, **kw)
    per_epoch = port.batch_num()
    assert per_epoch == jax_gen.batch_num() > 3

    def take(sampler, n):
        it = sampler.next_epoch()
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    # stop after 3 batches, then again part way into the next epoch
    got = take(port, 3)
    assert port.state[0] == 3
    got += take(port, per_epoch)
    want = take(jax_gen, 3 + per_epoch)
    assert port.state[0] == jax_gen.state[0] == 3
    _assert_same_epochs(got, want)
    start, order = port.next_pairs()
    assert start == 3 and np.array_equal(order, jax_gen.next_pairs()[1])


def test_prefetching_loader_keeps_order_and_attributes():
    port_data = _data(6)
    gen = sampling.ChunkedSampler(6, *port_data, 27, shuffle=False)
    direct = [b2.copy() for _, _, b2 in gen.next_epoch()]
    gen2 = sampling.ChunkedSampler(6, *port_data, 27, shuffle=False)
    loader = runtime.PrefetchingLoader(gen2, depth=2)
    prefetched = [b2.copy() for _, _, b2 in loader.next_epoch()]
    assert len(direct) == len(prefetched) > 1
    for a, b in zip(direct, prefetched):
        np.testing.assert_array_equal(a, b)
    assert loader.batch_num() == gen2.batch_num()
    assert loader.augment_enabled() is False

    class Endless:
        def next_epoch(self):
            i = 0
            while True:
                yield i
                i += 1

    before = threading.active_count()
    it = runtime.PrefetchingLoader(Endless(), depth=2).next_epoch()
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_failing_compiler_raises(tmp_path, monkeypatch):
    """A compiler that is there but fails raises with its output: the
    sampler never falls back to NumPy behind it."""
    cxx = tmp_path / "failing-g++"
    cxx.write_text('#!/bin/sh\ncase "$*" in *--help=target*) exit 0;; esac\n'
                   'echo "error: cannot compile" >&2\nexit 1\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(runtime, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="cannot compile"):
        runtime.get_library()
    for use_native in ("auto", True):
        with pytest.raises(RuntimeError, match="cannot compile"):
            sampling.ChunkedSampler(6, *_data(5), 27, use_native=use_native)


def test_no_compiler_auto_warns_once_and_takes_numpy(monkeypatch):
    monkeypatch.setattr(runtime, "CXX", "no-such-c++-compiler")
    monkeypatch.setattr(runtime, "_WARNED", [])
    assert runtime.get_library() is None
    data = _data(5)
    with pytest.warns(RuntimeWarning, match="NumPy"):
        gen = sampling.ChunkedSampler(6, *data, 27, augment=True)
    assert gen._native is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # once per process
        sampling.ChunkedSampler(6, *data, 27)
    with pytest.raises(RuntimeError, match="use_native=True"):
        sampling.ChunkedSampler(6, *data, 27, use_native=True)
    with pytest.raises(RuntimeError, match="no-such"):
        runtime.assemble_batch(np.zeros((2, 1, 1), np.float32),
                               np.zeros((1, 1), np.int64), None, None)
    # the NumPy path still yields the native path's batches
    monkeypatch.undo()
    native = sampling.ChunkedSampler(6, *data, 27, augment=True)
    assert native._native is not None
    _assert_same_epochs(gen.next_epoch(), native.next_epoch())
