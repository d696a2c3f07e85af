"""Training batch sampler over chunked sequences.

Counterpart of ``pafuse_tpu/data/sampling.py::ChunkedSampler``: all
sequences are concatenated into one buffer per modality, each chunk's
global frame indices are precomputed (edge-clamped, which is the
reference's 'edge' padding), and a batch is one gather with flip
augmentation applied to the flipped rows through the joint permutation:
in C++ (``runtime.assemble_batch``) on the native path, else one NumPy
fancy-gather.  ``use_native="auto"`` (the default, as in the JAX package)
takes the native path when a C++ compiler is on the PATH and warns once
and takes NumPy when none is; ``True`` raises without one; ``False`` is
NumPy.  The chunk table, the per-epoch shuffle (``np.random.RandomState``,
seed 1234 by default), the flips and the ``endless`` resumption are the
JAX package's, so the same seed gives identical batches on either path.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from pafuse_tpu_torch import runtime, skeleton as sk


class ChunkedSampler:
    """Yields (cameras, batch_3d, batch_2d) NumPy batches for training."""

    def __init__(self, batch_size: int, cameras, poses_3d, poses_2d,
                 chunk_length: int, shuffle: bool = True,
                 random_seed: int = 1234, augment: bool = False,
                 flip_permutation: Optional[np.ndarray] = None,
                 endless: bool = False, use_native: str | bool = "auto"):
        assert poses_3d is None or len(poses_3d) == len(poses_2d)
        assert cameras is None or len(cameras) == len(poses_2d)
        if use_native not in (True, False, "auto"):
            raise ValueError(f"use_native={use_native!r}: expected True, "
                             "False or 'auto'")
        self.batch_size = batch_size
        self.chunk_length = chunk_length
        self.shuffle = shuffle
        self.augment = augment
        self.endless = endless
        self.random = np.random.RandomState(random_seed)
        #: (next batch, order) of an endless epoch left part way, else None
        self.state = None
        self.flip_perm = (flip_permutation if flip_permutation is not None
                          else sk.FLIP_PERMUTATION)

        lengths = np.array([p.shape[0] for p in poses_2d], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        self._buf_2d = np.concatenate(poses_2d, axis=0).astype(np.float32)
        self._buf_3d = (np.concatenate(poses_3d, axis=0).astype(np.float32)
                        if poses_3d is not None else None)
        self._cams = (np.stack(cameras).astype(np.float32)
                      if cameras is not None else None)

        # chunk table: all chunks of sequence i, then their flipped twins
        seq_parts: List[np.ndarray] = []
        start_parts: List[np.ndarray] = []
        flip_parts: List[np.ndarray] = []
        reps = 2 if augment else 1
        for i, n in enumerate(lengths):
            n_chunks = (int(n) + chunk_length - 1) // chunk_length
            offset = (n_chunks * chunk_length - int(n)) // 2
            bounds = np.arange(n_chunks + 1) * chunk_length - offset
            seq_parts.append(np.full(n_chunks * reps, i, dtype=np.int64))
            start_parts.append(np.tile(bounds[:-1], reps))
            fl = np.zeros(n_chunks, dtype=bool)
            flip_parts.append(np.concatenate([fl, ~fl]) if augment else fl)
        seq_idx = np.concatenate(seq_parts)
        starts = np.concatenate(start_parts)
        flip = np.concatenate(flip_parts)
        #: pairs[i] = (sequence, start frame, flipped)
        self.pairs = np.stack([seq_idx, starts, flip.astype(np.int64)], axis=1)

        frame = starts[:, None] + np.arange(chunk_length)[None, :]
        frame = np.clip(frame, 0, (lengths[seq_idx] - 1)[:, None])
        self._global_index = (offsets[seq_idx][:, None] + frame).astype(np.int64)
        self.num_batches = (len(self.pairs) + batch_size - 1) // batch_size

        #: runtime.assemble_batch on the native path, None on NumPy's
        self._native = None
        if use_native is not False:
            if runtime.get_library() is not None:
                self._native = runtime.assemble_batch
            elif use_native is True:
                raise RuntimeError(f"use_native=True: no {runtime.CXX} on "
                                   "the PATH to build the native batcher")
            else:
                runtime.warn_no_compiler()

    def num_frames(self) -> int:
        return self.num_batches * self.batch_size

    def batch_num(self) -> int:
        return self.num_batches

    def random_state(self):
        return self.random

    def set_random_state(self, random_state):
        self.random = random_state

    def augment_enabled(self) -> bool:
        return self.augment

    def next_pairs(self):
        """(first batch, row order) of the next epoch: where an endless
        epoch stopped, else batch 0 of a fresh order (shuffled when
        shuffling)."""
        if self.state is None:
            order = (self.random.permutation(len(self.pairs))
                     if self.shuffle else np.arange(len(self.pairs)))
            return 0, order
        return self.state

    def _gather(self, buf: np.ndarray, idx: np.ndarray,
                flip_mask: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native(buf, idx, flip_mask, self.flip_perm)
        batch = buf[idx]                                   # (b, L, J, C)
        if np.any(flip_mask):
            fl = batch[flip_mask]
            fl[..., 0] *= -1
            batch[flip_mask] = fl[:, :, self.flip_perm]
        return batch

    def next_epoch(self) -> Iterator[Tuple[Optional[np.ndarray],
                                           Optional[np.ndarray], np.ndarray]]:
        """One epoch of batches, in a fresh shuffle order when shuffling.
        ``endless``: epochs follow one another without end, and
        ``state`` records where the epoch stands, so a new call resumes an
        epoch left part way."""
        while True:
            start, order = self.next_pairs()
            for b_i in range(start, self.num_batches):
                if self.endless:
                    self.state = (b_i + 1, order)
                yield self._batch(order, b_i)
            self.state = None
            if not self.endless:
                return

    def _batch(self, order: np.ndarray, b_i: int):
        """Batch ``b_i`` of the epoch in row ``order``: (cameras, 3D, 2D)."""
        rows = order[b_i * self.batch_size:(b_i + 1) * self.batch_size]
        idx = self._global_index[rows]
        flip_mask = self.pairs[rows, 2].astype(bool)
        batch_2d = self._gather(self._buf_2d, idx, flip_mask)
        batch_3d = (self._gather(self._buf_3d, idx, flip_mask)
                    if self._buf_3d is not None else None)
        batch_cam = None
        if self._cams is not None:
            batch_cam = self._cams[self.pairs[rows, 0]].copy()
            if np.any(flip_mask):
                batch_cam[flip_mask, 2] *= -1
                batch_cam[flip_mask, 7] *= -1
        return batch_cam, batch_3d, batch_2d
