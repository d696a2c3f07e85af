"""MPI-INF-3DHP data (the 17-joint body), a copy of
``pafuse_tpu/data/dhp3.py``.

The real files are the P-STMO-style ``data_train_3dhp.npz`` and
``data_test_3dhp.npz``: dicts keyed by (subject, sequence) of per-camera 2D
(normalised) and 3D (millimetres, root-relative) arrays; the test set adds
a per-frame validity mask (``valid`` or ``valid_frame``).  Without them a
deterministic synthetic set of the same structure is made from a seed, the
same arrays as the JAX package's for the same seed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from pafuse_tpu_torch import skeleton as sk

NUM_JOINTS = sk.NUM_JOINTS_3DHP  # 17


def _smooth(rng: np.random.RandomState, frames: int, shape, sigma=6):
    """Gaussian-smoothed (frames, *shape) noise along the frame axis."""
    x = rng.randn(frames + 6 * sigma, *shape).astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-3 * sigma, 3 * sigma + 1) / sigma) ** 2)
    k /= k.sum()
    x = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 0, x)
    return x[:frames]


def make_synthetic(num_train_seqs: int = 3, num_test_seqs: int = 2,
                   frames: int = 80, seed: int = 0):
    """Synthetic 3DHP-shaped (train, test) dicts:
    ``train[(subject, seq)] = {"data_2d": (F, 17, 2) normalised,
    "data_3d": (F, 17, 3) mm}``, ``test[seq]`` the same plus ``"valid"``
    (F,) bool (about 10% of frames invalid)."""
    rng = np.random.RandomState(seed)

    def seq(f):
        base = rng.uniform(-500, 500, (NUM_JOINTS, 3)).astype(np.float32)
        track = base[None] + _smooth(rng, f, (NUM_JOINTS, 3)) * 120.0
        track = track - track[:, :1]  # root-relative, mm
        p2 = track[..., :2] / 2000.0 + _smooth(rng, f, (NUM_JOINTS, 2)) * 0.01
        return p2.astype(np.float32), track.astype(np.float32)

    train = {}
    for i in range(num_train_seqs):
        p2, p3 = seq(frames)
        train[(f"S{i + 1}", f"Seq{i % 2 + 1}")] = {"data_2d": p2, "data_3d": p3}
    test = {}
    for i in range(num_test_seqs):
        p2, p3 = seq(frames)
        valid = np.ones(frames, dtype=bool)
        valid[rng.rand(frames) < 0.1] = False
        test[f"TS{i + 1}"] = {"data_2d": p2, "data_3d": p3, "valid": valid}
    return train, test


def load_dataset(data_dir: str = "data", synthetic: str | bool = "auto",
                 **kwargs):
    """The real npz files under ``data_dir`` when present (train entries
    keyed ``(subject, f"{seq}_cam{N}")``, one per camera), else synthetic
    data (``kwargs`` go to :func:`make_synthetic`), as ``synthetic`` says
    (auto | true | false)."""
    train_path = os.path.join(data_dir, "data_train_3dhp.npz")
    test_path = os.path.join(data_dir, "data_test_3dhp.npz")
    real = os.path.exists(train_path) and os.path.exists(test_path)
    if synthetic is True or (str(synthetic) == "auto" and not real):
        return make_synthetic(**kwargs)
    if not real:
        raise FileNotFoundError(f"3DHP npz files not found under {data_dir!r}")

    raw_train = np.load(train_path, allow_pickle=True)["data"].item()
    raw_test = np.load(test_path, allow_pickle=True)["data"].item()
    train = {}
    for key, cams in raw_train.items():
        for cam_idx, arrs in cams.items():
            train[(key[0], f"{key[1]}_cam{cam_idx}")] = {
                "data_2d": np.asarray(arrs["data_2d"], np.float32),
                "data_3d": np.asarray(arrs["data_3d"], np.float32),
            }
    test = {}
    for seq, arrs in raw_test.items():
        test[seq] = {
            "data_2d": np.asarray(arrs["data_2d"], np.float32),
            "data_3d": np.asarray(arrs["data_3d"], np.float32),
            "valid": np.asarray(arrs.get("valid", arrs.get("valid_frame")),
                                bool).reshape(-1),
        }
    return train, test


def train_arrays(train: Dict) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(3D arrays, 2D arrays) of the training sequences, in dict order."""
    p3 = [v["data_3d"] for v in train.values()]
    p2 = [v["data_2d"] for v in train.values()]
    return p3, p2
