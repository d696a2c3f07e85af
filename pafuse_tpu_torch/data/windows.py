"""Host-side sequence windowing (NumPy), a copy of
``pafuse_tpu/data/windows.py``.

A sequence of F frames is split into ``ceil(F / rf)`` non-overlapping windows
of ``rf`` frames; the last window is the *last rf frames* (overlapping the
previous one when F is not a multiple of rf); a sequence shorter than rf is
replicate-padded at the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def window_indices(num_frames: int, receptive_field: int) -> np.ndarray:
    """(num_windows, receptive_field) frame-index matrix."""
    rf = receptive_field
    out_num = max(1, -(-num_frames // rf))
    idx = np.arange(out_num)[:, None] * rf + np.arange(rf)[None, :]
    if num_frames >= rf:
        idx[-1] = np.arange(num_frames - rf, num_frames)
    else:
        idx = np.minimum(idx, num_frames - 1)
    return idx.astype(np.int64)


def eval_data_prepare(receptive_field: int, inputs_2d: np.ndarray,
                      inputs_3d: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Window a (F, J, C) [or (1, F, J, C)] sequence into
    (num_windows, rf, J, C) arrays."""
    x2d = np.squeeze(inputs_2d)
    idx = window_indices(x2d.shape[0], receptive_field)
    out_2d = x2d[idx]
    out_3d = None
    if inputs_3d is not None:
        x3d = np.squeeze(inputs_3d)
        assert x2d.shape[:-1] == x3d.shape[:-1], (
            f"2d and 3d inputs shape must match: {x2d.shape} vs {x3d.shape}")
        out_3d = x3d[idx]
    return out_2d.astype(np.float32), (
        out_3d.astype(np.float32) if out_3d is not None else None)


def stitch_windows(windows: np.ndarray, num_frames: int,
                   receptive_field: int) -> np.ndarray:
    """Inverse of :func:`eval_data_prepare` for prediction timelines:
    (..., num_windows, rf, J, C) -> (..., num_frames, J, C); the last
    (possibly overlapping) window supplies the tail frames."""
    rf = receptive_field
    lead = windows.shape[:-4]
    nw = windows.shape[-4]
    out = np.zeros(lead + (num_frames,) + windows.shape[-2:],
                   dtype=windows.dtype)
    full = min(nw - 1, num_frames // rf)
    for w in range(full):
        out[..., w * rf:(w + 1) * rf, :, :] = windows[..., w, :, :, :]
    tail = num_frames - full * rf
    if tail > 0:
        out[..., num_frames - tail:, :, :] = (
            windows[..., -1, rf - tail:, :, :] if num_frames >= rf
            else windows[..., -1, :tail, :, :])
    return out
