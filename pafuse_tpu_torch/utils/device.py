"""Device selection, synchronisation and chunked execution.

Counterpart of ``pafuse_tpu/utils/backend.py``.  Entry points default to
``"cuda"`` and take the CPU only when asked for it; asking for CUDA where
there is none raises instead of running on the CPU.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``) and pin
    float32 matmuls and convolutions to full float32 (TF32 off)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chunked(fn: Callable[..., torch.Tensor], arrays: Sequence[np.ndarray],
                chunk: int) -> np.ndarray:
    """Apply ``fn`` to consecutive ``chunk``-row slices of ``arrays`` and
    concatenate the results on the host.

    Rows are independent, so the last chunk runs with however many rows it
    has.  The previous chunk's result is copied to the host after the next
    chunk has been queued, so on a GPU the copy overlaps the next chunk's
    work."""
    n = arrays[0].shape[0]
    if n == 0:
        raise ValueError("run_chunked: empty leading axis")
    outs, pending = [], None
    for start in range(0, n, chunk):
        out = fn(*[a[start:start + chunk] for a in arrays])
        if pending is not None:
            outs.append(pending.cpu().numpy())
        pending = out
    outs.append(pending.cpu().numpy())
    return np.concatenate(outs, axis=0)
