"""Training loss: mean per-joint position error.

Counterpart of ``pafuse_tpu/losses.py::mpjpe`` (the loss of the training
step).  The multi-hypothesis metrics of evaluation are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def mpjpe(predicted: torch.Tensor, target: torch.Tensor,
          weights: Optional[torch.Tensor] = None,
          mse_loss: bool = False) -> torch.Tensor:
    """Mean Euclidean distance over all joints (protocol #1), with optional
    per-joint ``weights`` (N,) and a squared-distance mode."""
    assert predicted.shape == target.shape
    dist = torch.linalg.norm(predicted - target, dim=-1)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=dist.dtype, device=dist.device)
        assert w.shape[0] == target.shape[-2]
        dist = w * dist
    if mse_loss:
        return dist.square().mean()
    return dist.mean()
