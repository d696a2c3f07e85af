"""MPJPE loss family and the multi-hypothesis diffusion metrics.

Counterpart of ``pafuse_tpu/losses.py``.  The training loss and the
protocol #1 metrics are torch functions that run where their inputs lie (on
the card during evaluation); the Procrustes (protocol #2) family stays in
NumPy with an SVD, a host-side reporting path, as in the JAX package.

Hypothesis tensors have shape ``(B, S, H, F, N, C)``: batch, DDIM step,
hypothesis, frame, joint, coordinate.  The metrics return per-DDIM-step
vectors of shape ``(S,)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pafuse_tpu_torch import geometry, skeleton as sk
from pafuse_tpu_torch.utils.device import to_device


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

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


def mpjpe_per_joint(predicted: torch.Tensor, target: torch.Tensor):
    """(mean error, per-joint mean errors in mm)."""
    errors = torch.linalg.norm(predicted - target, dim=-1)
    per_joint = errors.reshape(-1, errors.shape[-1]).mean(0) * 1000
    return errors.mean(), per_joint


# ---------------------------------------------------------------------------
# Multi-hypothesis metrics over (B, S, H, F, N, C)
# ---------------------------------------------------------------------------

def _joints(x: torch.Tensor, idx) -> torch.Tensor:
    """x[..., idx] over the last (joint) axis."""
    return x.index_select(-1, to_device(np.asarray(idx), x.device, torch.long))


def mpjpe_diffusion_all_min(predicted: torch.Tensor, target: torch.Tensor,
                            mean_pos: bool = False, part_based: bool = False,
                            parts_joint_indices=None):
    """J_Best (per-joint min over hypotheses) or, with ``mean_pos``, P_Agg
    (the error of the hypothesis-mean pose); with ``part_based`` and
    ``mean_pos`` also {part: (S,)} errors."""
    if part_based:
        predicted = geometry.center_pose_parts(predicted)
        target = geometry.center_pose_parts(target)

    if not mean_pos:
        errors = torch.linalg.norm(predicted - target[:, None, None], dim=-1)
        return errors.min(dim=2).values.mean(dim=(0, 2, 3))

    mean_pose = predicted.mean(dim=2)                            # (B,S,F,N,C)
    errors = torch.linalg.norm(mean_pose - target[:, None], dim=-1)
    agg = errors.mean(dim=(0, 2, 3))
    if part_based:
        tables = parts_joint_indices or sk.PARTS_JOINT_INDICES
        return agg, {p: _joints(errors, idx).mean(dim=(0, 2, 3))
                     for p, idx in tables.items()}
    return agg


def mpjpe_diffusion(predicted: torch.Tensor, target: torch.Tensor,
                    mean_pos: bool = False, part_based: bool = False,
                    parts_joint_indices=None):
    """P_Best: the hypothesis with the least batch-mean error, per step.

    Returns ``(errors_S, part_errors)``, the dict empty unless
    ``part_based`` (then each part's error of the selected hypothesis);
    with ``mean_pos`` just the (S,) P_Agg vector."""
    if part_based:
        predicted = geometry.center_pose_parts(predicted)
        target = geometry.center_pose_parts(target)
    else:
        predicted = geometry.center_pose_at_root(predicted)
        target = geometry.center_pose_at_root(target)

    if mean_pos:
        errors = torch.linalg.norm(predicted.mean(dim=2) - target[:, None],
                                   dim=-1)
        return errors.mean(dim=(0, 2, 3))

    errors = torch.linalg.norm(predicted - target[:, None, None], dim=-1)
    per_h = errors.mean(dim=(0, 3, 4))                           # (S, H)
    min_errors = per_h.min(dim=1).values

    part_errors: Dict[str, torch.Tensor] = {}
    if part_based:
        min_inds = per_h.argmin(dim=1)                           # (S,)
        tables = parts_joint_indices or sk.PARTS_JOINT_INDICES
        for p, idx in tables.items():
            pe = _joints(errors, idx).mean(dim=(0, 3, 4))        # (S, H)
            part_errors[p] = pe.gather(1, min_inds[:, None])[:, 0]
    return min_errors, part_errors


def mpjpe_diffusion_reproj(predicted: torch.Tensor, target: torch.Tensor,
                           reproj_2d: torch.Tensor,
                           target_2d: torch.Tensor) -> torch.Tensor:
    """J_Agg: per joint, the hypothesis with the least 2D reprojection
    error."""
    errors = torch.linalg.norm(predicted - target[:, None, None], dim=-1)
    errors_2d = torch.linalg.norm(reproj_2d - target_2d[:, None, None], dim=-1)
    sel = errors_2d.argmin(dim=2, keepdim=True)                  # (B,S,1,F,N)
    return errors.gather(2, sel).mean(dim=(0, 2, 3, 4))


def mpjpe_diffusion_3dhp(predicted: torch.Tensor, target: torch.Tensor,
                         valid_frame: torch.Tensor,
                         mean_pos: bool = False) -> torch.Tensor:
    """3DHP variant with a per-frame validity mask (B, F), applied before
    averaging."""
    mask = valid_frame.float()
    denom = mask.sum().clamp_min(1.0)
    if not mean_pos:
        errors = torch.linalg.norm(predicted - target[:, None, None], dim=-1)
        w = mask[:, None, None, :, None]
        per_h = (errors * w).sum(dim=(0, 3, 4)) / (denom * errors.shape[4])
        return per_h.min(dim=-1).values
    errors = torch.linalg.norm(predicted.mean(dim=2) - target[:, None], dim=-1)
    w = mask[:, None, :, None]
    return (errors * w).sum(dim=(0, 2, 3)) / (denom * errors.shape[-1])


# ---------------------------------------------------------------------------
# Protocol #2 (Procrustes-aligned), NumPy host side
# ---------------------------------------------------------------------------

def _procrustes_align(predicted: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Rigid-align predicted to target per item ((M, N, C) arrays)."""
    muX = np.mean(target, axis=1, keepdims=True)
    muY = np.mean(predicted, axis=1, keepdims=True)
    X0, Y0 = target - muX, predicted - muY
    normX = np.sqrt(np.sum(X0 ** 2, axis=(1, 2), keepdims=True))
    normY = np.sqrt(np.sum(Y0 ** 2, axis=(1, 2), keepdims=True))
    X0, Y0 = X0 / normX, Y0 / normY
    H = np.matmul(X0.transpose(0, 2, 1), Y0)
    U, s, Vt = np.linalg.svd(H)
    V = Vt.transpose(0, 2, 1)
    R = np.matmul(V, U.transpose(0, 2, 1))
    sign_detR = np.sign(np.expand_dims(np.linalg.det(R), axis=1))
    V[:, :, -1] *= sign_detR
    s[:, -1] *= sign_detR.flatten()
    R = np.matmul(V, U.transpose(0, 2, 1))
    tr = np.expand_dims(np.sum(s, axis=1, keepdims=True), axis=2)
    a = tr * normX / normY
    t = muX - a * np.matmul(muY, R)
    return a * np.matmul(predicted, R) + t


def p_mpjpe(predicted: np.ndarray, target: np.ndarray) -> float:
    aligned = _procrustes_align(predicted, target)
    return float(np.mean(np.linalg.norm(aligned - target, axis=-1)))


def p_mpjpe_diffusion_all_min(predicted, target, mean_pos: bool = False):
    """P2 J_Best, or P2 P_Agg with ``mean_pos``."""
    predicted = np.asarray(predicted)
    target = np.asarray(target)
    b, s, h, f, j, c = predicted.shape
    if mean_pos:
        predicted = predicted.mean(axis=2)
        tgt = np.broadcast_to(target[:, None], (b, s, f, j, c))
    else:
        tgt = np.broadcast_to(target[:, None, None], (b, s, h, f, j, c))
    aligned = _procrustes_align(predicted.reshape(-1, j, c),
                                tgt.reshape(-1, j, c))
    errors = np.linalg.norm(aligned - tgt.reshape(-1, j, c), axis=-1)
    if mean_pos:
        errors = errors.reshape(b, s, f, j)
        return errors.transpose(1, 0, 2, 3).reshape(s, -1).mean(axis=1)
    errors = errors.reshape(b, s, h, f, j).transpose(1, 2, 0, 3, 4)
    return errors.min(axis=1).reshape(s, -1).mean(axis=1)


def p_mpjpe_diffusion(predicted, target, mean_pos: bool = False):
    """P2 P_Best: per-hypothesis mean, then min."""
    predicted = np.asarray(predicted)
    target = np.asarray(target)
    b, s, h, f, j, c = predicted.shape
    if mean_pos:
        return p_mpjpe_diffusion_all_min(predicted, target, mean_pos=True)
    tgt = np.broadcast_to(target[:, None, None], (b, s, h, f, j, c))
    aligned = _procrustes_align(predicted.reshape(-1, j, c),
                                tgt.reshape(-1, j, c))
    errors = np.linalg.norm(aligned - tgt.reshape(-1, j, c), axis=-1)
    errors = errors.reshape(b, s, h, f, j).transpose(1, 2, 0, 3, 4)
    return errors.reshape(s, h, -1).mean(axis=2).min(axis=1)


def p_mpjpe_diffusion_reproj(predicted, target, reproj_2d, target_2d):
    """P2 J_Agg."""
    predicted = np.asarray(predicted)
    target = np.asarray(target)
    reproj_2d = np.asarray(reproj_2d)
    target_2d = np.asarray(target_2d)
    b, s, h, f, j, c = predicted.shape
    errors_2d = np.linalg.norm(reproj_2d - target_2d[:, None, None], axis=-1)
    sel = np.argmin(errors_2d, axis=2)[:, :, None]               # (b,s,1,f,j)
    tgt = np.broadcast_to(target[:, None, None], (b, s, h, f, j, c))
    aligned = _procrustes_align(predicted.reshape(-1, j, c),
                                tgt.reshape(-1, j, c))
    errors = np.linalg.norm(aligned - tgt.reshape(-1, j, c), axis=-1)
    picked = np.take_along_axis(errors.reshape(b, s, h, f, j), sel, axis=2)
    return picked.transpose(1, 2, 0, 3, 4).reshape(s, -1).mean(axis=1)


# ---------------------------------------------------------------------------
# Other metrics
# ---------------------------------------------------------------------------

def n_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Normalised MPJPE: the prediction scaled to fit the target first."""
    assert predicted.shape == target.shape
    norm_p = predicted.square().sum(dim=3, keepdim=True).mean(dim=2,
                                                              keepdim=True)
    norm_t = (target * predicted).sum(dim=3, keepdim=True).mean(dim=2,
                                                                keepdim=True)
    return mpjpe(norm_t / norm_p * predicted, target)


def mean_velocity_error_train(predicted: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    """Frame-difference velocity error over axis 1."""
    assert predicted.shape == target.shape
    vp = predicted[:, 1:] - predicted[:, :-1]
    vt = target[:, 1:] - target[:, :-1]
    return torch.linalg.norm(vp - vt, dim=-1).mean()


def mean_velocity_error(predicted: np.ndarray, target: np.ndarray,
                        axis: int = 0) -> float:
    vp = np.diff(predicted, axis=axis)
    vt = np.diff(target, axis=axis)
    return float(np.mean(np.linalg.norm(vp - vt, axis=-1)))
