"""Pose geometry on the lifting path: screen normalisation, flip, quaternion
rotation and whole-body assembly from part-centred poses.

Counterpart of ``pafuse_tpu/geometry.py``.  Tensor functions take the joint
axis at -2 and the coordinate axis at -1; the ``_np`` variants are NumPy
twins for host-side request preparation.
"""

from __future__ import annotations

import numpy as np
import torch

from pafuse_tpu_torch import skeleton as sk


def normalize_screen_coordinates(x: np.ndarray, w, h) -> np.ndarray:
    """Map pixel coordinates so that [0, w] -> [-1, 1], keeping the aspect
    ratio."""
    assert x.shape[-1] == 2
    return x / w * 2 - np.array([1, h / w], dtype=x.dtype)


def flip_pose(pose: torch.Tensor, flip_permutation) -> torch.Tensor:
    """Mirror a pose: negate x, then swap left and right joints."""
    sign = torch.ones(pose.shape[-1], dtype=pose.dtype, device=pose.device)
    sign[0] = -1.0
    perm = torch.as_tensor(flip_permutation, dtype=torch.long,
                           device=pose.device)
    return (pose * sign).index_select(-2, perm)


def flip_pose_np(pose: np.ndarray, flip_permutation=None) -> np.ndarray:
    """NumPy twin of :func:`flip_pose`."""
    perm = sk.FLIP_PERMUTATION if flip_permutation is None else flip_permutation
    out = pose.copy()
    out[..., 0] *= -1
    return out[..., perm, :]


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), (w, x, y, z)."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:].expand(v.shape)
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def camera_to_world(x: torch.Tensor, rotation, translation) -> torch.Tensor:
    """Camera -> world frame."""
    r = torch.as_tensor(rotation, dtype=x.dtype, device=x.device)
    t = torch.as_tensor(translation, dtype=x.dtype, device=x.device)
    return qrot(r, x) + t


def wb_pose_from_parts(part_pose: torch.Tensor,
                       connection_of_joint=None) -> torch.Tensor:
    """Re-attach part-centred poses to the body:
    ``out[..., j, :] = pose[..., j, :] + pose[..., connection_of(j), :]``,
    except that self-connected joints (the body root) come out exactly zero,
    as in the reference, whose in-place root revert zeroes the root."""
    table = np.asarray(sk.CONNECTION_OF_JOINT if connection_of_joint is None
                       else connection_of_joint)
    idx = torch.as_tensor(table, dtype=torch.long, device=part_pose.device)
    out = part_pose + part_pose.index_select(-2, idx)
    self_connected = table == np.arange(table.shape[0])
    if np.any(self_connected):
        mask = torch.as_tensor(~self_connected, dtype=out.dtype,
                               device=out.device)[:, None]
        out = out * mask
    return out
