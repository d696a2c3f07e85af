"""Pose geometry: screen normalisation, flip, quaternion rotation, camera
projection, part centring and whole-body assembly from part-centred poses.

Counterpart of ``pafuse_tpu/geometry.py``.  Tensor functions take the joint
axis at -2 and the coordinate axis at -1; the ``_np`` variants are NumPy
twins for host-side data preparation.  ``world_to_camera``, ``qinverse``
and ``image_coordinates`` are NumPy only: they serve host-side data
synthesis.
"""

from __future__ import annotations

import numpy as np
import torch

from pafuse_tpu_torch import skeleton as sk
from pafuse_tpu_torch.utils.device import to_device


def normalize_screen_coordinates(x: np.ndarray, w, h) -> np.ndarray:
    """Map pixel coordinates so that [0, w] -> [-1, 1], keeping the aspect
    ratio."""
    assert x.shape[-1] == 2
    return x / w * 2 - np.array([1, h / w], dtype=x.dtype)


def image_coordinates(x: np.ndarray, w, h) -> np.ndarray:
    """Inverse of :func:`normalize_screen_coordinates`."""
    assert x.shape[-1] == 2
    return (x + np.array([1, h / w], dtype=x.dtype)) * w / 2


def flip_pose(pose: torch.Tensor, flip_permutation) -> torch.Tensor:
    """Mirror a pose: negate x, then swap left and right joints."""
    sign = torch.ones(pose.shape[-1], dtype=pose.dtype, device=pose.device)
    sign[0] = -1.0
    perm = to_device(flip_permutation, pose.device, torch.long)
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


def qrot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`qrot`; q broadcasts over v's leading axes."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q: np.ndarray) -> np.ndarray:
    """Conjugate of a unit quaternion (w, x, y, z)."""
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def camera_to_world(x: torch.Tensor, rotation, translation) -> torch.Tensor:
    """Camera -> world frame."""
    r = torch.as_tensor(rotation, dtype=x.dtype, device=x.device)
    t = torch.as_tensor(translation, dtype=x.dtype, device=x.device)
    return qrot(r, x) + t


def world_to_camera(x: np.ndarray, rotation: np.ndarray,
                    translation: np.ndarray) -> np.ndarray:
    """World -> camera frame (NumPy)."""
    return qrot_np(qinverse(rotation), x - translation)


def _broadcast_camera(camera_params: torch.Tensor, x: torch.Tensor):
    cam = torch.as_tensor(camera_params, dtype=x.dtype, device=x.device)
    assert x.shape[-1] == 3 and cam.shape[-1] == 9
    while cam.dim() < x.dim():
        cam = cam[:, None]
    return cam


def project_to_2d(x: torch.Tensor, camera_params: torch.Tensor) -> torch.Tensor:
    """Project camera-space points (N, ..., 3) to normalised screen space
    with the H36M radial + tangential distortion model; camera_params
    (N, 9) = [fx fy cx cy k1 k2 k3 p1 p2], broadcast over x's middle axes."""
    cam = _broadcast_camera(camera_params, x)
    f, c, k, p = cam[..., :2], cam[..., 2:4], cam[..., 4:7], cam[..., 7:]
    xx = (x[..., :2] / x[..., 2:]).clamp(-1.0, 1.0)
    r2 = xx.square().sum(-1, keepdim=True)
    radial = 1 + (k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1)).sum(
        -1, keepdim=True)
    tan = (p * xx).sum(-1, keepdim=True)
    return f * (xx * (radial + tan) + p * r2) + c


def project_to_2d_linear(x: torch.Tensor,
                         camera_params: torch.Tensor) -> torch.Tensor:
    """Pinhole-only projection (no distortion) of camera-space points."""
    cam = _broadcast_camera(camera_params, x)
    xx = (x[..., :2] / x[..., 2:]).clamp(-1.0, 1.0)
    return cam[..., :2] * xx + cam[..., 2:4]


def uvd2xyz(uvd: torch.Tensor, gt_3d: torch.Tensor,
            cam: torch.Tensor) -> torch.Tensor:
    """Lift (u, v, depth) predictions (N, T, V, 3) to root-relative
    camera-space XYZ with the pinhole intrinsics; joint 0 of ``gt_3d``
    carries the absolute root depth; cam (..., >=4) = [fx fy cx cy ...]."""
    cam = torch.as_tensor(cam, dtype=uvd.dtype, device=uvd.device)
    f = cam[..., :2].reshape(-1, 1, 1, 2)
    c = cam[..., 2:4].reshape(-1, 1, 1, 2)
    root_z = gt_3d[:, :, 0:1, 2]                                  # (N,T,1)
    z_global = torch.cat([root_z, uvd[:, :, 1:, 2] + root_z],
                         dim=2)[..., None]                        # (N,T,V,1)
    xy = (uvd[..., :2] - c) * z_global / f
    xyz = torch.cat([xy, z_global], dim=-1)
    return xyz - xyz[:, :, 0:1, :]


def flip_intrinsics_np(cam: np.ndarray) -> np.ndarray:
    """Mirror camera intrinsics: negate the horizontal centre and the
    tangential distortion p1 (NumPy)."""
    out = cam.copy()
    out[..., 2] *= -1
    out[..., 7] *= -1
    return out


def project_to_2d_np(x: np.ndarray, camera_params: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`project_to_2d`."""
    assert x.shape[-1] == 3 and camera_params.shape[-1] == 9
    while camera_params.ndim < x.ndim:
        camera_params = camera_params[:, None]
    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    k = camera_params[..., 4:7]
    p = camera_params[..., 7:]
    xx = np.clip(x[..., :2] / x[..., 2:], -1.0, 1.0)
    r2 = np.sum(xx ** 2, axis=-1, keepdims=True)
    radial = 1 + np.sum(k * np.concatenate([r2, r2 ** 2, r2 ** 3], axis=-1),
                        axis=-1, keepdims=True)
    tan = np.sum(p * xx, axis=-1, keepdims=True)
    return f * (xx * (radial + tan) + p * r2) + c


def center_pose_at_root(pose: torch.Tensor, root_idx: int = 0) -> torch.Tensor:
    """Translate poses so that the root joint sits at the origin."""
    return pose - pose[..., root_idx:root_idx + 1, :]


def center_pose_parts(pose: torch.Tensor,
                      part_root_of_joint=None) -> torch.Tensor:
    """Centre each part (body, face, hands) at its own root:
    ``out[..., j, :] = pose[..., j, :] - pose[..., root_of(j), :]``."""
    table = (sk.PART_ROOT_OF_JOINT if part_root_of_joint is None
             else part_root_of_joint)
    idx = to_device(np.asarray(table), pose.device, torch.long)
    return pose - pose.index_select(-2, idx)


def wb_pose_from_parts(part_pose: torch.Tensor,
                       connection_of_joint=None) -> torch.Tensor:
    """Re-attach part-centred poses to the body:
    ``out[..., j, :] = pose[..., j, :] + pose[..., connection_of(j), :]``,
    except that self-connected joints (the body root) come out exactly zero,
    as in the reference, whose in-place root revert zeroes the root."""
    table = np.asarray(sk.CONNECTION_OF_JOINT if connection_of_joint is None
                       else connection_of_joint)
    idx = to_device(table, part_pose.device, torch.long)
    out = part_pose + part_pose.index_select(-2, idx)
    self_connected = table == np.arange(table.shape[0])
    if np.any(self_connected):
        mask = to_device(~self_connected, out.device, out.dtype)[:, None]
        out = out * mask
    return out
