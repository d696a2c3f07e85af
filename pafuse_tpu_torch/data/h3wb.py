"""H3WB dataset: loading, root-joint injection, synthetic stand-in, prep.

Counterpart of ``pafuse_tpu/data/h3wb.py`` in NumPy alone.  Two sources:

* **Real data**: ``<data_dir>/train_h3wb.npz`` (+ ``task1_test_3d.npz``) in
  the official H3WB release format.
* **Synthetic data**: a deterministic dataset with the same structure,
  smooth random 3D motion projected to 2D through the real H36M cameras,
  generated from a seed with the same draws as the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from pafuse_tpu_torch import geometry, skeleton as sk
from pafuse_tpu_torch.data import cameras as cam_tables
from pafuse_tpu_torch.utils.misc import deterministic_random


class Human3WBDataset:
    """``dataset[subject][action]`` -> dict with ``positions`` (global 3D,
    mm), ``positions_3d`` (per camera, camera space: mm, metres after
    :func:`prepare_data`) and ``pose_2d`` (per camera: pixels, normalised
    screen coordinates after :func:`prepare_data`).  ``flip_permutation``
    follows the npz metadata's symmetry when there is one."""

    def __init__(self, data: Dict[str, Dict[str, dict]],
                 cameras: Dict[str, List[dict]],
                 joints_left: Optional[List[int]] = None,
                 joints_right: Optional[List[int]] = None):
        self._data = data
        self._cameras = cameras
        self.flip_permutation = sk.flip_permutation_from_symmetry(
            sk.JOINTS_LEFT if joints_left is None else joints_left,
            sk.JOINTS_RIGHT if joints_right is None else joints_right,
            sk.NUM_JOINTS)

    def subjects(self):
        return self._data.keys()

    def cameras(self):
        return self._cameras

    def __getitem__(self, subject):
        return self._data[subject]


# ---------------------------------------------------------------------------
# Real data
# ---------------------------------------------------------------------------

def _add_root(poses: np.ndarray, hip_indices=(11, 12)) -> np.ndarray:
    """Insert the mid-hip root at joint 0: (F, 133, C) -> (F, 134, C)."""
    f, j, c = poses.shape
    out = np.zeros((f, j + 1, c), dtype=poses.dtype)
    out[:, 1:] = poses
    out[:, 0] = 0.5 * (poses[:, hip_indices[0]] + poses[:, hip_indices[1]])
    return out


def load_real(data_dir: str) -> Human3WBDataset:
    """Load the official npz files; flip symmetry from their metadata when
    present."""
    raw = np.load(os.path.join(data_dir, "train_h3wb.npz"), allow_pickle=True)
    train_data = raw["train_data"].item()
    test_path = os.path.join(data_dir, "task1_test_3d.npz")
    if os.path.exists(test_path):
        train_data.update(np.load(test_path, allow_pickle=True)["data"].item())

    joints_left = joints_right = None
    if "metadata" in getattr(raw, "files", []):
        meta = raw["metadata"].item()
        if "left_side" in meta and "right_side" in meta:
            joints_left, joints_right = sk.symmetry_from_metadata(meta)

    cameras = cam_tables.build_cameras()
    data: Dict[str, Dict[str, dict]] = {}
    for subject, actions in train_data.items():
        data[subject] = {}
        for action, act in actions.items():
            data[subject][action] = {
                "positions": _add_root(np.squeeze(act["global_3d"])),
                "positions_3d": [_add_root(np.squeeze(act[c]["camera_3d"]))
                                 for c in cam_tables.CAMERA_ORDER_IDS],
                "pose_2d": [_add_root(np.squeeze(act[c]["pose_2d"]))
                            for c in cam_tables.CAMERA_ORDER_IDS],
            }
    return Human3WBDataset(data, cameras, joints_left=joints_left,
                           joints_right=joints_right)


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------

def _smooth_noise(rng: np.random.RandomState, frames: int, shape, sigma=8):
    """Low-frequency random walk: gaussian noise smoothed along time."""
    x = rng.randn(frames + 2 * sigma * 3, *shape).astype(np.float32)
    kernel = np.exp(-0.5 * (np.arange(-3 * sigma, 3 * sigma + 1) / sigma) ** 2)
    kernel /= kernel.sum()
    x = np.apply_along_axis(lambda m: np.convolve(m, kernel, mode="valid"), 0, x)
    return x[:frames]


def _synth_pose_track(rng: np.random.RandomState, frames: int) -> np.ndarray:
    """A plausible (F, 134, 3) global pose track in millimetres."""
    template = np.zeros((sk.NUM_JOINTS, 3), dtype=np.float32)
    template[:, 2] = 1000.0
    body_z = np.array([1000, 1600, 1600, 1620, 1620, 1450, 1450, 1250, 1250,
                       1050, 1050, 1000, 1000, 600, 600, 150, 150],
                      dtype=np.float32)
    body_x = np.array([0, -40, 40, -90, 90, -200, 200, -260, 260, -300, 300,
                       -120, 120, -130, 130, -140, 140], dtype=np.float32)
    template[1:18, 2] = body_z
    template[1:18, 0] = body_x
    template[18:21] = template[16] + np.array([[-30, 80, -30]]) * np.arange(1, 4)[:, None] / 3
    template[21:24] = template[17] + np.array([[30, 80, -30]]) * np.arange(1, 4)[:, None] / 3
    template[24:92] = template[1] + rng.uniform(-80, 80, (68, 3)).astype(np.float32)
    lh_local = rng.uniform(-90, 90, (21, 3)).astype(np.float32)
    rh_local = rng.uniform(-90, 90, (21, 3)).astype(np.float32)
    template[92:113] = template[10] + lh_local
    template[113:134] = template[11] + rh_local

    global_drift = _smooth_noise(rng, frames, (3,)) * 300.0
    jitter = _smooth_noise(rng, frames, (sk.NUM_JOINTS, 3)) * 60.0
    track = template[None] + global_drift[:, None, :] + jitter
    track[..., 1] += 3000.0  # keep in front of the cameras
    # the root is the mid-hip, as _add_root makes it
    track[:, 0] = 0.5 * (track[:, 12] + track[:, 13])
    # H3WB coincidences: face root == nose, hand roots == wrists
    track[:, 54] = track[:, 1]
    track[:, 92] = track[:, 10]
    track[:, 113] = track[:, 11]
    return track.astype(np.float32)


def make_synthetic(subjects=("S1", "S5", "S6", "S7", "S8"),
                   actions_per_subject: int = 2,
                   frames_per_action: int = 120,
                   seed: int = 0) -> Human3WBDataset:
    """An H3WB-shaped dataset with real camera geometry, from ``seed``."""
    rng = np.random.RandomState(seed)
    cameras = cam_tables.build_cameras(subjects)
    action_names = ["Walking", "Sitting", "Eating", "Posing", "Phoning",
                    "Greeting"]
    data: Dict[str, Dict[str, dict]] = {}
    for subject in subjects:
        data[subject] = {}
        for a in range(actions_per_subject):
            name = (f"{action_names[a % len(action_names)]} "
                    f"{a // len(action_names) + 1}")
            world_mm = _synth_pose_track(rng, frames_per_action)
            positions_3d, pose_2d = [], []
            for cam in cameras[subject]:
                cam3d_m = geometry.world_to_camera(
                    world_mm / 1000.0, cam["orientation"],
                    cam["translation"]).astype(np.float32)
                proj = geometry.project_to_2d_np(cam3d_m[None],
                                                 cam["intrinsic"][None])[0]
                px = geometry.image_coordinates(proj.astype(np.float32),
                                                w=cam["res_w"], h=cam["res_h"])
                positions_3d.append(cam3d_m * 1000.0)   # mm, like the npz
                pose_2d.append(px.astype(np.float32))
            data[subject][name] = {"positions": world_mm,
                                   "positions_3d": positions_3d,
                                   "pose_2d": pose_2d}
    return Human3WBDataset(data, cameras)


# ---------------------------------------------------------------------------
# Prep and selection
# ---------------------------------------------------------------------------

def prepare_data(dataset: Human3WBDataset
                 ) -> Dict[str, Dict[str, List[np.ndarray]]]:
    """In place: 3D mm -> m and 2D pixels -> normalised screen coordinates.
    Returns the normalised 2D keypoints {subject: {action: [per camera]}}."""
    keypoints: Dict[str, Dict[str, List[np.ndarray]]] = {}
    for subject in dataset.subjects():
        keypoints[subject] = {}
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            anim["positions_3d"] = [(p / 1000.0).astype(np.float32)
                                    for p in anim["positions_3d"]]
            kps_list = []
            for cam_idx, kps in enumerate(anim["pose_2d"]):
                cam = dataset.cameras()[subject][cam_idx]
                kps = kps.astype(np.float32)
                kps[..., :2] = geometry.normalize_screen_coordinates(
                    kps[..., :2], w=cam["res_w"], h=cam["res_h"])
                kps_list.append(kps)
            anim["pose_2d"] = kps_list
            keypoints[subject][action] = kps_list
    return keypoints


def load_dataset(data_dir: str = "data", synthetic: str | bool = "auto",
                 **synth_kwargs) -> Human3WBDataset:
    """Real data if present, else synthetic (per ``synthetic``)."""
    real_exists = os.path.exists(os.path.join(data_dir, "train_h3wb.npz"))
    if synthetic is True or (str(synthetic) == "auto" and not real_exists):
        return make_synthetic(**synth_kwargs)
    if not real_exists:
        raise FileNotFoundError(
            f"train_h3wb.npz not found under {data_dir!r} and synthetic data "
            "disabled")
    return load_real(data_dir)


def fetch(subjects, keypoints, dataset, stride: int = 1, action_filter=None,
          subset: float = 1.0, parse_3d_poses: bool = True):
    """Per-(subject, action, camera) arrays: (cameras, poses_3d, poses_2d);
    ``subset`` < 1 keeps a deterministic window of each sequence."""
    out_poses_3d, out_poses_2d, out_cams = [], [], []
    for subject in subjects:
        for action in keypoints[subject].keys():
            if action_filter is not None and not any(
                    action.startswith(a) for a in action_filter):
                continue
            poses_2d = keypoints[subject][action]
            out_poses_2d.extend(poses_2d)
            if subject in dataset.cameras():
                cams = dataset.cameras()[subject]
                assert len(cams) == len(poses_2d), "Camera count mismatch"
                out_cams.extend(c["intrinsic"] for c in cams if "intrinsic" in c)
            if parse_3d_poses and "positions_3d" in dataset[subject][action]:
                poses_3d = dataset[subject][action]["positions_3d"]
                assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
                out_poses_3d.extend(poses_3d)

    out_cams = out_cams or None
    out_poses_3d = out_poses_3d or None
    if subset < 1:
        for i in range(len(out_poses_2d)):
            n = len(out_poses_2d[i])
            n_frames = int(round(n // stride * subset) * stride)
            start = deterministic_random(0, n - n_frames + 1, str(n))
            out_poses_2d[i] = out_poses_2d[i][start:start + n_frames:stride]
            if out_poses_3d is not None:
                out_poses_3d[i] = out_poses_3d[i][start:start + n_frames:stride]
    elif stride > 1:
        for i in range(len(out_poses_2d)):
            out_poses_2d[i] = out_poses_2d[i][::stride]
            if out_poses_3d is not None:
                out_poses_3d[i] = out_poses_3d[i][::stride]
    return out_cams, out_poses_3d, out_poses_2d


def fetch_actions(actions, keypoints, dataset, stride: int = 1):
    """Arrays for a list of (subject, action) pairs."""
    out_poses_3d, out_poses_2d, out_cams = [], [], []
    for subject, action in actions:
        poses_2d = keypoints[subject][action]
        out_poses_2d.extend(poses_2d)
        poses_3d = dataset[subject][action]["positions_3d"]
        assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
        out_poses_3d.extend(poses_3d)
        if subject in dataset.cameras():
            cams = dataset.cameras()[subject]
            out_cams.extend(c["intrinsic"] for c in cams if "intrinsic" in c)
    if stride > 1:
        for i in range(len(out_poses_2d)):
            out_poses_2d[i] = out_poses_2d[i][::stride]
            out_poses_3d[i] = out_poses_3d[i][::stride]
    return out_cams, out_poses_3d, out_poses_2d
