"""Skeleton tables: H3WB (Human3.6M WholeBody) for the lifting path and
the 17-joint MPI-INF-3DHP body.

Own copy of the tables in ``pafuse_tpu/skeleton.py`` (the port imports
nothing of the JAX package).  H3WB has 134 joints, the COCO-WholeBody
133-keypoint layout with a synthetic root (mid-hip) at index 0:

====================  ==========  =====
part                  indices     count
====================  ==========  =====
root (synthetic)      0           1
body (COCO-17)        1..17       17
left foot             18..20      3
right foot            21..23      3
face (iBUG-68)        24..91      68
left hand             92..112     21
right hand            113..133    21
====================  ==========  =====
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NUM_JOINTS = 134
ROOT_INDEX = 0

_BODY = list(range(1, 18))
_LEFT_FOOT = [18, 19, 20]
_RIGHT_FOOT = [21, 22, 23]
_FACE = list(range(24, 92))
_LEFT_HAND = list(range(92, 113))
_RIGHT_HAND = list(range(113, 134))

#: part -> joint indices; ``body`` holds the root and both feet.
PARTS_JOINT_INDICES: Dict[str, List[int]] = {
    "body": [ROOT_INDEX] + _BODY + _LEFT_FOOT + _RIGHT_FOOT,   # 24 joints
    "face": list(_FACE),                                        # 68 joints
    "left_hand": list(_LEFT_HAND),                              # 21 joints
    "right_hand": list(_RIGHT_HAND),                            # 21 joints
}

#: per-part root joint: the mid-hip root, the nose tip (face landmark #30)
#: and the wrist of each hand.
ROOT_INDICES: Dict[str, int] = {
    "body": 0,
    "face": 54,
    "left_hand": 92,
    "right_hand": 113,
}

#: body joints the other parts re-attach to: nose (1), left wrist (10),
#: right wrist (11).
PARTS_CONNECTION_INDICES: Dict[str, int] = {
    "face": 1,
    "left_hand": 10,
    "right_hand": 11,
}


def parts_table(merge_hands: bool) -> Dict[str, List[int]]:
    """Part -> joint indices; ``merge_hands`` joins both hands into one
    ``hands`` part (body 0..23, face 24..91, hands 92..133)."""
    if not merge_hands:
        return {k: list(v) for k, v in PARTS_JOINT_INDICES.items()}
    return {
        "body": list(PARTS_JOINT_INDICES["body"]),
        "face": list(PARTS_JOINT_INDICES["face"]),
        "hands": list(PARTS_JOINT_INDICES["left_hand"])
        + list(PARTS_JOINT_INDICES["right_hand"]),
    }


def _build_connection_of_joint() -> np.ndarray:
    table = np.zeros(NUM_JOINTS, dtype=np.int32)
    for part, joints in PARTS_JOINT_INDICES.items():
        table[joints] = PARTS_CONNECTION_INDICES.get(part, 0)
    return table


#: CONNECTION_OF_JOINT[j] = body joint that part-local joint j re-attaches
#: to (body joints attach to the root, which attaches to itself).
CONNECTION_OF_JOINT: np.ndarray = _build_connection_of_joint()


def _build_root_of_joint() -> np.ndarray:
    table = np.zeros(NUM_JOINTS, dtype=np.int32)
    for part, joints in PARTS_JOINT_INDICES.items():
        table[joints] = ROOT_INDICES[part]
    return table


#: PART_ROOT_OF_JOINT[j] = root joint of the part that owns joint j.
PART_ROOT_OF_JOINT: np.ndarray = _build_root_of_joint()


def _build_symmetry() -> Tuple[List[int], List[int]]:
    left: List[int] = []
    right: List[int] = []
    # COCO body (left, right) pairs, +1 for the root offset
    for l, r in [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                 (13, 14), (15, 16)]:
        left.append(l + 1)
        right.append(r + 1)
    for l, r in zip(_LEFT_FOOT, _RIGHT_FOOT):
        left.append(l)
        right.append(r)
    # iBUG-68 mirror pairs (local landmark ids, subject's right side first)
    face_pairs_rl = (
        [(i, 16 - i) for i in range(8)]            # jaw contour
        + [(17 + i, 26 - i) for i in range(5)]     # eyebrows
        + [(31, 35), (32, 34)]                     # nostrils
        + [(36, 45), (37, 44), (38, 43), (39, 42), (40, 47), (41, 46)]
        + [(48, 54), (49, 53), (50, 52), (59, 55), (58, 56)]  # outer lips
        + [(60, 64), (61, 63), (67, 65)]           # inner lips
    )
    for r, l in face_pairs_rl:
        left.append(l + _FACE[0])
        right.append(r + _FACE[0])
    for l, r in zip(_LEFT_HAND, _RIGHT_HAND):
        left.append(l)
        right.append(r)
    return left, right


JOINTS_LEFT, JOINTS_RIGHT = _build_symmetry()


def flip_permutation_from_symmetry(joints_left, joints_right,
                                   num_joints: int = NUM_JOINTS) -> np.ndarray:
    """Permutation P with P[left] = right, P[right] = left, identity
    elsewhere."""
    perm = np.arange(num_joints, dtype=np.int32)
    perm[np.asarray(joints_left)] = np.asarray(joints_right, dtype=np.int32)
    perm[np.asarray(joints_right)] = np.asarray(joints_left, dtype=np.int32)
    return perm


def symmetry_from_metadata(metadata, add_root: bool = True):
    """``joints_left/right`` from an H3WB npz metadata record: keypoints
    listed on both sides (the midline) are dropped from both lists, then
    every index moves up by one for the synthetic root at joint 0.  The
    pairing left[i] <-> right[i] is the metadata's own order."""
    joints_left = list(metadata["left_side"])
    joints_right = list(metadata["right_side"])
    dups = [kp for kp in joints_left if kp in joints_right]
    offset = 1 if add_root else 0
    left = [int(e) + offset for e in joints_left if e not in dups]
    right = [int(e) + offset for e in joints_right if e not in dups]
    return left, right


FLIP_PERMUTATION: np.ndarray = flip_permutation_from_symmetry(
    JOINTS_LEFT, JOINTS_RIGHT)

#: the 133-keypoint layout without the synthetic root (``data.num_kps=133``):
#: the same mirror pairs, one index lower.
FLIP_PERMUTATION_NO_ROOT: np.ndarray = flip_permutation_from_symmetry(
    [j - 1 for j in JOINTS_LEFT], [j - 1 for j in JOINTS_RIGHT],
    num_joints=NUM_JOINTS - 1)


def _build_parents() -> np.ndarray:
    """Parent of each joint (-1: none; the face landmarks are dots): the
    COCO body with the root inserted at 0, feet on the ankles, each hand's
    21 joints on its wrist."""
    body = [-1, -1, -1, -1, -1, -1, 0, 0, 6, 7, 8, 9, 0, 0, 12, 13, 14, 15]
    left_foot = [15, 15, 15]
    right_foot = [16, 16, 16]
    face = [-1] * 68
    left_hand = [9, 91, 92, 93, 94, 91, 96, 97, 98, 91, 100, 101, 102, 91,
                 104, 105, 106, 91, 108, 109, 110]
    right_hand = [10, 112, 113, 114, 115, 112, 117, 118, 119, 112, 121, 122,
                  123, 112, 125, 126, 127, 112, 129, 130, 131]
    shifted = [j + 1 for j in left_foot + right_foot]
    hands = [j + 1 for j in left_hand + right_hand]
    return np.asarray(body + shifted + face + hands, dtype=np.int32)


#: PARENTS[j] = parent joint of j in the H3WB skeleton (-1: none).
PARENTS: np.ndarray = _build_parents()

#: the 17-joint MPI-INF-3DHP body (Human3.6M-17 order) of the 3DHP model
NUM_JOINTS_3DHP = 17
JOINTS_LEFT_3DHP = [5, 6, 7, 11, 12, 13]
JOINTS_RIGHT_3DHP = [2, 3, 4, 8, 9, 10]
FLIP_PERMUTATION_3DHP: np.ndarray = flip_permutation_from_symmetry(
    JOINTS_LEFT_3DHP, JOINTS_RIGHT_3DHP, NUM_JOINTS_3DHP)
