"""Rendering of 134-joint whole-body skeletons (NumPy and matplotlib).

Own copy of ``pafuse_tpu/viz.py``: per-part coloured skeletons, ground truth
against each hypothesis, the selected prediction per frame, and animations
with an optional 2D keypoint overlay on the source video.  The bones come
from the parent table of :mod:`pafuse_tpu_torch.skeleton`; matplotlib is
imported inside each function (Agg backend), so importing this module needs
neither it nor a display.  Files have the JAX package's names.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from pafuse_tpu_torch import skeleton as sk

PART_COLORS = {
    "body": "tab:blue",
    "face": "tab:green",
    "left_hand": "tab:red",
    "right_hand": "tab:purple",
}


def _part_of_joint():
    table = {}
    for part, joints in sk.PARTS_JOINT_INDICES.items():
        for j in joints:
            table[j] = part
    return table


_PART_OF_JOINT = _part_of_joint()


def _limbs():
    """(child, parent, part) bone list from the parent table."""
    out = []
    for child, parent in enumerate(sk.PARENTS):
        if parent >= 0:
            out.append((child, int(parent), _PART_OF_JOINT[child]))
    return out


LIMBS = _limbs()


def draw_skeleton(ax, pose: np.ndarray, *, color_override: Optional[str] = None,
                  point_size: float = 2.0, linewidth: float = 1.0):
    """Draw one (134, 3) pose on a 3D axis with per-part colors; face joints
    are drawn as dots only (face parents are -1 in the reference's table,
    h3wb_dataset.py:150)."""
    for child, parent, part in LIMBS:
        c = color_override or PART_COLORS[part]
        ax.plot([pose[child, 0], pose[parent, 0]],
                [pose[child, 1], pose[parent, 1]],
                [pose[child, 2], pose[parent, 2]],
                color=c, linewidth=linewidth)
    for part, joints in sk.PARTS_JOINT_INDICES.items():
        c = color_override or PART_COLORS[part]
        pts = pose[joints]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size, c=c)


def draw_skeleton_2d(ax, pose: np.ndarray, *,
                     color_override: Optional[str] = None,
                     point_size: float = 2.0, linewidth: float = 1.0):
    """2D variant for keypoint overlays."""
    for child, parent, part in LIMBS:
        c = color_override or PART_COLORS[part]
        ax.plot([pose[child, 0], pose[parent, 0]],
                [pose[child, 1], pose[parent, 1]], color=c, linewidth=linewidth)
    for part, joints in sk.PARTS_JOINT_INDICES.items():
        c = color_override or PART_COLORS[part]
        pts = pose[joints]
        ax.scatter(pts[:, 0], pts[:, 1], s=point_size, c=c)


def _new_3d_axis(fig, idx, rows, cols, *, azim=70.0, elev=15.0, radius=1.7):
    ax = fig.add_subplot(rows, cols, idx, projection="3d")
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlim3d([-radius / 2, radius / 2])
    ax.set_zlim3d([0, radius])
    ax.set_ylim3d([-radius / 2, radius / 2])
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    ax.dist = 7.5
    return ax


def draw_3d_image(predictions: np.ndarray, gt: Optional[np.ndarray],
                  out_dir: str, *, azim: float = 70.0, prefix: str = "frame",
                  max_frames: Optional[int] = None):
    """Per-frame, per-DDIM-step renders to ``{out_dir}/{prefix}{f}_t{s}.png``
    (capability of in_the_wild/visualization.py:195-281 and
    common/visualization.py:372-449).

    predictions: (S, H, F, J, 3); the mean pose over hypotheses is drawn per
    step; if ``gt`` (F, J, 3) is given it is drawn alongside in blue.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    S, H, F = predictions.shape[:3]
    frames = range(min(F, max_frames) if max_frames else F)
    for f in frames:
        for s in range(S):
            fig = plt.figure(figsize=(6 if gt is None else 12, 6))
            cols = 1 if gt is None else 2
            if gt is not None:
                ax = _new_3d_axis(fig, 1, 1, cols, azim=azim)
                draw_skeleton(ax, gt[f], color_override="tab:blue")
                ax.set_title("GT")
            ax = _new_3d_axis(fig, cols, 1, cols, azim=azim)
            draw_skeleton(ax, predictions[s, :, f].mean(axis=0),
                          color_override="tab:red")
            ax.set_title(f"pred t{s}")
            fig.savefig(os.path.join(out_dir, f"{prefix}{f}_t{s}.png"),
                        bbox_inches="tight", dpi=80)
            plt.close(fig)


def draw_3d_image_hypotheses(predictions: np.ndarray, gt: np.ndarray,
                             out_dir: str, *, azim: float = 70.0,
                             frame_skip: int = 5, steps: str = "last",
                             prefix: str = "", linewidth: float = 0.5,
                             max_frames: Optional[int] = None,
                             show_gt: bool = True):
    """GT vs EACH hypothesis (reference ``draw_3d_image``,
    common/visualization.py:372-449): one figure per frame/step with the GT
    skeleton in solid blue and every hypothesis dashed in its own tableau
    color; poses root-centered and scaled to millimeters like the reference.

    predictions: (S, H, F, J, 3); gt: (F, J, 3).  ``steps``: 'last' renders
    only the final DDIM step (reference behavior), 'all' renders each.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    colors = list(mcolors.TABLEAU_COLORS.values())
    S, H, F = predictions.shape[:3]
    step_range = range(S - 1, S) if steps == "last" else range(S)
    frames = range(0, min(F, max_frames) if max_frames else F,
                   max(1, frame_skip))
    for f in frames:
        gt_c = (gt[f] - gt[f, 0:1]) * 1000.0
        for s in step_range:
            pred_c = (predictions[s, :, f]
                      - predictions[s, :, f, 0:1]) * 1000.0  # (H, J, 3)
            fig = plt.figure()
            ax = _new_3d_axis(fig, 1, 1, 1, azim=azim - 70.0, radius=1500.0)
            ax.set_zlim3d([-750.0, 750.0])
            ax.set_xlim3d([-500.0, 500.0])
            ax.set_ylim3d([-500.0, 500.0])
            for h in range(H):
                for child, parent, _ in LIMBS:
                    ax.plot([pred_c[h, child, 0], pred_c[h, parent, 0]],
                            [pred_c[h, child, 1], pred_c[h, parent, 1]],
                            [pred_c[h, child, 2], pred_c[h, parent, 2]],
                            zdir="z", linestyle="--", linewidth=linewidth,
                            c=colors[h % len(colors)])
            if show_gt:   # viz.viz_no_ground_truth hides the blue skeleton
                for child, parent, _ in LIMBS:
                    ax.plot([gt_c[child, 0], gt_c[parent, 0]],
                            [gt_c[child, 1], gt_c[parent, 1]],
                            [gt_c[child, 2], gt_c[parent, 2]],
                            zdir="z", c="blue", linewidth=0.9)
            fig.savefig(os.path.join(out_dir,
                                     f"{prefix}hyp_f{f}_t{s}.png"),
                        bbox_inches="tight", pad_inches=0.0, dpi=150)
            plt.close(fig)


def draw_3d_image_select(predictions: np.ndarray, selected: np.ndarray,
                         gt: np.ndarray, out_dir: str, *,
                         azim: float = 70.0, max_frames: Optional[int] = None,
                         frame_skip: int = 1, show_gt: bool = True):
    """GT (blue) + J-Agg-selected prediction (red) per frame and step
    (capability of common/visualization.py:451-565, driven by
    main_draw_h3wb.py:660-667).

    predictions: (S, H, F, J, 3); selected: (S, F, J, 3); gt: (F, J, 3).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    S, H, F = predictions.shape[:3]
    frames = range(0, min(F, max_frames) if max_frames else F,
                   max(1, frame_skip))
    for f in frames:
        for s in range(S):
            fig = plt.figure(figsize=(6, 6))
            ax = _new_3d_axis(fig, 1, 1, 1, azim=azim)
            if show_gt:   # viz.viz_no_ground_truth
                draw_skeleton(ax, gt[f], color_override="tab:blue")
            draw_skeleton(ax, selected[s, f], color_override="tab:red")
            fig.savefig(os.path.join(out_dir, f"select_f{f}_t{s}.png"),
                        bbox_inches="tight", dpi=80)
            plt.close(fig)


def render_animation(poses: Dict[str, np.ndarray], fps: int, output: str, *,
                     azim: float = 70.0, bitrate: int = 3000,
                     limit: int = -1, size: float = 5.0,
                     keypoints_2d: Optional[np.ndarray] = None,
                     viewport=(1000, 1002),
                     input_video_frames=None, input_video_skip: int = 0,
                     downsample: int = 1):
    """Animate named 3D pose sequences side by side to mp4/gif
    (capability of common/visualization.py:726-909).

    ``input_video_frames``: the source video as a backdrop behind the 2D
    keypoint overlay — a (T, H, W, 3) array, a list of images, or a callable
    ``frame_index -> image`` (reference reads the video with ffmpeg,
    visualization.py:838-846).  ``input_video_skip`` skips that many leading
    video frames (reference ``viz_skip``); ``downsample`` renders every Nth
    pose frame (reference ``viz_downsample``).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    names = list(poses.keys())
    with_2d = keypoints_2d is not None or input_video_frames is not None
    n = len(names) + (1 if with_2d else 0)
    frames = min(p.shape[0] for p in poses.values())
    if limit > 0:
        frames = min(frames, limit)
    downsample = max(1, downsample)
    frame_ids = list(range(0, frames, downsample))

    def _bg(f):
        if input_video_frames is None:
            return None
        idx = f + input_video_skip
        if callable(input_video_frames):
            return input_video_frames(idx)
        if idx < len(input_video_frames):
            return input_video_frames[idx]
        return None

    fig = plt.figure(figsize=(size * n, size))
    axes3d, ax2d = [], None
    col = 1
    if with_2d:
        ax2d = fig.add_subplot(1, n, 1)
        ax2d.set_xlim(0, viewport[0])
        ax2d.set_ylim(viewport[1], 0)
        ax2d.set_xticks([])
        ax2d.set_yticks([])
        col = 2
    for i, name in enumerate(names):
        ax = _new_3d_axis(fig, col + i, 1, n, azim=azim)
        ax.set_title(name)
        axes3d.append(ax)

    def update(f):
        for ax in axes3d:
            for line in list(ax.lines):
                line.remove()
            for coll in list(ax.collections):
                coll.remove()
        if ax2d is not None:
            for line in list(ax2d.lines):
                line.remove()
            for coll in list(ax2d.collections):
                coll.remove()
            for im in list(ax2d.images):
                im.remove()
            bg = _bg(f)
            if bg is not None:
                ax2d.imshow(bg, extent=(0, viewport[0], viewport[1], 0),
                            aspect="auto", zorder=0)
            if keypoints_2d is not None:
                draw_skeleton_2d(ax2d, keypoints_2d[f])
        for ax, name in zip(axes3d, names):
            draw_skeleton(ax, poses[name][f])
        return []

    anim = FuncAnimation(fig, update, frames=frame_ids,
                         interval=1000.0 * downsample / fps)
    eff_fps = max(1, int(round(fps / downsample)))  # reference: fps /= downsample
    if output.endswith(".mp4"):
        try:
            anim.save(output, fps=eff_fps, bitrate=bitrate, writer="ffmpeg")
        except Exception:
            output = output[:-4] + ".gif"
            anim.save(output, fps=eff_fps, writer="pillow")
    elif output.endswith(".gif"):
        anim.save(output, fps=eff_fps, writer="pillow")
    else:
        raise ValueError(f"Unsupported output format: {output}")
    plt.close(fig)
    return output
