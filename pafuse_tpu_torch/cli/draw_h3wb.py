"""Qualitative H3WB rendering: ground truth against the J-Agg-selected
prediction per frame and DDIM step, and against each hypothesis.

    python -m pafuse_tpu_torch.cli.draw_h3wb viz.viz_subject=S8 \\
        viz.viz_action=Sitting viz.viz_camera=0 general.evaluate=best.npz

Counterpart of ``pafuse_tpu/cli/draw_h3wb.py``: one (subject, action,
camera) sequence, all its windows sampled in one flip-TTA DDIM call; the
ground-truth trajectory re-added, the windows stitched to the timeline, the
hypothesis of each joint picked by its 2D reprojection error (J-Agg), all
in world coordinates.  It writes ``viz.viz_export`` (the stitched
hypotheses) when set and renders into ``plot/{subject}_{action}_{camera}/``
(``select_f{f}_t{s}.png`` and ``hyp_f{f}_t{s}.png``).  The model is the
H3WB one of ``cli.main_h3wb.build_model`` on ``gpu.device`` (CUDA by
default).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from pafuse_tpu_torch import config as cfg_mod


def draw_poses(args, model, dataset, keypoints, subject: str, action: str,
               cam_idx: int, generator=None, noise_table=None):
    """The sequence's poses for rendering: {"stitched": (S, H, T, J, 3)
    hypotheses with the trajectory, camera space; "selected": (S, T, J, 3)
    the J-Agg pick; "hyp_world", "sel_world", "gt_world": the same and the
    ground truth in world coordinates}.  T is the sequence's length, cut
    to ``viz.viz_limit`` when that is positive.

    ``noise_table`` = (init, step) of shapes (windows, H, F, J, 3) and
    (windows, S, H, F, J, 3) injects the DDIM noise; otherwise it is drawn
    from ``generator`` (a fresh one seeded 0 on the model's device when
    omitted)."""
    import torch
    from pafuse_tpu_torch import geometry
    from pafuse_tpu_torch.data import windows as win
    from pafuse_tpu_torch.utils.device import to_device

    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cam = dataset.cameras()[subject][cam_idx]
    seq_2d = keypoints[subject][action][cam_idx]
    seq_3d = dataset[subject][action]["positions_3d"][cam_idx]
    rf = args.model.number_of_frames
    total = seq_2d.shape[0]
    if args.viz.viz_limit and args.viz.viz_limit > 0:
        total = min(total, int(args.viz.viz_limit))
        seq_2d, seq_3d = seq_2d[:total], seq_3d[:total]

    flip = geometry.flip_pose_np(seq_2d, model.flip_permutation)
    w2d, w3d = win.eval_data_prepare(rf, seq_2d, seq_3d)
    w2d_flip, _ = win.eval_data_prepare(rf, flip)
    kw = {}
    if noise_table is not None:
        init, step = (np.asarray(a, np.float32) for a in noise_table)
        kw = dict(init_noise=to_device(init, dev),
                  step_noise=to_device(np.moveaxis(step, 1, 0), dev))
    with torch.no_grad():
        preds = geometry.wb_pose_from_parts(model.eval_forward(
            to_device(w2d, dev), to_device(w2d_flip, dev),
            generator=generator, **kw)).cpu().numpy()  # (W, S, H, F, J, 3)
    preds_abs = preds + w3d[:, None, None, :, :1]
    stitched = win.stitch_windows(preds_abs.transpose(1, 2, 0, 3, 4, 5),
                                  total, rf)
    S, H, _, J, _ = stitched.shape

    # J-Agg: per joint, the hypothesis whose reprojection is nearest the 2D
    # input
    reproj = geometry.project_to_2d_np(
        stitched.reshape(S * H * total, J, 3),
        np.tile(cam["intrinsic"][None], (S * H * total, 1)))
    err2d = np.linalg.norm(reproj.reshape(S, H, total, J, 2)
                           - seq_2d[None, None], axis=-1)      # S, H, T, J
    sel = err2d.argmin(axis=1)                                  # S, T, J
    selected = np.take_along_axis(
        stitched, sel[:, None, :, :, None], axis=1)[:, 0]      # S, T, J, 3

    def world(x):
        return (geometry.qrot_np(cam["orientation"], x)
                + cam["translation"]).astype(np.float32)

    return {"stitched": stitched, "selected": selected,
            "hyp_world": world(stitched), "sel_world": world(selected),
            "gt_world": world(seq_3d)}


def main(argv=None):
    """Parse the overrides and run; returns the render directory."""
    args = cfg_mod.parse_cli(argv if argv is not None else sys.argv[1:])
    if args.viz.compare:
        # the reference's compare branch imports a PoseFormer module that
        # its repository does not have: refuse the knob instead of ignoring
        # it
        raise ValueError(
            "viz.compare is not supported: the reference's PoseFormer "
            "comparison path is broken/legacy (missing "
            "common/model_poseformer)")
    from pafuse_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.gpu.device)

    from pafuse_tpu_torch import checkpoints, viz
    from pafuse_tpu_torch.cli.main_h3wb import build_model
    from pafuse_tpu_torch.data import h3wb

    dataset = h3wb.load_dataset(
        args.data.data_dir, args.data.synthetic,
        actions_per_subject=int(args.data.synthetic_actions),
        frames_per_action=int(args.data.synthetic_frames))
    keypoints = h3wb.prepare_data(dataset)

    subject = args.viz.viz_subject
    cam_idx = int(args.viz.viz_camera)
    # a prefix names the action ('Sitting' -> 'Sitting 1')
    actions = [a for a in dataset[subject].keys()
               if a.startswith(args.viz.viz_action)]
    if not actions:
        raise SystemExit(f"No action matching {args.viz.viz_action!r} for "
                         f"{subject}")
    action = actions[0]
    print(f"Rendering {subject}/{action} camera {cam_idx}")

    model = build_model(args, device,
                        flip_permutation=dataset.flip_permutation)
    chk = args.general.evaluate or args.general.resume
    if chk:
        chk_path = os.path.join(args.general.checkpoint, chk)
        if not os.path.exists(chk_path):
            chk_path = chk
        print("Loading checkpoint", chk_path)
        checkpoints.load_weights(model, chk_path)

    poses = draw_poses(args, model, dataset, keypoints, subject, action,
                       cam_idx)
    if args.viz.viz_export:
        print("Exporting joint positions to", args.viz.viz_export)
        np.save(args.viz.viz_export, poses["stitched"])

    out_dir = os.path.join("plot",
                           f"{subject}_{action}_{cam_idx}".replace(" ", "_"))
    skip = max(1, int(args.viz.viz_downsample))
    show_gt = not bool(args.viz.viz_no_ground_truth)
    azim = float(dataset.cameras()[subject][cam_idx].get("azimuth", 70.0))
    viz.draw_3d_image_select(poses["hyp_world"], poses["sel_world"],
                             poses["gt_world"], out_dir, azim=azim,
                             frame_skip=skip, show_gt=show_gt)
    # ground truth against each hypothesis, every 5th frame
    viz.draw_3d_image_hypotheses(poses["hyp_world"], poses["gt_world"],
                                 out_dir, azim=azim, frame_skip=5 * skip,
                                 show_gt=show_gt)
    print(f"Wrote renders to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
