"""In-the-wild video lifting: OpenPifPaf whole-body 2D keypoints -> chunked
flip-TTA DDIM lifting -> world coordinates -> per-frame 3D renders.

    python -m pafuse_tpu_torch.cli.in_the_wild \\
        in_the_wild.video_path=yoga/004.mp4 \\
        general.evaluate=best_epoch.npz ft2d.num_proposals=5

Counterpart of ``pafuse_tpu/cli/in_the_wild.py``.  It reads
``{video_path}.openpifpaf.json`` beside the video (the video itself is
optional: without it the frame size is 1000 x 1002 at 25 fps) and writes
into ``outputs/{video name}/``: ``test_3d_{name}_output.npy`` (S, H,
frames, 134, 3) camera space, ``test_3d_output_{name}_postprocess.npy`` in
world coordinates with the floor at 0, ``frame{f}_t{s}.png`` renders and,
with ``viz.viz_output``, an animation.  The model is the H3WB one of
``cli.main_h3wb.build_model`` on ``gpu.device`` (CUDA by default).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from pafuse_tpu_torch import config as cfg_mod

#: the camera -> world rotation of Human3.6M S1's camera 0, the frame the
#: reference renders every in-the-wild video in
WORLD_ROTATION = np.array([0.14070565, -0.15007018, -0.7552408, 0.62232804],
                          dtype=np.float32)
#: frame size and rate assumed when the video file is absent
DEFAULT_VIDEO = (1000, 1002, 25)


def load_openpifpaf_keypoints(json_path: str, num_kps: int = 134) -> np.ndarray:
    """OpenPifPaf whole-body JSON lines -> (F, num_kps, 2) pixel keypoints:
    the first person's 133 keypoints at joints 1.., the synthetic root (the
    hip midpoint, joints 12 and 13) at joint 0; frames without a detection
    stay zero."""
    records = []
    with open(json_path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    keypoints = np.zeros((len(records), num_kps, 2), dtype=np.float32)
    for ind, rec in enumerate(records):
        preds = rec.get("predictions", [])
        if not preds:
            continue
        kp = preds[0]["keypoints"]
        keypoints[ind, 1:, 0] = kp[0::3]
        keypoints[ind, 1:, 1] = kp[1::3]
        keypoints[ind, 0] = 0.5 * (keypoints[ind, 12] + keypoints[ind, 13])
    return keypoints


def video_dims(video_path: str):
    """(width, height, fps) of a video file (OpenCV)."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    cap.release()
    return w, h, fps


def dump_frames(video_path: str, out_dir: str) -> int:
    """Write every frame of the video as ``{out_dir}/frame_{i}.jpg``;
    returns the frame count."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    count = 0
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        cv2.imwrite(os.path.join(out_dir, f"frame_{count}.jpg"), frame)
        count += 1
    cap.release()
    return count


def lift_video(args, keypoints_norm: np.ndarray, model, generator=None,
               noise_table=None) -> np.ndarray:
    """Lift a keypoint sequence of any length: window it (with its flipped
    twin), sample each chunk of ``model.batch_size // model.number_of_frames``
    windows with flip-TTA DDIM (no ground truth), assemble whole-body poses
    and stitch the windows back to the timeline.  Returns (S, H, frames, J,
    3), camera space.

    ``noise_table`` = (init, step) of shapes (windows, H, F, J, 3) and
    (windows, S, H, F, J, 3) injects the DDIM noise; otherwise it is drawn
    from ``generator`` (a fresh one seeded 0 on the model's device when
    omitted)."""
    import torch
    from pafuse_tpu_torch import geometry
    from pafuse_tpu_torch.data import windows as win
    from pafuse_tpu_torch.utils.device import run_chunked, to_device

    rf = args.model.number_of_frames
    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    flip = geometry.flip_pose_np(keypoints_norm, model.flip_permutation)
    w2d, _ = win.eval_data_prepare(rf, keypoints_norm)
    w2d_flip, _ = win.eval_data_prepare(rf, flip)
    arrays = (w2d, w2d_flip)
    if noise_table is not None:
        arrays += tuple(np.asarray(a, np.float32) for a in noise_table)

    @torch.no_grad()
    def call(x2d, x2d_flip, init=None, step=None):
        kw = {}
        if init is not None:
            kw = dict(init_noise=to_device(init, dev),
                      step_noise=to_device(np.moveaxis(step, 1, 0), dev))
        preds = model.eval_forward(to_device(x2d, dev), to_device(x2d_flip, dev),
                                   generator=generator, **kw)
        return geometry.wb_pose_from_parts(preds)

    bs = max(1, args.model.batch_size // rf)
    preds = run_chunked(call, arrays, bs)               # (W, S, H, F, J, 3)
    return win.stitch_windows(preds.transpose(1, 2, 0, 3, 4, 5),
                              keypoints_norm.shape[0], rf)


def lift_to_world(args, keypoints_px: np.ndarray, model, w, h,
                  generator=None, noise_table=None):
    """Pixel keypoints (F, J, 2) of a w x h video -> (prediction, world,
    keypoints_norm): the camera-space lifting of :func:`lift_video`, the
    same in world coordinates (the fixed camera rotation, the floor moved
    to z = 0) and the normalised keypoints."""
    from pafuse_tpu_torch import geometry
    keypoints = np.asarray(geometry.normalize_screen_coordinates(
        keypoints_px[..., :2], w=w, h=h), dtype=np.float32)
    prediction = lift_video(args, keypoints, model, generator, noise_table)
    world = geometry.qrot_np(WORLD_ROTATION, prediction).astype(np.float32)
    world[..., 2] -= world[..., 2].min()
    return prediction, world, keypoints


def main(argv=None):
    """Parse the overrides and run; returns the output directory."""
    args = cfg_mod.parse_cli(argv if argv is not None else sys.argv[1:])
    t0 = time.time()
    from pafuse_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.gpu.device)

    video_path = args.in_the_wild.video_path
    dir_name = os.path.dirname(video_path)
    basename = os.path.basename(video_path)
    video_name = basename[: basename.rfind(".")] if "." in basename else basename
    out_dir = f"outputs/{video_name}"
    os.makedirs(out_dir, exist_ok=True)

    from pafuse_tpu_torch import checkpoints, geometry
    from pafuse_tpu_torch.cli.main_h3wb import build_model

    model = build_model(args, device)
    chk = args.general.resume or args.general.evaluate
    if chk:
        chk_path = os.path.join(args.general.checkpoint, chk)
        if not os.path.exists(chk_path):
            chk_path = chk
        print("Loading checkpoint", chk_path)
        checkpoints.load_weights(model, chk_path)

    json_path = os.path.join(dir_name, f"{basename}.openpifpaf.json")
    keypoints = load_openpifpaf_keypoints(json_path, args.data.num_kps)
    print(f"Loaded {keypoints.shape[0]} frames of 2D keypoints")

    if os.path.exists(video_path):
        w, h, fps = video_dims(video_path)
        dump_frames(video_path, out_dir)
    else:
        w, h, fps = DEFAULT_VIDEO
    print(f"-------------- load data spends {time.time() - t0:.2f} seconds")

    prediction, world, keypoints = lift_to_world(args, keypoints, model, w, h)
    np.save(os.path.join(out_dir, f"test_3d_{video_name}_output.npy"),
            prediction, allow_pickle=True)
    np.save(os.path.join(out_dir,
                         f"test_3d_output_{video_name}_postprocess.npy"),
            world, allow_pickle=True)
    print(f"-------------- lifting spends {time.time() - t0:.2f} seconds")

    from pafuse_tpu_torch import viz
    # the final DDIM step's hypothesis mean, one render per frame
    viz.draw_3d_image(world[-1:], None, out_dir, azim=70.0,
                      max_frames=int(args.viz.viz_limit)
                      if args.viz.viz_limit and args.viz.viz_limit > 0 else None)

    if args.viz.viz_output:
        def frame_image(idx):
            path = os.path.join(out_dir, f"frame_{idx}.jpg")
            if os.path.exists(path):
                import matplotlib.image as mpimg
                return mpimg.imread(path)
            return None

        anim_out = os.path.join(out_dir, os.path.basename(args.viz.viz_output))
        written = viz.render_animation(
            {"reconstruction": world[-1].mean(axis=0)}, int(fps), anim_out,
            bitrate=int(args.viz.viz_bitrate), limit=int(args.viz.viz_limit),
            size=float(args.viz.viz_size),
            keypoints_2d=geometry.image_coordinates(keypoints.copy(), w=w, h=h),
            viewport=(w, h),
            input_video_frames=frame_image if os.path.exists(video_path) else None,
            input_video_skip=int(args.viz.viz_skip),
            downsample=int(args.viz.viz_downsample))
        print(f"Wrote animation to {written}")

    print(f"total spend {time.time() - t0:.2f} seconds; renders in {out_dir}")
    print("To make a video: ffmpeg -framerate 25 -i "
          f"{out_dir}/frame%d_t0.png -pix_fmt yuv420p {out_dir}/{video_name}.mp4")
    return out_dir


if __name__ == "__main__":
    main()
