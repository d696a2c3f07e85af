"""Persistent pose-lifting service: weights on the device once, requests
lifted through flip-TTA multi-hypothesis DDIM.

Counterpart of ``pafuse_tpu/serve.py`` (``LiftingService`` with host noise,
all-hypothesis readback and one (P, T) operating point; requests serialise
through a lock).  The request path: normalise -> flipped twin -> window ->
DDIM (chunked by bucket) -> whole-body assembly -> stitch -> optional
camera-to-world.

A request's DDIM noise is drawn on the host from
``np.random.RandomState([seed, window, 0x5E21])``, exactly as the JAX
service draws it, so both packages see the same noise for the same request
and seed, whatever the bucket or chunk layout.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pafuse_tpu_torch import geometry
from pafuse_tpu_torch.data import windows as win
from pafuse_tpu_torch.utils.device import resolve_device, run_chunked

# S1-cam0 camera->world rotation of the reference's in-the-wild
# postprocessing.
_WORLD_ROT = np.array([0.14070565, -0.15007018, -0.7552408, 0.62232804],
                      dtype=np.float32)


def bucket_for(n_windows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n_windows, else the largest bucket (the request is
    then chunked)."""
    for b in sorted(buckets):
        if n_windows <= b:
            return b
    return max(buckets)


class LiftingService:
    """Warm, reusable 2D->3D lifting engine around a :class:`D3DP` model.

    model: ``diffusion.D3DP``; its weights move to ``device`` here, once.
    state_dict: optional weights for ``model.pose_estimator`` (from
        ``checkpoints``), loaded with ``strict=True`` before the move.
    buckets: window-batch sizes; a request runs in chunks of the smallest
        bucket that holds its windows, or of the largest bucket.
    max_frames: per-request frame cap.
    """

    def __init__(self, model, state_dict: Optional[Dict] = None,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 max_frames: int = 100_000, device="cuda"):
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or min(self.buckets) < 1:
            raise ValueError(f"invalid buckets {buckets!r}")
        self.max_frames = int(max_frames)
        if state_dict is not None:
            model.pose_estimator.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        cfg = model.cfg
        self.receptive_field = cfg.frames
        self.op_point = (cfg.num_proposals, cfg.sampling_timesteps)
        self._lock = threading.Lock()
        self.stats: Dict[str, float] = {"requests": 0, "frames": 0,
                                        "errors": 0, "started": time.time()}

    def warmup(self) -> float:
        """Run every bucket once (builds the kernels on first use); returns
        elapsed seconds."""
        t0 = time.time()
        rf, J = self.receptive_field, self.model.cfg.num_kps
        for b in self.buckets:
            x = np.zeros((b, rf, J, 2), np.float32)
            self._device_run(x, x, *self._request_noise(b, seed=0))
        return time.time() - t0

    def _request_noise(self, n_windows: int, seed: int):
        """Per-window DDIM noise keyed (seed, window index, 0x5E21) on the
        host: init (W, H, rf, J, 3) and steps (W, S, H, rf, J, 3)."""
        rf, J = self.receptive_field, self.model.cfg.num_kps
        H, S = self.op_point
        init = np.empty((n_windows, H, rf, J, 3), np.float32)
        stepn = np.empty((n_windows, S, H, rf, J, 3), np.float32)
        for i in range(n_windows):
            r = np.random.RandomState([np.uint32(seed), np.uint32(i),
                                       np.uint32(0x5E21)])
            init[i] = r.randn(H, rf, J, 3)
            stepn[i] = r.randn(S, H, rf, J, 3)
        return init, stepn

    def _sample(self, w2d, w2d_flip, init, stepn) -> torch.Tensor:
        """One chunk: (W, rf, J, 2) windows -> (W, H, rf, J, 3) on the
        device, at the final DDIM step, assembled to the whole body."""
        dev = self.device
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        H, S = self.op_point
        preds = self.model.eval_forward(
            as_dev(w2d), as_dev(w2d_flip), num_proposals=H,
            sampling_timesteps=S, init_noise=as_dev(init),
            # step noise is consumed as (S, W, H, rf, J, 3)
            step_noise=as_dev(stepn.transpose(1, 0, 2, 3, 4, 5)))
        return geometry.wb_pose_from_parts(preds[:, -1])

    def _device_run(self, w2d, w2d_flip, init, stepn) -> np.ndarray:
        """(W, rf, J, 2) windows -> (W, H, rf, J, 3) on the host; the copy to
        the host waits for the device."""
        chunk = bucket_for(w2d.shape[0], self.buckets)
        return run_chunked(self._sample, (w2d, w2d_flip, init, stepn), chunk)

    def lift(self, keypoints: np.ndarray, width: Optional[int] = None,
             height: Optional[int] = None, seed: int = 0,
             world: bool = False,
             all_hypotheses: bool = False) -> Dict[str, object]:
        """Lift a 2D keypoint sequence to 3D.

        keypoints: (F, num_kps, 2); pixel coordinates when width/height are
            given, else already normalised to [-1, 1].
        seed: DDIM noise seed; the same (request, seed) gives the same
            result.
        world: apply the in-the-wild camera->world rotation and floor
            rebase.
        all_hypotheses: return all H hypotheses instead of their mean.

        Returns ``poses`` (F, J, 3), or (H, F, J, 3) with ``all_hypotheses``,
        at the final DDIM step, plus timing metadata."""
        keypoints = np.asarray(keypoints, np.float32)
        if keypoints.ndim != 3 or keypoints.shape[-1] != 2:
            raise ValueError(
                f"keypoints must be (frames, joints, 2); got {keypoints.shape}")
        if keypoints.shape[0] < 1:
            raise ValueError("keypoints must contain at least one frame")
        if keypoints.shape[1] != self.model.cfg.num_kps:
            raise ValueError(f"expected {self.model.cfg.num_kps} joints, "
                             f"got {keypoints.shape[1]}")
        if (width is None) != (height is None):
            raise ValueError("width and height must be given together")
        if keypoints.shape[0] > self.max_frames:
            raise ValueError(
                f"request has {keypoints.shape[0]} frames; the per-request "
                f"limit is {self.max_frames} (max_frames)")

        t0 = time.time()
        with self._lock:
            try:
                if width is not None:
                    keypoints = np.asarray(geometry.normalize_screen_coordinates(
                        keypoints, w=width, h=height), np.float32)
                flip = geometry.flip_pose_np(keypoints,
                                             self.model.flip_permutation)
                rf = self.receptive_field
                w2d, _ = win.eval_data_prepare(rf, keypoints)
                w2d_flip, _ = win.eval_data_prepare(rf, flip)
                init, stepn = self._request_noise(w2d.shape[0], int(seed))
                preds = self._device_run(w2d, w2d_flip, init, stepn)
                # (W, H, rf, J, 3) -> (H, W, rf, J, 3) -> (H, F, J, 3)
                final = win.stitch_windows(preds.transpose(1, 0, 2, 3, 4),
                                           keypoints.shape[0], rf)
                if world:
                    final = geometry.camera_to_world(
                        torch.from_numpy(final), _WORLD_ROT, 0.0).numpy()
                    final[..., 2] -= final[..., 2].min()
                if not all_hypotheses:
                    final = final.mean(axis=0)
            except Exception:
                self.stats["errors"] += 1
                raise
            dt = time.time() - t0
            self.stats["requests"] += 1
            self.stats["frames"] += int(keypoints.shape[0])
        return {
            "poses": final,
            "num_frames": int(keypoints.shape[0]),
            "num_hypotheses": int(self.op_point[0]),
            "latency_ms": round(dt * 1000.0, 2),
        }

    def health(self) -> Dict[str, object]:
        """The service's stats, read without the request lock (as the JAX
        service reads them), so a health check does not wait for a running
        request."""
        s = dict(self.stats)
        s["uptime_seconds"] = round(time.time() - s.pop("started"), 1)
        s["status"] = "ok"
        s["device"] = str(self.device)
        s["receptive_field"] = self.receptive_field
        s["buckets"] = list(self.buckets)
        s["num_proposals"] = int(self.op_point[0])
        s["sampling_timesteps"] = int(self.op_point[1])
        return s
