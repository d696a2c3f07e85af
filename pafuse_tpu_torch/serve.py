"""Persistent pose-lifting service: weights on the device once, requests
lifted through flip-TTA multi-hypothesis DDIM, over HTTP or in-process.

Counterpart of ``pafuse_tpu/serve.py``, on one CUDA device or on several:

* **Resident weights.** The model's weights move to the device once, at
  construction; every request and every op-point tier shares them.
* **Buckets without padding.** There is no executable per shape, so nothing
  is padded: a request runs in chunks of the smallest bucket that holds its
  windows, or of the largest bucket, and the largest bucket caps how many
  rows the dynamic batcher co-batches.
* **Dynamic batching.** One dispatch thread per tier owns that tier's
  launches; concurrent requests' window rows are coalesced into one sampler
  call (only rows already queued are drained: no added wait).  Batch i is
  read back after batch i+1 has been queued, and its readback waits for
  its own copy alone (``utils.device.to_host``).  ``dynamic_batching=False``
  serialises whole requests through a lock instead.  Every launch goes to
  the current (default) stream of the device, whichever thread makes it,
  so no tensor crosses streams; a side stream would need ``record_stream``
  on every tensor that crosses it.
* **Noise.** ``noise_mode="host"`` draws each window's DDIM noise on the
  host from ``np.random.RandomState([seed, window, 0x5E21])``, exactly as
  the JAX service draws it; ``"device"`` sends only a uint32 seed per
  window and draws on the device from a ``torch.Generator`` seeded with it
  (a noise universe of its own).  Either way a window's noise depends only
  on (request seed, window index, salt), never on chunking or co-batching.
* **Readback.** ``readback="all"`` reads back every hypothesis;
  ``"mean"`` averages them on the device first (H-fold less readback;
  ``all_hypotheses`` requests are then rejected).
* **Op-point tiers.** ``op_points`` lists (P, T) tiers served over the same
  weights, the first the default; each tier has its own batcher, so tiers
  never co-batch.
* **Several cards.** With ``devices=[...]`` (``cli/serve.py`` passes every
  visible card at ``serve.shard=auto``) there is one replica of the model
  per device, the buckets are rounded up to a multiple of the device
  count (as the JAX service rounds them for its mesh), and the rows of
  each sampler call split evenly over the replicas, each slice queued on
  its own device's stream and read back into row order on the host.

The request path: normalise -> flipped twin -> window -> DDIM (chunked) ->
whole-body assembly -> stitch -> optional camera-to-world.
:class:`StreamingSession` lifts live frame streams causally, and
:func:`make_http_server` puts both behind a standard-library HTTP server
with Prometheus metrics.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pafuse_tpu_torch import geometry
from pafuse_tpu_torch.data import windows as win
from pafuse_tpu_torch.utils.device import (resolve_device, run_chunked,
                                           to_device, to_host)

# S1-cam0 camera->world rotation of the reference's in-the-wild
# postprocessing.
_WORLD_ROT = np.array([0.14070565, -0.15007018, -0.7552408, 0.62232804],
                      dtype=np.float32)

#: salt of a batch request's per-window noise; streams with per-frame noise
#: key by absolute frame index under STREAM_SALT, so the two never collide
BATCH_SALT = 0x5E21
STREAM_SALT = 0x51AE


def bucket_for(n_windows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n_windows, else the largest bucket (the request is
    then chunked)."""
    for b in sorted(buckets):
        if n_windows <= b:
            return b
    return max(buckets)


def _parse_op_point(pt) -> Tuple[int, int]:
    """``(P, T)`` from a pair or a ``"PxT"`` string."""
    P_, T_ = pt.lower().split("x") if isinstance(pt, str) else pt
    return int(P_), int(T_)


def _check_all_hypotheses(all_hypotheses: bool, readback: str) -> None:
    if all_hypotheses and readback == "mean":
        raise ValueError(
            "all_hypotheses requires a readback='all' service; this "
            "service aggregates hypotheses on device (readback='mean')")


class _DynamicBatcher:
    """Cross-request window batching for one op-point tier.

    Concurrent ``lift()`` calls enqueue their window rows (2D windows and
    the request's own noise or seeds); one dispatch thread drains whatever
    is already queued, never waiting for more, concatenates the rows into
    one sampler call and scatters the results back to each request's
    future.  Rows are independent through the whole sampler, so co-batching
    changes only the row count of each launch.
    """

    def __init__(self, service: "LiftingService", autostart: bool = True,
                 op_point=None):
        self._service = service
        self._op_point = op_point
        self._q: "queue.Queue" = queue.Queue()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pafuse-serve-batcher")
        if autostart:
            self._thread.start()

    def submit(self, arrays) -> Future:
        """arrays: (w2d, w2d_flip, *noise), W rows each.  Returns a Future
        resolving to the final-step predictions: (W, H, rf, J, 3), or
        (W, rf, J, 3) on a readback='mean' service."""
        if self._stopped:
            raise RuntimeError("batcher stopped")
        f: Future = Future()
        self._q.put((arrays, f))
        return f

    @staticmethod
    def _scatter(out: np.ndarray, batch) -> None:
        ofs = 0
        for arrs, f in batch:
            w = arrs[0].shape[0]
            f.set_result(np.array(out[ofs:ofs + w]))
            ofs += w

    def _resolve(self, pending) -> None:
        """Read back a dispatched batch and scatter its rows."""
        svc = self._service
        handle, batch, t_disp = pending
        try:
            out = handle.numpy()        # waits for this batch's copy alone
            now = time.time()
            with svc._stats_lock:
                svc.stats["batch_calls"] += 1
                svc.stats["batched_requests"] += len(batch)
                # device occupancy under pipelining: only the interval since
                # the later of this batch's dispatch and the previous
                # completion across all tiers (the watermark lives on the
                # service), so concurrent tiers never count one interval
                # twice
                svc.stats["busy_seconds"] += max(
                    0.0, now - max(t_disp, svc._last_done))
                svc._last_done = max(svc._last_done, now)
            self._scatter(out, batch)
        except Exception as e:
            for _, f in batch:
                if not f.done():
                    f.set_exception(e)

    def _loop(self):
        svc = self._service
        max_rows = max(svc.buckets)
        # one-deep pipeline: batch i is read back after batch i+1 has been
        # drained, concatenated and queued, so the device never idles
        # between co-batched calls
        pending = None
        while True:
            if pending is None:
                item = self._q.get()
            else:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    # nothing queued: drain the in-flight batch, then block
                    self._resolve(pending)
                    pending = None
                    continue
            if item is None:
                if pending is not None:
                    self._resolve(pending)
                # fail anything that raced in behind the stop sentinel
                # rather than leaving its caller blocked forever
                while True:
                    try:
                        late = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if late is not None:
                        late[1].set_exception(RuntimeError("batcher stopped"))
            batch = [item]
            rows = item[0][0].shape[0]
            # drain only what is already queued: no artificial batching delay
            while rows < max_rows:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)
                    break
                batch.append(nxt)
                rows += nxt[0][0].shape[0]
            try:
                if len(batch) == 1:
                    arrays = batch[0][0]
                else:
                    arrays = tuple(
                        np.concatenate([b[0][i] for b in batch])
                        for i in range(len(batch[0][0])))
                if arrays[0].shape[0] > max_rows:
                    # oversized request: the chunked path (its own one-deep
                    # pipeline); resolve the in-flight batch first
                    if pending is not None:
                        self._resolve(pending)
                        pending = None
                    out = svc._device_run(*arrays, op_point=self._op_point)
                    with svc._stats_lock:
                        svc.stats["batch_calls"] += 1
                        svc.stats["batched_requests"] += len(batch)
                    self._scatter(out, batch)
                else:
                    t_disp = time.time()
                    handle = svc._device_dispatch(*arrays,
                                                  op_point=self._op_point)
                    if pending is not None:
                        self._resolve(pending)
                    pending = (handle, batch, t_disp)
            except Exception as e:  # propagate to every waiting request
                for _, f in batch:
                    if not f.done():
                        f.set_exception(e)

    def stop(self):
        self._stopped = True
        self._q.put(None)


class LiftingService:
    """Warm, reusable 2D->3D lifting engine around a :class:`D3DP` model.

    model: ``diffusion.D3DP``; its weights move to ``device`` here, once.
    state_dict: optional weights for ``model.pose_estimator`` (from
        ``checkpoints``), loaded with ``strict=True`` before the move.
    buckets: window-batch sizes; a request runs in chunks of the smallest
        bucket that holds its windows, or of the largest bucket, and the
        largest bucket caps the rows of one co-batched call.
    warmup: run :meth:`warmup` at construction.
    dynamic_batching: concurrent requests of one tier share sampler calls
        through a dispatch thread; ``False`` serialises whole requests
        through a lock.
    max_frames: per-request frame cap (noise and result buffers grow with
        request length).
    noise_mode: ``"host"`` draws each window's noise on the host as the JAX
        service does; ``"device"`` ships one uint32 seed per window and
        draws on the device (another noise universe, the same rule: a
        window's noise depends only on its seed, window index and salt).
    readback: ``"all"`` reads back every hypothesis; ``"mean"`` averages
        them on the device (stitching takes each frame from one window, so
        the result equals the host-side mean) and rejects
        ``all_hypotheses``.
    op_points: (P, T) tiers, ``[(10, 5), (1, 1)]`` or ``["10x5", "1x1"]``,
        deduplicated, the first the default; requests pick another with
        ``op_point=``.  Default: the model config's (num_proposals,
        sampling_timesteps).
    device: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    devices: several devices (``["cuda:0", "cuda:1"]``; a device may repeat):
        one replica per entry, the rows of each sampler call split evenly
        over them; overrides ``device`` (the first is the service's).
    """

    def __init__(self, model, state_dict: Optional[Dict] = None,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 warmup: bool = False, dynamic_batching: bool = True,
                 max_frames: int = 100_000, noise_mode: str = "host",
                 readback: str = "all", op_points: Optional[Sequence] = None,
                 device="cuda", devices: Optional[Sequence] = None):
        if noise_mode not in ("host", "device"):
            raise ValueError(f"noise_mode must be 'host' or 'device'; "
                             f"got {noise_mode!r}")
        if readback not in ("all", "mean"):
            raise ValueError(f"readback must be 'all' or 'mean'; "
                             f"got {readback!r}")
        if not buckets or min(int(b) for b in buckets) < 1:
            raise ValueError(f"invalid buckets {buckets!r}")
        self.devices = tuple(resolve_device(d)
                             for d in (devices if devices else [device]))
        n = len(self.devices)
        # even row shards per replica
        self.buckets = tuple(sorted(set(-(-int(b) // n) * n
                                        for b in buckets)))
        self.noise_mode = noise_mode
        self.readback = readback
        self.max_frames = int(max_frames)
        self.device = self.devices[0]
        if state_dict is not None:
            model.pose_estimator.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.replicas = (self.model,) + tuple(
            copy.deepcopy(self.model).to(d) for d in self.devices[1:])
        cfg = model.cfg
        self.receptive_field = cfg.frames

        pts = list(op_points) if op_points else [
            (cfg.num_proposals, cfg.sampling_timesteps)]
        norm = []
        for pt in pts:
            P_, T_ = _parse_op_point(pt)
            if P_ < 1 or T_ < 1:
                raise ValueError(f"op-point P/T must be >= 1; got {pt!r}")
            if (P_, T_) not in norm:
                norm.append((P_, T_))
        self.op_points = tuple(norm)
        self.default_op_point = self.op_points[0]

        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # completion watermark of the busy_seconds interval union (shared
        # by the tier batchers and _device_run; under _stats_lock)
        self._last_done = 0.0
        self.stats: Dict[str, float] = {
            "requests": 0, "frames": 0, "errors": 0,
            "batch_calls": 0, "batched_requests": 0,
            "stream_sessions": 0, "stream_frames": 0,
            "busy_seconds": 0.0, "started": time.time(),
        }
        self._batchers = ({pt: _DynamicBatcher(self, op_point=pt)
                           for pt in self.op_points}
                          if dynamic_batching else None)
        if warmup:
            self.warmup()

    def close(self):
        """Stop every tier's dispatch thread (idempotent)."""
        if self._batchers is not None:
            for b in self._batchers.values():
                b.stop()

    def _resolve_op_point(self, op_point) -> Tuple[int, int]:
        """None -> the default tier; a "PxT" string or (P, T) pair
        otherwise."""
        if op_point is None:
            return self.default_op_point
        pt = _parse_op_point(op_point)
        if pt not in self.op_points:
            avail = ", ".join(f"{p}x{t}" for p, t in self.op_points)
            raise ValueError(f"op_point {pt[0]}x{pt[1]} not served; "
                             f"available: {avail}")
        return pt

    # -- startup -------------------------------------------------------------
    def warmup(self) -> float:
        """Run every (bucket x op point) once, one after another (there is
        nothing to compile; the first call builds the kernels); returns
        elapsed seconds.  Startup runs do not count as busy time."""
        t0 = time.time()
        rf, J = self.receptive_field, self.model.cfg.num_kps
        for pt in self.op_points:
            for b in self.buckets:
                x = np.zeros((b, rf, J, 2), np.float32)
                self._device_run(*self._request_arrays(x, x, seed=0,
                                                       op_point=pt),
                                 op_point=pt, count_busy=False)
        return time.time() - t0

    # -- request path --------------------------------------------------------
    def _request_noise(self, n_windows: int, seed: int,
                       salt: int = BATCH_SALT, base: int = 0, op_point=None):
        """Per-window DDIM noise keyed (seed, base + window index, salt) on
        the host: init (W, H, rf, J, 3) and steps (W, S, H, rf, J, 3), bit
        for bit the JAX service's draws."""
        rf, J = self.receptive_field, self.model.cfg.num_kps
        H, S = op_point if op_point is not None else self.default_op_point
        init = np.empty((n_windows, H, rf, J, 3), np.float32)
        stepn = np.empty((n_windows, S, H, rf, J, 3), np.float32)
        for i in range(n_windows):
            r = np.random.RandomState([np.uint32(seed), np.uint32(base + i),
                                       np.uint32(salt)])
            init[i] = r.randn(H, rf, J, 3)
            stepn[i] = r.randn(S, H, rf, J, 3)
        return init, stepn

    @staticmethod
    def _window_seeds(n_windows: int, seed: int, salt: int = BATCH_SALT,
                      base: int = 0) -> np.ndarray:
        """Per-window uint32 device-noise seeds, keyed like
        ``_request_noise``: (request seed, absolute window index, salt)."""
        idx = np.arange(base, base + n_windows, dtype=np.uint64)
        s = (np.uint64(np.uint32(seed)) * np.uint64(0x9E3779B1)
             ^ idx * np.uint64(0x85EBCA6B) ^ np.uint64(np.uint32(salt)))
        return (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def _request_arrays(self, w2d: np.ndarray, w2d_flip: np.ndarray,
                        seed: int, op_point=None):
        """The per-window arrays of a request: the 2D windows and either
        the request's host noise (init, steps) or, in device mode, one
        uint32 seed per window."""
        if self.noise_mode == "device":
            return w2d, w2d_flip, self._window_seeds(w2d.shape[0], seed)
        return (w2d, w2d_flip) + self._request_noise(w2d.shape[0], seed,
                                                     op_point=op_point)

    def _device_noise(self, seeds: np.ndarray, op_point, device=None):
        """Noise drawn on the device (the service's, or ``device``), one
        generator per window seeded with its seed: init (W, H, rf, J, 3),
        then steps, stacked (S, W, H, rf, J, 3) as the sampler takes
        them."""
        rf, J = self.receptive_field, self.model.cfg.num_kps
        H, S = op_point
        dev = self.device if device is None else device
        init, steps = [], []
        for s in seeds.tolist():
            g = torch.Generator(device=dev)
            g.manual_seed(int(s))
            init.append(torch.randn((H, rf, J, 3), generator=g, device=dev))
            steps.append(torch.randn((S, H, rf, J, 3), generator=g,
                                     device=dev))
        return torch.stack(init), torch.stack(steps, dim=1)

    def _call_chunk(self, *arrays, op_point=None):
        """One sampler call on a chunk of rows (the 2D windows, their flipped
        twins and the noise or seeds), queued on the device(s): (W, H, rf,
        J, 3) at the final DDIM step, assembled to the whole body, or its
        hypothesis mean (W, rf, J, 3) with readback='mean'.  With several
        replicas the rows split evenly over them and the result is the list
        of their slices, in row order (``to_host`` reads it back as one
        array)."""
        if len(self.replicas) == 1:
            return self._replica_call(0, *arrays, op_point=op_point)
        n, W = len(self.replicas), arrays[0].shape[0]
        # as even as rows allow, the first W % n replicas one row more
        bounds = np.cumsum([0] + [W // n + (i < W % n) for i in range(n)])
        return [self._replica_call(i, *(a[lo:hi] for a in arrays),
                                   op_point=op_point)
                for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))
                if hi > lo]

    def _replica_call(self, i: int, w2d_c, w2d_flip_c, *noise_c,
                      op_point=None) -> torch.Tensor:
        """The sampler call of :meth:`_call_chunk` on replica ``i``, queued
        on its device's current stream."""
        H, S = op_point if op_point is not None else self.default_op_point
        dev, model = self.devices[i], self.replicas[i]
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with torch.no_grad(), on_card:
            if self.noise_mode == "device":
                init, stepn = self._device_noise(noise_c[0], (H, S), dev)
            else:
                init = to_device(noise_c[0], dev)
                # (W, S, ...) -> the sampler's (S, W, ...), on the device
                stepn = to_device(noise_c[1], dev).transpose(0, 1)
            preds = model.eval_forward(
                to_device(w2d_c, dev), to_device(w2d_flip_c, dev),
                num_proposals=H, sampling_timesteps=S, init_noise=init,
                step_noise=stepn)
            # only the final DDIM step is served: slice before the readback
            out = geometry.wb_pose_from_parts(preds[:, -1])
            if self.readback == "mean":
                out = out.mean(dim=1)
        return out

    def _device_run(self, w2d, w2d_flip, *noise, op_point=None,
                    count_busy=True) -> np.ndarray:
        """Run window rows through the sampler in bucket-sized chunks with
        a one-deep readback (``run_chunked``); the result on the host.
        Called from a dispatch thread or under the service lock, so the busy
        time counted here is device occupancy."""
        def call(*chunk):
            return self._call_chunk(*chunk, op_point=op_point)

        t0 = time.time()
        out = run_chunked(call, (w2d, w2d_flip) + noise,
                          bucket_for(w2d.shape[0], self.buckets))
        if count_busy:
            now = time.time()
            with self._stats_lock:
                # interval union against the shared completion watermark
                # (see _DynamicBatcher._resolve)
                self.stats["busy_seconds"] += max(
                    0.0, now - max(t0, self._last_done))
                self._last_done = max(self._last_done, now)
        return out

    def _device_dispatch(self, w2d, w2d_flip, *noise, op_point=None):
        """Queue one sampler call on rows that fit the largest bucket and
        return the pending readback of exactly those rows (a handle whose
        ``numpy()`` waits for this call's copy alone)."""
        if w2d.shape[0] > max(self.buckets):
            raise ValueError(f"{w2d.shape[0]} rows exceed the largest bucket "
                             f"{max(self.buckets)}; use _device_run")
        return to_host(self._call_chunk(w2d, w2d_flip, *noise,
                                        op_point=op_point))

    def _dispatch(self, arrays, op_point=None) -> np.ndarray:
        """Route prepared rows to the device: through the tier's batcher
        (co-batching with concurrent requests of that tier) when batching
        is on, directly otherwise."""
        pt = op_point if op_point is not None else self.default_op_point
        if self._batchers is not None:
            return self._batchers[pt].submit(arrays).result()
        return self._device_run(*arrays, op_point=pt)

    def _run_windows(self, w2d: np.ndarray, w2d_flip: np.ndarray,
                     seed: int, op_point=None) -> np.ndarray:
        return self._dispatch(
            self._request_arrays(w2d, w2d_flip, seed, op_point=op_point),
            op_point=op_point)

    def lift(self, keypoints: np.ndarray, width: Optional[int] = None,
             height: Optional[int] = None, seed: int = 0,
             world: bool = False, all_hypotheses: bool = False,
             op_point=None) -> Dict[str, object]:
        """Lift a 2D keypoint sequence to 3D.

        keypoints: (F, num_kps, 2); pixel coordinates when width/height are
            given, else already normalised to [-1, 1].
        seed: DDIM noise seed; the same (request, seed) gives the same
            result (co-batching changes the row count of the library's
            GEMMs in the embedding and head, a rounding-level effect;
            ``dynamic_batching=False`` pins it to the request alone).
        world: apply the in-the-wild camera->world rotation and floor
            rebase.
        all_hypotheses: return all H hypotheses instead of their mean.
        op_point: the served (P, T) tier, ``(1, 1)`` or ``"1x1"``; None is
            the default tier.

        Returns ``poses`` (F, J, 3), or (H, F, J, 3) with ``all_hypotheses``,
        at the final DDIM step, plus timing metadata."""
        op_point = self._resolve_op_point(op_point)
        keypoints = np.asarray(keypoints, np.float32)
        if keypoints.ndim != 3 or keypoints.shape[-1] != 2:
            raise ValueError(f"keypoints must be (frames, joints, 2); got "
                             f"{keypoints.shape}")
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
        _check_all_hypotheses(all_hypotheses, self.readback)

        t0 = time.time()
        # with batching the dispatch threads own the launches, so host-side
        # preparation runs concurrently; without it whole requests
        # serialise through the lock
        serial = (self._lock if self._batchers is None
                  else contextlib.nullcontext())
        with serial:
            try:
                if width is not None:
                    keypoints = np.asarray(
                        geometry.normalize_screen_coordinates(
                            keypoints, w=width, h=height), np.float32)
                flip = geometry.flip_pose_np(keypoints,
                                             self.model.flip_permutation)
                rf = self.receptive_field
                w2d, _ = win.eval_data_prepare(rf, keypoints)
                w2d_flip, _ = win.eval_data_prepare(rf, flip)
                preds = self._run_windows(w2d, w2d_flip, seed=int(seed),
                                          op_point=op_point)
                if self.readback == "all":
                    # (W, H, rf, J, 3) -> (H, W, rf, J, 3)
                    preds = preds.transpose(1, 0, 2, 3, 4)
                # (H, F, J, 3), or (F, J, 3) with readback='mean'
                final = win.stitch_windows(preds, keypoints.shape[0], rf)
                if world:
                    final = geometry.camera_to_world(
                        torch.from_numpy(final), _WORLD_ROT, 0.0).numpy()
                    final[..., 2] -= final[..., 2].min()
                if not all_hypotheses and self.readback == "all":
                    final = final.mean(axis=0)
            except Exception:
                with self._stats_lock:
                    self.stats["errors"] += 1
                raise
            dt = time.time() - t0
            with self._stats_lock:
                self.stats["requests"] += 1
                self.stats["frames"] += int(keypoints.shape[0])
        return {
            "poses": final,
            "num_frames": int(keypoints.shape[0]),
            "num_hypotheses": int(op_point[0]),
            "latency_ms": round(dt * 1000.0, 2),
        }

    def health(self) -> Dict[str, object]:
        """The service's stats and settings, read without the request lock
        (a health check does not wait for a running request)."""
        with self._stats_lock:
            s = dict(self.stats)
        s["uptime_seconds"] = round(time.time() - s.pop("started"), 1)
        s["status"] = "ok"
        s["device"] = str(self.device)
        s["receptive_field"] = self.receptive_field
        s["buckets"] = list(self.buckets)
        s["num_proposals"] = int(self.default_op_point[0])
        s["sampling_timesteps"] = int(self.default_op_point[1])
        s["op_points"] = [f"{p}x{t}" for p, t in self.op_points]
        s["mesh_devices"] = len(self.devices)
        s["dynamic_batching"] = self._batchers is not None
        s["noise_mode"] = self.noise_mode
        s["readback"] = self.readback
        return s


class StreamingSession:
    """Causal real-time lifting: push 2D frames as they arrive, receive each
    frame's 3D pose with single-window latency.

    Each pushed frame runs one sampler row over the *trailing* ``rf``
    frames (replicate-padded at stream start) and emits the pose at window
    position ``rf - 1 - delay``: ``delay=0`` is fully causal, ``delay=k``
    gives the frame ``k`` steps back ``k`` frames of future context.

    Noise: by default every frame reuses the request seed's window-0 draw
    (device mode: its seed), so the sampler is a fixed function of the
    window and outputs do not jitter, and a full-buffer emit equals
    ``lift()``'s last window.  ``per_frame_noise=True`` keys each frame's
    draw by its absolute index under ``STREAM_SALT`` instead.

    Concurrent sessions of one tier co-batch through that tier's batcher;
    pushing F frames at once dispatches all F trailing windows as one
    batch.  A lock per session guards its history.
    """

    def __init__(self, service: LiftingService, seed: int = 0,
                 width: Optional[int] = None, height: Optional[int] = None,
                 delay: int = 0, world: bool = False,
                 all_hypotheses: bool = False, per_frame_noise: bool = False,
                 op_point=None):
        rf = service.receptive_field
        if not 0 <= int(delay) < rf:
            raise ValueError(
                f"delay must be in [0, receptive_field-1={rf - 1}]; "
                f"got {delay}")
        if (width is None) != (height is None):
            raise ValueError("width and height must be given together")
        _check_all_hypotheses(all_hypotheses, service.readback)
        self.service = service
        self.op_point = service._resolve_op_point(op_point)
        self.seed = int(seed)
        self.width, self.height = width, height
        self.delay = int(delay)
        self.world = bool(world)
        self.all_hypotheses = bool(all_hypotheses)
        self.per_frame_noise = bool(per_frame_noise)
        self._hist: list = []        # last rf normalised frames
        self._flip_hist: list = []
        self._t = -1                 # index of the newest pushed frame
        self._floor: Optional[float] = None   # running min z (world rebase)
        self._lock = threading.Lock()
        if per_frame_noise:
            self._noise1 = None
        elif service.noise_mode == "device":
            self._noise1 = service._window_seeds(1, self.seed)
        else:
            self._noise1 = service._request_noise(1, self.seed,
                                                  op_point=self.op_point)
        with service._stats_lock:
            service.stats["stream_sessions"] += 1

    @property
    def frames_pushed(self) -> int:
        return self._t + 1

    def _window(self, buf: list) -> np.ndarray:
        """Trailing window, replicate-padded at the front while the stream
        is shorter than rf."""
        rf = self.service.receptive_field
        if len(buf) >= rf:
            return np.stack(buf[-rf:])
        return np.stack([buf[0]] * (rf - len(buf)) + buf)

    def _noise(self, F: int):
        svc = self.service
        if self.per_frame_noise:
            base = self._t - F + 1
            if svc.noise_mode == "device":
                return (svc._window_seeds(F, self.seed, salt=STREAM_SALT,
                                          base=base),)
            return svc._request_noise(F, self.seed, salt=STREAM_SALT,
                                      base=base, op_point=self.op_point)
        if svc.noise_mode == "device":
            return (np.repeat(self._noise1, F, axis=0),)
        return tuple(np.repeat(a, F, axis=0) for a in self._noise1)

    def push(self, frames: np.ndarray) -> Dict[str, object]:
        """Push one frame (J, 2) or several (F, J, 2); returns the emitted
        poses, (F, J, 3) or (F, H, J, 3) with ``all_hypotheses``, and
        ``frame_indices``: the absolute frame each pose belongs to
        (``max(0, t - delay)`` for pushed frame t)."""
        svc = self.service
        J = svc.model.cfg.num_kps
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        if frames.ndim != 3 or frames.shape[-1] != 2 or frames.shape[0] < 1:
            raise ValueError(
                f"frames must be (J, 2) or (F, J, 2); got {frames.shape}")
        if frames.shape[1] != J:
            raise ValueError(f"expected {J} joints, got {frames.shape[1]}")

        t0 = time.time()
        with self._lock:
            try:
                if self.width is not None:
                    frames = np.asarray(geometry.normalize_screen_coordinates(
                        frames, w=self.width, h=self.height), np.float32)
                flips = geometry.flip_pose_np(frames,
                                              svc.model.flip_permutation)
                rf = svc.receptive_field
                F = frames.shape[0]
                w2d, w2d_flip, idx = [], [], []
                for k in range(F):
                    self._hist.append(frames[k])
                    self._flip_hist.append(flips[k])
                    if len(self._hist) > rf:
                        self._hist.pop(0)
                        self._flip_hist.pop(0)
                    self._t += 1
                    w2d.append(self._window(self._hist))
                    w2d_flip.append(self._window(self._flip_hist))
                    idx.append(max(0, self._t - self.delay))
                out = svc._dispatch((np.stack(w2d), np.stack(w2d_flip))
                                    + self._noise(F), op_point=self.op_point)
                pos = rf - 1 - self.delay
                # (F, H, J, 3), or (F, J, 3) with readback='mean'
                poses = (out[:, pos] if svc.readback == "mean"
                         else out[:, :, pos])
                if self.world:
                    poses = geometry.camera_to_world(
                        torch.from_numpy(np.ascontiguousarray(poses)),
                        _WORLD_ROT, 0.0).numpy()
                    # causal floor: rebase against the running minimum (a
                    # stream cannot know the global one)
                    zmin = float(poses[..., 2].min())
                    self._floor = (zmin if self._floor is None
                                   else min(self._floor, zmin))
                    poses[..., 2] -= self._floor
                if not self.all_hypotheses and svc.readback == "all":
                    poses = poses.mean(axis=1)
            except Exception:
                with svc._stats_lock:
                    svc.stats["errors"] += 1
                raise
            with svc._stats_lock:
                svc.stats["stream_frames"] += F
        return {
            "poses": poses,
            "frame_indices": idx,
            "num_hypotheses": int(self.op_point[0]),
            "latency_ms": round((time.time() - t0) * 1000.0, 2),
        }


# ---------------------------------------------------------------------------
# HTTP surface (standard library): POST /lift, POST/DELETE /stream*,
# GET /healthz and /metrics
# ---------------------------------------------------------------------------

#: health keys exported as Prometheus counters (the other numbers are gauges)
COUNTERS = ("requests", "frames", "errors", "batch_calls", "batched_requests",
            "stream_sessions", "stream_frames")


def make_http_server(service: LiftingService, host: str = "127.0.0.1",
                     port: int = 8012, stream_idle_timeout: float = 600.0):
    """Threading HTTP server over the service; ``port=0`` binds a free port
    (``server.server_address[1]``).

      POST   /lift            {keypoints, width, height, seed, world,
                               all_hypotheses, op_point} -> {poses, ...}
      POST   /stream          {seed, width, height, delay, world,
                               all_hypotheses, per_frame_noise, op_point}
                              -> {session}
      POST   /stream/<id>     {keypoints: (J,2) | (F,J,2)} -> {poses, ...}
      DELETE /stream/<id>     close the session
      GET    /healthz, /health, /metrics (Prometheus text)

    Sessions idle longer than ``stream_idle_timeout`` seconds are evicted
    when a session is created.  Malformed requests get 400, unknown paths
    and sessions 404, model errors 500; the server stays up.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    sessions: Dict[str, list] = {}      # id -> [StreamingSession, last_used]
    sessions_lock = threading.Lock()
    session_ids = itertools.count()

    def _evict_idle():
        now = time.time()
        with sessions_lock:
            for sid in [s for s, (_, used) in sessions.items()
                        if now - used > stream_idle_timeout]:
                del sessions[sid]

    def _get_session(sid: str) -> Optional[StreamingSession]:
        with sessions_lock:
            entry = sessions.get(sid)
            if entry is None:
                return None
            entry[1] = time.time()
            return entry[0]

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload,
                   content_type: str = "application/json"):
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._reply(200, service.health())
            elif self.path == "/metrics":
                lines = []
                for k, v in service.health().items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    kind = "counter" if k in COUNTERS else "gauge"
                    lines.append(f"# TYPE pafuse_{k} {kind}")
                    lines.append(f"pafuse_{k} {v}")
                self._reply(200, ("\n".join(lines) + "\n").encode(),
                            content_type="text/plain; version=0.0.4")
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):
            try:
                if self.path == "/lift":
                    req = self._read_json()
                    out = service.lift(
                        np.asarray(req["keypoints"], np.float32),
                        width=req.get("width"), height=req.get("height"),
                        seed=int(req.get("seed", 0)),
                        world=bool(req.get("world", False)),
                        all_hypotheses=bool(req.get("all_hypotheses",
                                                    False)),
                        op_point=req.get("op_point"))
                elif self.path == "/stream":
                    req = self._read_json()
                    _evict_idle()
                    sess = StreamingSession(
                        service, seed=int(req.get("seed", 0)),
                        width=req.get("width"), height=req.get("height"),
                        delay=int(req.get("delay", 0)),
                        world=bool(req.get("world", False)),
                        all_hypotheses=bool(req.get("all_hypotheses",
                                                    False)),
                        per_frame_noise=bool(req.get("per_frame_noise",
                                                     False)),
                        op_point=req.get("op_point"))
                    sid = f"s{next(session_ids)}"
                    with sessions_lock:
                        sessions[sid] = [sess, time.time()]
                    self._reply(200, {
                        "session": sid,
                        "receptive_field": service.receptive_field,
                        "delay": sess.delay})
                    return
                elif self.path.startswith("/stream/"):
                    sess = _get_session(self.path[len("/stream/"):])
                    if sess is None:
                        self._reply(404, {"error": "unknown or expired "
                                                   "stream session"})
                        return
                    req = self._read_json()
                    out = sess.push(np.asarray(req["keypoints"], np.float32))
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # keep the server up on model errors
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            poses = out.pop("poses")
            out["shape"] = list(poses.shape)
            out["poses"] = poses.tolist()
            self._reply(200, out)

        def do_DELETE(self):
            if self.path.startswith("/stream/"):
                sid = self.path[len("/stream/"):]
                with sessions_lock:
                    sess = sessions.pop(sid, (None,))[0]
                if sess is None:
                    self._reply(404, {"error": "unknown or expired "
                                               "stream session"})
                else:
                    self._reply(200, {"closed": True,
                                      "frames": sess.frames_pushed})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def log_message(self, fmt, *args):  # through print, not stderr
            print(f"[serve] {self.address_string()} {fmt % args}")

    return ThreadingHTTPServer((host, port), Handler)
