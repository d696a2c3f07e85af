"""Multi-hypothesis evaluation with the reference's metric report.

Counterpart of ``pafuse_tpu/evaluate.py``.  One eval step takes a window
batch through flip-TTA DDIM sampling, whole-body assembly, the trajectory
re-add, the 2D reprojection and the four aggregation metrics (J_Best,
P_Best, P_Agg, J_Agg) with their part-based breakdowns, all on the model's
device; only the per-step metric vectors (and, for protocol #2, the poses)
are read back, one batch behind the dispatch.  The report text reproduces
the reference's ``h36m_test_log_H{P}_K{T}.txt`` vocabulary line for line.

Sharded evaluation (``world=`` with a process group, as
``build_eval_step(mesh=)`` shards the JAX step): the window batch is
rounded up to a multiple of the world size, each rank samples its rows of
it with its rows of the global batch's noise (:func:`sharded_eval_forward`),
and the predictions are gathered in rank order, so every rank computes
the batch's metrics from the same tensors, in the single-process order.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pafuse_tpu_torch import geometry, losses
from pafuse_tpu_torch.data import windows as win
from pafuse_tpu_torch.diffusion import D3DP, ddim_noise
from pafuse_tpu_torch.parallel.mesh import World, gather_rows
from pafuse_tpu_torch.utils.device import to_device, to_host

PART_NAMES = ("body", "face", "left_hand", "right_hand")


@dataclasses.dataclass
class EvalAccumulator:
    """Weighted float64 sums of per-step metric vectors."""
    sums: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    n: float = 0.0

    def add(self, metrics: Dict[str, np.ndarray], weight: float):
        for k, v in metrics.items():
            v = np.asarray(v, dtype=np.float64)
            self.sums[k] = self.sums.get(k, 0.0) + weight * v
        self.n += weight

    def means_mm(self) -> Dict[str, np.ndarray]:
        return {k: v / max(self.n, 1e-9) * 1000.0 for k, v in self.sums.items()}


def get_eval_step(model: D3DP, num_proposals: int, sampling_timesteps: int,
                  part_based: bool = True, with_p2_data: bool = False,
                  world: Optional[World] = None):
    """Memoised :func:`build_eval_step`, one step per (model, P, T, flags,
    world)."""
    cache = model.__dict__.setdefault("_eval_step_cache", {})
    key = (num_proposals, sampling_timesteps, part_based, with_p2_data, world)
    if key not in cache:
        cache[key] = build_eval_step(model, num_proposals, sampling_timesteps,
                                     part_based=part_based,
                                     with_p2_data=with_p2_data, world=world)
    return cache[key]


def sharded_eval_forward(model: D3DP, x2d, x2d_flip, world: World, *,
                         num_proposals: int, sampling_timesteps: int,
                         init_noise=None, step_noise=None, generator=None
                         ) -> torch.Tensor:
    """``model.eval_forward`` on B rows split over the ranks: the rows (and
    the noise, injected or drawn here for all B rows from ``generator`` as
    one process draws it, :func:`diffusion.ddim_noise`) are padded by their
    last row to a multiple of the world size, each rank samples its share,
    and the predictions (B, S, H, F, N, 3) are gathered in rank order.
    Without a process group it is ``model.eval_forward`` itself."""
    kw = dict(num_proposals=num_proposals,
              sampling_timesteps=sampling_timesteps)
    if not world.distributed:
        return model.eval_forward(x2d, x2d_flip, init_noise=init_noise,
                                  step_noise=step_noise, generator=generator,
                                  **kw)
    B = x2d.shape[0]
    if init_noise is None or step_noise is None:
        init_noise, step_noise = ddim_noise(
            model.cfg, x2d.shape, num_proposals, sampling_timesteps,
            x2d.device, generator, init_noise, step_noise)
    k = -(-B // world.size)
    idx = torch.arange(world.rank * k, (world.rank + 1) * k,
                       device=x2d.device).clamp_max(B - 1)

    def rows(t, dim=0):
        return t.index_select(dim, idx)

    preds = model.eval_forward(
        rows(x2d), None if x2d_flip is None else rows(x2d_flip),
        init_noise=rows(init_noise), step_noise=rows(step_noise, 1), **kw)
    return gather_rows(preds, world)[:B]


def build_eval_step(model: D3DP, num_proposals: int, sampling_timesteps: int,
                    part_based: bool = True, with_p2_data: bool = False,
                    world: Optional[World] = None):
    """Returns ``step(x2d, x2d_flip, x3d_parts, traj, cam, mask,
    init_noise=None, step_noise=None, generator=None) -> {name: tensor}``
    on one window batch (tensors on the model's device).

    ``x3d_parts`` is the part-centred ground truth, ``traj`` the ground-truth
    root positions, ``mask`` a per-window 0/1 validity vector: padded rows
    are zeroed and every metric rescaled by B / sum(mask), so each keeps
    the mean over the real rows.  ``init_noise`` (B, H, F, N, 3) and
    ``step_noise`` (S, B, H, F, N, 3) inject the DDIM noise; what is not
    injected is drawn from ``generator``.  With a ``world`` that has a
    process group the sampling is split over the ranks
    (:func:`sharded_eval_forward`) and every rank returns the batch's
    metrics."""

    def step(x2d, x2d_flip, x3d_parts, traj, cam, mask, init_noise=None,
             step_noise=None, generator=None):
        preds = sharded_eval_forward(                     # (B,S,H,F,N,3)
            model, x2d, x2d_flip, world or World(),
            num_proposals=num_proposals,
            sampling_timesteps=sampling_timesteps, init_noise=init_noise,
            step_noise=step_noise, generator=generator)
        if part_based:
            pred_wb = geometry.wb_pose_from_parts(preds)
            gt_wb = geometry.wb_pose_from_parts(x3d_parts)
        else:
            pred_wb, gt_wb = preds, x3d_parts

        # 2D reprojection for J_Agg
        reproj = geometry.project_to_2d(pred_wb + traj[:, None, None], cam)
        m = mask.float()
        scale = x2d.shape[0] / m.sum().clamp_min(1.0)

        def masked(x):
            return x * m.reshape((-1,) + (1,) * (x.dim() - 1)) * scale

        pred_m, gt_m = masked(pred_wb), masked(gt_wb)
        reproj_m, x2d_m = masked(reproj), masked(x2d)

        out = {"J_Best": losses.mpjpe_diffusion_all_min(pred_m, gt_m),
               "P_Best": losses.mpjpe_diffusion(pred_m, gt_m)[0],
               "P_Agg": losses.mpjpe_diffusion_all_min(pred_m, gt_m,
                                                       mean_pos=True),
               "J_Agg": losses.mpjpe_diffusion_reproj(pred_m, gt_m,
                                                      reproj_m, x2d_m)}
        pb, parts = losses.mpjpe_diffusion(pred_m, gt_m, part_based=True)
        out["P_Best_PB"] = pb
        for p in PART_NAMES:
            out[f"P_Best_PB_{p}"] = parts[p]
        agg, agg_parts = losses.mpjpe_diffusion_all_min(
            pred_m, gt_m, mean_pos=True, part_based=True)
        out["P_Agg_PB"] = agg
        for p in PART_NAMES:
            out[f"P_Agg_PB_{p}"] = agg_parts[p]
        if with_p2_data:
            # unmasked: the host slices the real rows itself
            out.update(_pred_wb=pred_wb, _gt_wb=gt_wb, _reproj=reproj,
                       _x2d=x2d)
        return out

    return step


def pinned_window_batch(seqs_2d, receptive_field: int,
                        sub_batch: int = 64) -> int:
    """One padded window-batch size for all of ``seqs_2d`` (a list of
    (F, J, 2) arrays): the pooled window count rounded up to a power of two,
    at most ``sub_batch``."""
    total = 0
    for s in seqs_2d:
        frames = np.squeeze(np.asarray(s)).shape[0]
        total += max(1, -(-frames // receptive_field))
    return min(sub_batch, 1 << (max(1, total) - 1).bit_length())


def _tail_rows(cur: int, bs: int) -> int:
    """Rows a partial batch of ``cur`` real rows is dispatched at: the
    smallest rung >= cur of the ladder (..., 16, 24, 32, 48, 64), capped at
    ``bs``."""
    tb = 1 << max(cur - 1, 0).bit_length()
    mid = tb - (tb >> 2)
    if cur <= mid:
        tb = mid
    return min(max(tb, 1), bs)


def evaluate_sequences(model: D3DP, sequences, *,
                       generator: Optional[torch.Generator] = None,
                       receptive_field: int = 27,
                       num_proposals: int = 10, sampling_timesteps: int = 5,
                       sub_batch: int = 64,
                       window_batch: Optional[int] = None,
                       quickdebug: bool = False,
                       collect_p2: bool = False,
                       return_predictions: bool = False,
                       noise_table=None,
                       sequence_batches: bool = False,
                       tail_bucket: bool = True,
                       timings: Optional[dict] = None,
                       world: Optional[World] = None,
                       ) -> Tuple[EvalAccumulator, object]:
    """Evaluate (cam, pose_3d, pose_2d) sequences with the model in eval
    mode; returns (metrics accumulator, second) where ``second`` is the
    protocol #2 accumulator with ``collect_p2``, the (windows, S, H, F, N, 3)
    whole-body predictions with ``return_predictions``, else None.

    Each sequence is windowed (with its flipped 2D twin for flip-TTA) and
    its ground truth centred per part.  The windows of all sequences are
    pooled into batches of ``window_batch`` rows (default: the pooled count
    rounded up to a power of two, at most ``sub_batch``); only the last
    batch is partial, its missing rows replicate the last real row and are
    masked out.  Metrics accumulate weighted by the batch's real windows
    times the frames, as the reference's ``batch_multiplier``.

    ``sequence_batches``: batches never mix sequences (the reference's
    granularity; P_Best takes its argmin over batch-mean errors, so its
    value depends on the batch composition).  ``tail_bucket``: a partial
    batch is dispatched at :func:`_tail_rows` rows instead of the full
    batch.  ``noise_table``: ``(init, step)`` of shapes (windows, H, F, N, 3)
    and (windows, S, H, F, N, 3) in pooled window order injects the DDIM
    noise; otherwise it is drawn from ``generator`` (a fresh one seeded 0
    on the model's device when omitted).  ``timings`` receives host-clock
    seconds of host_prep / transfer / dispatch / drain and window counts.
    ``world`` (``parallel.mesh``) with a process group shards each window
    batch over the ranks (the batch rounded up to a multiple of the world
    size); every rank gets the same metrics.

    Each batch's metric tensors are copied back right behind its work
    (``utils.device.to_host``) and read after the next batch has been
    dispatched (the one-deep drain): the read waits for its own batch
    only."""
    if model.training:
        raise RuntimeError("evaluate_sequences needs the model in eval mode "
                           "(call .eval() first)")
    if collect_p2 and return_predictions:
        raise ValueError(
            "collect_p2 and return_predictions are mutually exclusive")
    dev = model.device
    part_based = model.cfg.part_based
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    step = get_eval_step(model, num_proposals, sampling_timesteps,
                         part_based=part_based,
                         with_p2_data=collect_p2 or return_predictions,
                         world=world)
    acc = EvalAccumulator()
    p2_acc = EvalAccumulator()
    all_preds = []

    sequences = list(sequences)
    bs = (window_batch if window_batch is not None else
          pinned_window_batch([s for _, _, s in sequences], receptive_field,
                              sub_batch=sub_batch))
    if world is not None:   # even shards per rank
        bs = -(-max(bs, world.size) // world.size) * world.size

    def _drain(pending):
        t0 = time.perf_counter()
        metrics_dev, weight, cur = pending
        metrics = {k: v.numpy() for k, v in metrics_dev.items()}
        pred_wb = metrics.pop("_pred_wb", None)
        gt_wb = metrics.pop("_gt_wb", None)
        reproj = metrics.pop("_reproj", None)
        x2d_np = metrics.pop("_x2d", None)
        if collect_p2:
            p2_acc.add({
                "P2_J_Best": losses.p_mpjpe_diffusion_all_min(
                    pred_wb[:cur], gt_wb[:cur]),
                "P2_P_Best": losses.p_mpjpe_diffusion(
                    pred_wb[:cur], gt_wb[:cur]),
                "P2_P_Agg": losses.p_mpjpe_diffusion_all_min(
                    pred_wb[:cur], gt_wb[:cur], mean_pos=True),
                "P2_J_Agg": losses.p_mpjpe_diffusion_reproj(
                    pred_wb[:cur], gt_wb[:cur], reproj[:cur], x2d_np[:cur]),
            }, weight)
        if return_predictions:
            all_preds.append(pred_wb[:cur])
        acc.add(metrics, weight)
        if timings is not None:
            timings["drain"] = (timings.get("drain", 0.0)
                                + time.perf_counter() - t0)

    def _second():
        if return_predictions:
            return np.concatenate(all_preds, axis=0) if all_preds else None
        return p2_acc if collect_p2 else None

    # ---- host pass: window every sequence ---------------------------------
    t_prep = time.perf_counter()
    parts_2d, parts_2d_flip, parts_gt, parts_traj, parts_cam = [], [], [], [], []
    use_tta = bool(model.cfg.test_time_augmentation)
    for cam, seq_3d, seq_2d in sequences:
        w2d, w3d = win.eval_data_prepare(receptive_field, seq_2d, seq_3d)
        if use_tta:
            w2d_flip, _ = win.eval_data_prepare(
                receptive_field, geometry.flip_pose_np(
                    np.asarray(seq_2d, np.float32), model.flip_permutation))
        else:
            w2d_flip = w2d     # eval_forward ignores the twin without TTA
        w3d_t = torch.from_numpy(w3d)
        gt = (geometry.center_pose_parts(w3d_t) if part_based
              else geometry.center_pose_at_root(w3d_t))
        parts_2d.append(w2d)
        parts_2d_flip.append(w2d_flip)
        parts_gt.append(gt.numpy())
        parts_traj.append(w3d[:, :, :1].copy())
        parts_cam.append(np.tile(np.asarray(cam, np.float32).reshape(-1),
                                 (w2d.shape[0], 1)))
    if timings is not None:
        timings["host_prep"] = time.perf_counter() - t_prep
    if not parts_2d:
        return acc, _second()

    def pooled(chunks):
        a = np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]
        total = a.shape[0]
        nb = -(-total // bs)
        if nb * bs != total:    # edge-replicate the tail (rows masked out)
            a = np.concatenate([a, np.repeat(a[-1:], nb * bs - total, axis=0)],
                               axis=0)
        return np.ascontiguousarray(a.reshape((nb, bs) + a.shape[1:]),
                                    dtype=np.float32)

    seq_off = np.cumsum([0] + [p.shape[0] for p in parts_2d])
    total_windows = int(seq_off[-1])
    if noise_table is not None:
        init_tab = np.asarray(noise_table[0], np.float32)
        step_tab = np.asarray(noise_table[1], np.float32)
        if init_tab.shape[0] != total_windows or step_tab.shape[0] != total_windows:
            raise ValueError(f"noise_table holds {init_tab.shape[0]}/"
                             f"{step_tab.shape[0]} windows, the sequences "
                             f"{total_windows}")

    # pooled: one group spanning all sequences; sequence_batches: one each
    groups = ([[i] for i in range(len(parts_2d))] if sequence_batches
              else [list(range(len(parts_2d)))])
    pending = None
    for g in groups:
        lo, hi = int(seq_off[g[0]]), int(seq_off[g[-1] + 1])
        n_windows = hi - lo
        n_batches = -(-n_windows // bs)
        t_xfer = time.perf_counter()
        d2d, d2d_flip, dgt, dtraj, dcam = (
            to_device(pooled([chunks[i] for i in g]), dev) for chunks in
            (parts_2d, parts_2d_flip, parts_gt, parts_traj, parts_cam))
        masks = np.ones((n_batches, bs), np.float32)
        masks[-1, n_windows - (n_batches - 1) * bs:] = 0.0
        dmask = to_device(masks, dev)
        if timings is not None:
            timings["transfer"] = (timings.get("transfer", 0.0)
                                   + time.perf_counter() - t_xfer)
            timings["windows"] = timings.get("windows", 0) + n_windows
            timings["padded_rows"] = (timings.get("padded_rows", 0)
                                      + n_batches * bs - n_windows)
        if noise_table is not None:
            # S*H-fold larger than the data: ship one batch at a time
            hinit = pooled([init_tab[lo:hi]])
            hstep = np.moveaxis(pooled([step_tab[lo:hi]]), 2, 1)  # (nb,S,bs,...)

        for b_i in range(n_batches):
            cur = min(bs, n_windows - b_i * bs)
            tb = _tail_rows(cur, bs) if tail_bucket and cur < bs else bs
            if tb < bs and timings is not None:
                timings["tail_rows_saved"] = (
                    timings.get("tail_rows_saved", 0) + bs - tb)
            t_disp = time.perf_counter()
            args = [t[b_i, :tb] for t in (d2d, d2d_flip, dgt, dtraj, dcam,
                                          dmask)]
            if noise_table is not None:
                args += [to_device(hinit[b_i, :tb], dev),
                         to_device(hstep[b_i][:, :tb], dev)]
            # the readback is queued right behind this batch's work
            metrics_dev = {k: to_host(v) for k, v in
                           step(*args, generator=generator).items()}
            if timings is not None:
                timings["dispatch"] = (timings.get("dispatch", 0.0)
                                       + time.perf_counter() - t_disp)
                timings["batches"] = timings.get("batches", 0) + 1
            if pending is not None:
                _drain(pending)
            # weight: real windows x frames (the reference's batch_multiplier)
            pending = (metrics_dev, cur * receptive_field, cur)
            if quickdebug:
                break
        if quickdebug:
            break
    if pending is not None:
        _drain(pending)
    return acc, _second()


# ---------------------------------------------------------------------------
# Text report (the reference's vocabulary)
# ---------------------------------------------------------------------------

def format_report(means_mm: Dict[str, np.ndarray], action: Optional[str],
                  p2_means: Optional[Dict[str, np.ndarray]] = None) -> str:
    lines: List[str] = []
    lines.append("----------" if action is None else f"----{action}----")
    steps = len(np.atleast_1d(means_mm["J_Best"]))
    g = lambda k, i: float(np.atleast_1d(means_mm[k])[i])  # noqa: E731
    for ii in range(steps):
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) J_Best: "
                     f"{g('J_Best', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best: "
                     f"{g('P_Best', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg: "
                     f"{g('P_Agg', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) J_Agg: "
                     f"{g('J_Agg', ii):f} mm")
        lines.append("-----------------> Part-Based Evaluation <-----------------")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best Part-Based: "
                     f"{g('P_Best_PB', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best Part-Based "
                     f"BODY: {g('P_Best_PB_body', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best Part-Based "
                     f"FACE: {g('P_Best_PB_face', ii):f} mm")
        hands = 0.5 * (g("P_Best_PB_left_hand", ii)
                       + g("P_Best_PB_right_hand", ii))
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best Part-Based "
                     f"HANDS: {hands:f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best Part-Based "
                     f"LEFT HAND: {g('P_Best_PB_left_hand', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Best Part-Based "
                     f"RIGHT HAND: {g('P_Best_PB_right_hand', ii):f} mm")
        lines.append("-----------------> Part-Based Evaluation Aggregation "
                     "<-----------------")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg Part-Based: "
                     f"{g('P_Agg_PB', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg Part-Based "
                     f"BODY: {g('P_Agg_PB_body', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg Part-Based "
                     f"FACE: {g('P_Agg_PB_face', ii):f} mm")
        hands = 0.5 * (g("P_Agg_PB_left_hand", ii)
                       + g("P_Agg_PB_right_hand", ii))
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg Part-Based "
                     f"HANDS: {hands:f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg Part-Based "
                     f"LEFT HAND: {g('P_Agg_PB_left_hand', ii):f} mm")
        lines.append(f"step {ii} : Protocol #1 Error (MPJPE) P_Agg Part-Based "
                     f"RIGHT HAND: {g('P_Agg_PB_right_hand', ii):f} mm")
        if p2_means:
            for key, label in [("P2_J_Best", "J_Best"), ("P2_P_Best", "P_Best"),
                               ("P2_P_Agg", "P_Agg"), ("P2_J_Agg", "J_Agg")]:
                v = float(np.atleast_1d(p2_means[key])[ii])
                lines.append(f"step {ii} : Protocol #2 Error (MPJPE) {label}: "
                             f"{v:f} mm")
    lines.append("----------")
    return "\n".join(lines) + "\n"


def format_actionwise_average(
        avg: Dict[str, np.ndarray],
        p2_avg: Optional[Dict[str, np.ndarray]] = None) -> str:
    """The final averaged block: the four aggregation metrics, the
    part-based P_Best/P_Agg breakdowns and, with ``p2_avg``, the protocol #2
    averages."""
    g = lambda d, k, i: float(np.atleast_1d(d[k])[i])  # noqa: E731
    P1 = "Protocol #1   (MPJPE) action-wise average"
    lines: List[str] = []
    steps = len(np.atleast_1d(avg["J_Best"]))
    for ii in range(steps):
        lines.append(f"step {ii} {P1} J_Best: {g(avg, 'J_Best', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Best: {g(avg, 'P_Best', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Agg: {g(avg, 'P_Agg', ii):f} mm")
        lines.append(f"step {ii} {P1} J_Agg: {g(avg, 'J_Agg', ii):f} mm")
        lines.append("-----------------> Part-Based Evaluation "
                     "<-----------------")
        lines.append(f"step {ii} {P1} P_Best (Part-Based): "
                     f"{g(avg, 'P_Best_PB', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Best (Part-Based) BODY: "
                     f"{g(avg, 'P_Best_PB_body', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Best (Part-Based) FACE: "
                     f"{g(avg, 'P_Best_PB_face', ii):f} mm")
        hands = 0.5 * (g(avg, "P_Best_PB_left_hand", ii)
                       + g(avg, "P_Best_PB_right_hand", ii))
        lines.append(f"step {ii} {P1} P_Best (Part-Based) HANDS: "
                     f"{hands:f} mm")
        lines.append(f"step {ii} {P1} P_Best (Part-Based) LEFT HAND: "
                     f"{g(avg, 'P_Best_PB_left_hand', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Best (Part-Based) RIGHT HAND: "
                     f"{g(avg, 'P_Best_PB_right_hand', ii):f} mm")
        lines.append("-----------------> Part-Based Agg Evaluation "
                     "<-----------------")
        lines.append(f"step {ii} {P1} P_Agg (Part-Based): "
                     f"{g(avg, 'P_Agg_PB', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Agg (Part-Based) BODY: "
                     f"{g(avg, 'P_Agg_PB_body', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Agg (Part-Based) FACE: "
                     f"{g(avg, 'P_Agg_PB_face', ii):f} mm")
        hands = 0.5 * (g(avg, "P_Agg_PB_left_hand", ii)
                       + g(avg, "P_Agg_PB_right_hand", ii))
        lines.append(f"step {ii} {P1} P_Agg (Part-Based) HANDS: "
                     f"{hands:f} mm")
        lines.append(f"step {ii} {P1} P_Agg (Part-Based) LEFT HAND: "
                     f"{g(avg, 'P_Agg_PB_left_hand', ii):f} mm")
        lines.append(f"step {ii} {P1} P_Agg (Part-Based) RIGHT HAND: "
                     f"{g(avg, 'P_Agg_PB_right_hand', ii):f} mm")
        # the reference writes ' \n \n' after the last protocol #1 line
        lines.append(" ")
        lines.append(" ")
        if p2_avg:
            P2 = "Protocol #2   (MPJPE) action-wise average"
            lines.append(f"step {ii} {P2} J_Best: "
                         f"{g(p2_avg, 'P2_J_Best', ii):f} mm")
            lines.append(f"step {ii} {P2} P_Best: "
                         f"{g(p2_avg, 'P2_P_Best', ii):f} mm")
            lines.append(f"step {ii} {P2} P_Agg: "
                         f"{g(p2_avg, 'P2_P_Agg', ii):f} mm")
            lines.append(f"step {ii} {P2} J_Agg: "
                         f"{g(p2_avg, 'P2_J_Agg', ii):f} mm")
    return "\n".join(lines) + "\n"


def write_report(checkpoint_dir: str, num_proposals: int,
                 sampling_timesteps: int, text: str) -> str:
    """Append ``text`` to ``{checkpoint_dir}/h36m_test_log_H{P}_K{T}.txt``."""
    os.makedirs(checkpoint_dir or ".", exist_ok=True)
    path = os.path.join(
        checkpoint_dir or ".",
        f"h36m_test_log_H{num_proposals}_K{sampling_timesteps}.txt")
    with open(path, "a") as f:
        f.write(text)
    return path
