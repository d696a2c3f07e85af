"""D3DP conditional diffusion for 3D pose: multi-hypothesis DDIM with flip
test-time augmentation, and the training-time noising.

Counterpart of ``pafuse_tpu/diffusion.py``.  Schedules are computed in
float64 NumPy and stored as float32; the DDIM step coefficients are computed
in NumPy exactly as the JAX sampler does.  ``ddim_sample`` is a Python loop
over the S steps; the H hypotheses and the flipped twin ride the batch axis
of one denoiser call per step.  ``train_forward`` noises the ground truth
with one vectorised draw per batch (``t`` and the noise may be injected) and
denoises it in train mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from pafuse_tpu_torch import geometry, skeleton as sk
from pafuse_tpu_torch.models.mixste import (_require_experimental,
                                            branch_masks, draw_dropout_masks)
from pafuse_tpu_torch.models.parts import (PartModel, build_part_specs,
                                           monolithic_spec)
from pafuse_tpu_torch.utils.device import resolve_device


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


@dataclasses.dataclass(frozen=True)
class Schedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray


def make_schedule(timesteps: int) -> Schedule:
    betas = cosine_beta_schedule(timesteps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return Schedule(
        betas=betas.astype(np.float32),
        alphas_cumprod=ac.astype(np.float32),
        alphas_cumprod_prev=ac_prev.astype(np.float32),
        sqrt_alphas_cumprod=np.sqrt(ac).astype(np.float32),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac).astype(np.float32),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac).astype(np.float32),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0).astype(np.float32),
        posterior_variance=post_var.astype(np.float32),
        posterior_log_variance_clipped=np.log(
            np.clip(post_var, 1e-20, None)).astype(np.float32),
        posterior_mean_coef1=(betas * np.sqrt(ac_prev) / (1.0 - ac)).astype(np.float32),
        posterior_mean_coef2=((1.0 - ac_prev) * np.sqrt(alphas)
                              / (1.0 - ac)).astype(np.float32),
    )


def ddim_time_pairs(total_timesteps: int, sampling_timesteps: int
                    ) -> List[Tuple[int, int]]:
    """[(T-1, t_{S-1}), ..., (t_1, -1)]."""
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(int).tolist()))
    return list(zip(times[:-1], times[1:]))


@dataclasses.dataclass(frozen=True)
class D3DPConfig:
    frames: int = 27
    num_kps: int = 134
    timesteps: int = 1000
    sampling_timesteps: int = 5
    num_proposals: int = 10
    scale: float = 1.0
    eta: float = 1.0
    depth: int = 8
    input_size: int = 5
    cs: int = 288                   # monolithic channel size
    part_based: bool = True
    merge_hands: bool = True
    drop_path_rate: float = 0.0     # 0.1 for training
    dropout: float = 0.0            # MLP/proj/pos dropout in training
    attn_dropout: float = 0.0
    test_time_augmentation: bool = True
    mm_scale: bool = False          # 3DHP variant: model works in mm / 1000


class D3DP(nn.Module):
    """D3DP: schedule tables, the part router and the flip table.

    ``pose_estimator`` is the :class:`PartModel`, so ``state_dict()`` keys
    are the reference's ``pose_estimator.{part}.…`` names.  The module
    starts in eval mode; :meth:`train_forward` needs ``.train()``.
    ``use_pallas`` and ``experimental_kernels`` select the eval-mode
    functions of every part network (``models.mixste.MixSTE2.
    set_use_pallas``), ``train_kernel`` the training path (kernels #5/#6,
    or the autodiff path, which dropout also takes; ``MixSTE2.train_path``)
    and ``remat`` its recomputation; ``compute_dtype`` (float32 or
    bfloat16) is the denoiser's activation dtype, while the noising, the
    sampler and the model's output stay float32.  ``flip_permutation`` is
    the flip-TTA joint table; without one, the 134- and 133-joint H3WB
    tables are known and any other joint count raises.  ``packed_parts``
    runs the part networks packed in eval mode (``PartModel(packed=)``), an
    experimental path of the JAX package: with a part-based config it
    raises unless ``experimental_kernels`` opens the gate."""

    def __init__(self, cfg: D3DPConfig, device="cuda",
                 generator: torch.Generator | None = None,
                 use_pallas="auto", experimental_kernels: bool = False,
                 flip_permutation: Optional[np.ndarray] = None,
                 compute_dtype=torch.float32, train_kernel="auto",
                 remat: bool = False, packed_parts: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.schedule = make_schedule(cfg.timesteps)
        if cfg.part_based and cfg.num_kps != sk.NUM_JOINTS:
            raise ValueError(f"num_kps={cfg.num_kps}: the part-based model "
                             f"needs the {sk.NUM_JOINTS}-joint H3WB layout")
        # the flip table: given, or known for 134 and 133 joints; an
        # identity here would silently corrupt flip-TTA, so anything else
        # raises
        if flip_permutation is not None:
            perm = np.asarray(flip_permutation, np.int32)
        elif cfg.num_kps == sk.NUM_JOINTS:
            perm = sk.FLIP_PERMUTATION
        elif cfg.num_kps == sk.NUM_JOINTS - 1:
            perm = sk.FLIP_PERMUTATION_NO_ROOT
        else:
            raise ValueError(f"No flip permutation known for num_kps="
                             f"{cfg.num_kps}; pass flip_permutation=")
        if perm.shape != (cfg.num_kps,):
            raise ValueError(f"flip_permutation has shape {perm.shape}, "
                             f"expected ({cfg.num_kps},)")
        self.flip_permutation = perm
        rates = dict(drop_path_rate=cfg.drop_path_rate, drop_rate=cfg.dropout,
                     attn_drop_rate=cfg.attn_dropout)
        if cfg.part_based:
            specs = build_part_specs(sk.parts_table(cfg.merge_hands),
                                     cfg.frames, cfg.input_size, cfg.depth,
                                     **rates)
        else:
            specs = monolithic_spec(cfg.num_kps, cfg.frames, cfg.input_size,
                                    cfg.cs, cfg.depth, **rates)
        packed_parts = packed_parts and cfg.part_based
        if packed_parts:
            # a measured negative result of the JAX package, kept for A/B
            _require_experimental("D3DP(packed_parts=True)",
                                  experimental_kernels)
        self.pose_estimator = PartModel(specs, self.device, generator,
                                        use_pallas, experimental_kernels,
                                        compute_dtype, train_kernel, remat,
                                        packed=packed_parts)
        for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
            self.register_buffer(f"_{name}", torch.as_tensor(
                getattr(self.schedule, name), device=self.device),
                persistent=False)
        self.eval()

    def _clamp_scaled(self, x: torch.Tensor) -> torch.Tensor:
        s = self.cfg.scale
        return x.clamp(-1.1 * s, 1.1 * s)

    # -- training ------------------------------------------------------------
    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        a = self._sqrt_alphas_cumprod[t].reshape(shape)
        b = self._sqrt_one_minus_alphas_cumprod[t].reshape(shape)
        return a * x_start + b * noise

    def prepare_targets(self, x3d_gt: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor):
        """Noise the ground truth at steps ``t`` (B,) with ``noise`` (like
        x3d_gt): (x_t, noise, t)."""
        dev = x3d_gt.device
        t = torch.as_tensor(t, device=dev).long()
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        x = self.q_sample(x3d_gt * self.cfg.scale, t, noise)
        return self._clamp_scaled(x) / self.cfg.scale, noise, t

    def draw_train(self, x3d_shape, device,
                   generator: Optional[torch.Generator] = None, *,
                   t=None, noise=None,
                   masks: Optional[Dict[str, Sequence]] = None,
                   dropout_masks: Optional[Dict[str, dict]] = None):
        """The random draws of one training forward on a batch of
        ``x3d_shape`` (B, F, N, 3), those not given drawn from
        ``generator`` in this order: t, the noise, then for each part
        network in spec order its branch masks and (with dropout) its
        dropout masks.  The one place that order is kept: the
        one-process step and the data-parallel step (which draws for the
        global batch) both come here.  Returns (t, noise, masks,
        dropout_masks), the last None without dropout."""
        B = x3d_shape[0]
        if t is None:
            t = torch.randint(0, self.cfg.timesteps, (B,),
                              generator=generator, device=device)
        if noise is None:
            noise = torch.randn(tuple(x3d_shape), generator=generator,
                                device=device)
        masks, drop = dict(masks or {}), dict(dropout_masks or {})
        for spec in self.pose_estimator.specs:
            cfg = self.pose_estimator[spec.name].cfg
            if spec.name not in masks:
                masks[spec.name] = [
                    branch_masks(float(rate), B, device, generator)
                    for rate in np.repeat(cfg.drop_path_rates, 2)]
            if cfg.has_dropout and spec.name not in drop:
                drop[spec.name] = draw_dropout_masks(cfg, B, device,
                                                     generator)
        return t, noise, masks, drop or None

    @property
    def train_path(self) -> str:
        """"kernels" or "autodiff": the training path of the part networks,
        which share the config (``MixSTE2.train_path``)."""
        return next(iter(self.pose_estimator.values())).train_path

    def train_forward(self, x2d: torch.Tensor, x3d_gt: torch.Tensor, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      masks: Optional[Dict[str, Sequence]] = None,
                      dropout_masks: Optional[Dict[str, dict]] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Training pass: noise the ground truth, denoise it in train mode,
        return the x0 prediction (B, F, N, 3).  ``t``, ``noise``, the
        stochastic-depth ``masks`` ({part: [(m1, m2), ...]}) and the
        ``dropout_masks`` ({part: ``models.mixste.draw_dropout_masks``'s
        layout}) may be injected; the rest is drawn from ``generator``
        (:meth:`draw_train`).  With
        ``mm_scale`` the ground truth arrives in millimetres and the
        prediction is returned in millimetres."""
        if not self.training:
            raise RuntimeError("D3DP.train_forward needs train mode "
                               "(call .train() first)")
        if self.cfg.mm_scale:
            x3d_gt = x3d_gt / 1000.0
        t, noise, masks, dropout_masks = self.draw_train(
            x3d_gt.shape, x3d_gt.device, generator, t=t, noise=noise,
            masks=masks, dropout_masks=dropout_masks)
        x_t, _, t = self.prepare_targets(x3d_gt, t, noise)
        pred = self.pose_estimator(x2d, x_t, t, masks=masks,
                                   dropout_masks=dropout_masks)
        return pred * 1000.0 if self.cfg.mm_scale else pred

    def _model_predictions(self, x: torch.Tensor, x2d_tiled: torch.Tensor,
                           t: int, x2d_flip_tiled: Optional[torch.Tensor],
                           packed: Optional[dict] = None):
        """x: (B,H,F,N,3) noisy -> (pred_noise, x_start), same shape.

        (B, H) fold into the batch; with flip-TTA the flipped twin is
        appended to the batch, denoised in the same call, un-flipped and
        averaged.  ``packed``: the part networks' packed parameters
        (``PartModel.prepare``), or None."""
        cfg = self.cfg
        B, H, F, N, C = x.shape
        xt_flat = (self._clamp_scaled(x) / cfg.scale).reshape(B * H, F, N, C)
        t_cond = torch.full((B * H,), t, dtype=torch.int32, device=x.device)
        if x2d_flip_tiled is not None:
            perm = self.flip_permutation
            xt_flip = geometry.flip_pose(xt_flat, perm)
            pred = self.pose_estimator(
                torch.cat([x2d_tiled, x2d_flip_tiled]),
                torch.cat([xt_flat, xt_flip]), torch.cat([t_cond, t_cond]),
                packed_params=packed)
            pred_n, pred_f = pred[:B * H], pred[B * H:]
            pred = 0.5 * (pred_n + geometry.flip_pose(pred_f, perm))
        else:
            pred = self.pose_estimator(x2d_tiled, xt_flat, t_cond,
                                       packed_params=packed)

        x_start = self._clamp_scaled(pred.reshape(B, H, F, N, C) * cfg.scale)
        sched = self.schedule
        r = float(sched.sqrt_recip_alphas_cumprod[t])
        rm1 = float(sched.sqrt_recipm1_alphas_cumprod[t])
        pred_noise = (r * x - x_start) / rm1
        return pred_noise, x_start

    @torch.no_grad()
    def ddim_sample(self, x2d: torch.Tensor,
                    x2d_flip: Optional[torch.Tensor] = None,
                    num_proposals: Optional[int] = None,
                    sampling_timesteps: Optional[int] = None,
                    init_noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """Multi-hypothesis DDIM sampling.

        x2d: (B, F, N, 2) conditioning; x2d_flip: optional flipped twin.
        init_noise: optional (B, H, F, N, 3) x_T; step_noise: optional
        (S, B, H, F, N, 3) per-step noise.  Noise not given is drawn from
        ``generator`` on the model's device (:func:`ddim_noise`).
        Returns (B, S, H, F, N, 3) x0 predictions of every step, in
        millimetres with ``mm_scale``."""
        cfg = self.cfg
        H = cfg.num_proposals if num_proposals is None else num_proposals
        S = (cfg.sampling_timesteps if sampling_timesteps is None
             else sampling_timesteps)
        if H < 1 or S < 1:
            raise ValueError(f"num_proposals/sampling_timesteps must be >=1, "
                             f"got {H}/{S}")
        sched = self.schedule
        dev = x2d.device

        pairs = ddim_time_pairs(cfg.timesteps, S)
        times = np.array([p[0] for p in pairs], dtype=np.int32)
        times_next = np.array([p[1] for p in pairs], dtype=np.int32)
        alpha = sched.alphas_cumprod[times]
        alpha_next = np.where(times_next >= 0,
                              sched.alphas_cumprod[np.maximum(times_next, 0)], 1.0)
        sigma = cfg.eta * np.sqrt(np.clip(
            (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha), 0, None))
        coef_c = np.sqrt(np.clip(1 - alpha_next - sigma ** 2, 0, None))
        alpha_next_sqrt = np.sqrt(alpha_next).astype(np.float32)
        sigma = sigma.astype(np.float32)
        coef_c = coef_c.astype(np.float32)

        x2d_tiled = x2d.repeat_interleave(H, dim=0)
        x2d_flip_tiled = (x2d_flip.repeat_interleave(H, dim=0)
                          if x2d_flip is not None else None)

        init_noise, step_noise = ddim_noise(cfg, x2d.shape, H, S, dev,
                                            generator, init_noise, step_noise)
        # the part networks packed once for all steps (None when unpacked)
        packed = self.pose_estimator.prepare(train=False)
        img = init_noise.to(dev, torch.float32)
        preds = []
        for i in range(S):
            pred_noise, x_start = self._model_predictions(
                img, x2d_tiled, int(times[i]), x2d_flip_tiled, packed)
            preds.append(x_start)
            if times_next[i] < 0:
                img = x_start
                continue
            noise = step_noise[i].to(dev, torch.float32)
            img = (x_start * float(alpha_next_sqrt[i])
                   + float(coef_c[i]) * pred_noise + float(sigma[i]) * noise)
        preds = torch.stack(preds, dim=1)
        # the 3DHP variant reports millimetres
        return preds * 1000.0 if cfg.mm_scale else preds

    def eval_forward(self, x2d: torch.Tensor,
                     x2d_flip: Optional[torch.Tensor] = None, **kw):
        """Eval-mode forward: DDIM with flip-TTA when the config enables it
        and a flipped twin is given."""
        if self.cfg.test_time_augmentation and x2d_flip is not None:
            return self.ddim_sample(x2d, x2d_flip, **kw)
        return self.ddim_sample(x2d, None, **kw)


def ddim_noise(cfg: D3DPConfig, x2d_shape, num_proposals: int,
               sampling_timesteps: int, device, generator=None,
               init_noise=None, step_noise=None):
    """The DDIM noise of a batch of 2D windows of ``x2d_shape``
    (B, F, N, 2): those given passed through, the rest drawn from
    ``generator`` in this order: x_T, then each step that adds noise.
    ``D3DP.ddim_sample`` and the sharded evaluation (which draws for the
    global batch) both come here.  Returns (init (B, H, F, N, 3),
    steps (S, B, H, F, N, 3)); the last step adds none and its slot is
    zeros."""
    B, F, N, _ = x2d_shape
    shape = (B, num_proposals, F, N, 3)
    if init_noise is None:
        init_noise = torch.randn(shape, generator=generator, device=device)
    if step_noise is None:
        pairs = ddim_time_pairs(cfg.timesteps, sampling_timesteps)
        step_noise = torch.stack([
            torch.randn(shape, generator=generator, device=device)
            if nxt >= 0 else torch.zeros(shape, device=device)
            for _, nxt in pairs])
    return init_noise, step_noise
