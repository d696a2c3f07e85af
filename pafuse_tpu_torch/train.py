"""Training: AdamW with a per-step learning rate on the part-based D3DP.

Counterpart of ``pafuse_tpu/train.py`` on one device.  A step centres the
ground truth on the device (each part at its own root), noises it, denoises
it in train mode (on the model's training path: every block through
``ops.block_train``, kernels #5 and #6 on the GPU, or the autodiff path),
takes the MPJPE loss, backpropagates and applies one AdamW update.
Randomness of a step (the diffusion steps t, the noise, the
stochastic-depth masks and the dropout masks) comes from the state's
``torch.Generator``, or is injected.

The optimizer is ``torch.optim.AdamW(weight_decay=0.1, betas=(0.9, 0.999),
eps=1e-8)`` over all parameters: optax ``adamw`` has no mask, so LayerNorm
parameters, biases and position embeddings are decayed too.  The learning
rate is set before every step, as ``optax.inject_hyperparams`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pafuse_tpu_torch import geometry, losses
from pafuse_tpu_torch.diffusion import D3DP
from pafuse_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """The model and the optimizer (both updated in place by a step) and the
    generator of the step's random draws."""
    model: D3DP
    optimizer: torch.optim.AdamW
    generator: torch.Generator


def make_optimizer(params, weight_decay: float = 0.1) -> torch.optim.AdamW:
    """AdamW(wd=0.1) with the learning rate set per step (starts at 0)."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(model: D3DP, seed: int = 1, weight_decay: float = 0.1,
                       device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (CUDA unless the CPU is asked for; raises
    without CUDA), put it in train mode, and pair it with AdamW and a
    generator on that device seeded from ``seed``."""
    dev = resolve_device(device)
    model.to(dev).train()
    model.device = dev
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model, make_optimizer(model.parameters(), weight_decay),
                      gen)


def build_train_step(model: D3DP, optimizer: torch.optim.Optimizer, *,
                     weights: Optional[np.ndarray] = None,
                     mse_loss: bool = False, wb_loss: bool = False,
                     part_based: bool = True) -> Callable[..., torch.Tensor]:
    """Returns ``step(state, lr, x2d, x3d, *, t=None, noise=None,
    masks=None, dropout_masks=None) -> loss``.

    ``x3d`` is the raw camera-space ground truth (B, F, N, 3); it is centred
    on the device (per part, or at the root for a monolithic model).  ``t``,
    ``noise``, ``masks`` ({part: [(m1, m2) per block]}) and
    ``dropout_masks`` ({part: ``models.mixste.draw_dropout_masks``'s
    layout}) may be injected; what is not is drawn from
    ``state.generator``.  The loss is float32 whatever the model's compute
    dtype; params, gradients and the AdamW state are float32.  Model and optimizer are
    updated in place; the loss comes back as a device scalar (reading it
    waits for the step)."""
    w = (torch.as_tensor(weights, dtype=torch.float32, device=model.device)
         if weights is not None else None)

    def step(state: TrainState, lr: float, x2d, x3d, *,
             t=None, noise=None,
             masks: Optional[Dict[str, Sequence]] = None,
             dropout_masks: Optional[Dict[str, dict]] = None) -> torch.Tensor:
        dev = model.device
        x2d = torch.as_tensor(x2d, dtype=torch.float32, device=dev)
        x3d = torch.as_tensor(x3d, dtype=torch.float32, device=dev)
        x3d_c = (geometry.center_pose_parts(x3d) if part_based
                 else geometry.center_pose_at_root(x3d))
        pred = model.train_forward(x2d, x3d_c, t=t, noise=noise, masks=masks,
                                   dropout_masks=dropout_masks,
                                   generator=state.generator)
        target = x3d_c
        if part_based and wb_loss:
            pred = geometry.wb_pose_from_parts(pred)
            target = geometry.wb_pose_from_parts(target)
        loss = losses.mpjpe(pred, target, weights=w, mse_loss=mse_loss)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        optimizer.step()
        return loss.detach()

    return step


def pad_batch(arr: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Pad a partial batch up to ``batch_size`` by repeating the last row
    (the repeated rows carry no loss mask, as in the JAX package); returns
    (padded, real_count)."""
    n = arr.shape[0]
    if n == batch_size:
        return arr, n
    pad = np.repeat(arr[-1:], batch_size - n, axis=0)
    return np.concatenate([arr, pad], axis=0), n


def mixste_weight_table(num_kps: int = 134) -> np.ndarray:
    """Per-joint loss weights: 18 MixSTE-derived values, then 1.0 for the
    remaining whole-body joints."""
    weight = [1, 1, 1, 1, 1, 1, 1.5, 1.5, 4, 4, 4, 4, 1, 1, 2.5, 2.5, 2.5, 2.5]
    weight.extend((num_kps - len(weight)) * [1.0])
    return np.asarray(weight, dtype=np.float32)
