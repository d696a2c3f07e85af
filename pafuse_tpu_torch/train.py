"""Training: AdamW with a per-step learning rate on the part-based D3DP.

Counterpart of ``pafuse_tpu/train.py`` on one device.  A step centres the
ground truth on the device (each part at its own root), noises it, denoises
it in train mode (on the model's training path: every block through
``ops.block_train``, kernels #5 and #6 on the GPU, or the autodiff path),
takes the MPJPE loss, backpropagates and applies one AdamW update.
Randomness of a step (the diffusion steps t, the noise, the
stochastic-depth masks and the dropout masks) comes from the state's
``torch.Generator``, or is injected.

Data parallel (``world=`` with a process group, ``parallel.mesh``): every
rank is handed the same global batch and draws the whole batch's
randomness from the same seeded generator, in the order one process draws
it (``D3DP.draw_train``); it then runs its own rows through the model behind
``DistributedDataParallel``, whose backward averages the gradients, so a
step equals one process on the global batch and the replicas stay equal.

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
from pafuse_tpu_torch.parallel.mesh import (World, all_mean, replicate,
                                            shard_rows)
from pafuse_tpu_torch.utils.device import resolve_device, to_device, to_host


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


def _draw_rows(draws, world: World, batch: int):
    """This rank's rows of ``D3DP.draw_train``'s draws for a global batch of
    ``batch`` rows: rows of t, the noise and the branch masks, and of the
    dropout masks, whose leading axis is batch x S (b-major)."""
    def cut(x):
        k = x.shape[0] // batch * (batch // world.size)
        return x[world.rank * k:(world.rank + 1) * k]

    t, noise, masks, drop = draws
    masks = {p: [tuple(cut(m) for m in pair) for pair in v]
             for p, v in masks.items()}
    if drop is not None:
        drop = {p: {"pos": [None if m is None else cut(m) for m in d["pos"]],
                    "blocks": [{k: None if m is None else cut(m)
                                for k, m in b.items()} for b in d["blocks"]]}
                for p, d in drop.items()}
    return cut(t), cut(noise), masks, drop


def build_train_step(model: D3DP, optimizer: torch.optim.Optimizer, *,
                     weights: Optional[np.ndarray] = None,
                     mse_loss: bool = False, wb_loss: bool = False,
                     part_based: bool = True,
                     world: Optional[World] = None
                     ) -> Callable[..., torch.Tensor]:
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
    waits for the step).

    With a ``world`` that has a process group, ``x2d``/``x3d`` and the
    injected draws are the global batch's; the step takes this rank's rows
    of them (``parallel.mesh.shard_rows``), backpropagates through
    ``parallel.mesh.replicate`` and returns the loss averaged over the
    ranks, the global batch's loss."""
    w = (torch.as_tensor(weights, dtype=torch.float32, device=model.device)
         if weights is not None else None)
    parallel = world is not None and world.distributed
    forward = replicate(model, world) if parallel else model.train_forward

    def step(state: TrainState, lr: float, x2d, x3d, *,
             t=None, noise=None,
             masks: Optional[Dict[str, Sequence]] = None,
             dropout_masks: Optional[Dict[str, dict]] = None) -> torch.Tensor:
        dev = model.device
        if parallel:
            t, noise, masks, dropout_masks = _draw_rows(
                model.draw_train(x3d.shape, dev, state.generator, t=t,
                                 noise=noise, masks=masks,
                                 dropout_masks=dropout_masks),
                world, x3d.shape[0])
            x2d, x3d = shard_rows((x2d, x3d), world)
        x2d = to_device(x2d, dev, torch.float32)
        x3d = to_device(x3d, dev, torch.float32)
        x3d_c = (geometry.center_pose_parts(x3d) if part_based
                 else geometry.center_pose_at_root(x3d))
        pred = forward(x2d, x3d_c, t=t, noise=noise, masks=masks,
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
        loss = loss.detach()
        return all_mean(loss, world) if parallel else loss

    return step


def run_epoch(step: Callable[..., torch.Tensor], state: TrainState, lr: float,
              batches, seqs_per_batch: int, *, rows_weight: int = 1,
              quickdebug: bool = False,
              progress: Optional[Callable[[int], None]] = None
              ) -> Tuple[float, int]:
    """One epoch of ``step`` over ``batches`` ((cam, x3d, x2d) triples,
    each padded to ``seqs_per_batch`` rows by :func:`pad_batch`), with a
    one-deep loss readback: step N's loss is read (``utils.device.to_host``:
    a pinned copy queued right behind step N) after step N+1 has been
    queued, and the read waits for step N alone.  Returns (sum of loss x
    weight, sum of weights), a batch's weight being its real rows times
    ``rows_weight``.  ``progress(i)`` is called before batch i;
    ``quickdebug`` stops after one batch."""
    total, seen, pending = 0.0, 0, None
    for it, (_, b3d, b2d) in enumerate(batches):
        if progress is not None:
            progress(it)
        b2d, real = pad_batch(b2d, seqs_per_batch)
        b3d, _ = pad_batch(b3d, seqs_per_batch)
        loss = to_host(step(state, lr, b2d, b3d))
        if pending is not None:
            total += pending[1] * float(pending[0].numpy())
        pending = (loss, real * rows_weight)
        seen += real * rows_weight
        if quickdebug:
            break
    if pending is not None:
        total += pending[1] * float(pending[0].numpy())
    return total, seen


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
