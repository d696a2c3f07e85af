"""MixSTE2 spatio-temporal transformer denoiser.

Counterpart of ``pafuse_tpu/models/mixste.py``.  Submodules carry the
reference PAFUSE names (``STEblocks.3.attn.qkv``, ``time_mlp.1``,
``head.0`` ...), so a reference-named state dict, stripped of its
``pose_estimator.{part}.`` prefix, loads with ``strict=True``.

Every spatial and temporal block, together with its outer Spatial/Temporal
LayerNorm, goes through one function.  In eval mode (the default after
construction) that is ``block_fn``, chosen by ``use_pallas`` as the JAX
package chooses ``block_fn``/``attention_fn`` (:func:`select_block_fn`):
``ops.block.fused_block`` (kernel #1) or :func:`unfused_block` with
``ops.attention.fused_attention`` (kernel #2) as its attention.  Two
experimental values, behind the ``experimental_kernels`` gate as in the JAX
package, take blocks off ``block_fn``: ``block_t`` runs every temporal block
through ``block_t_fn``, ``ops.block_temporal.fused_block_temporal`` (kernel
#3), on the (B, F, N, C) activation without a transpose, and ``layer`` runs
every layer through ``layer_fn``, ``ops.layer.fused_layer`` (kernel #4).
In train mode (``.train()``) every block goes through ``train_block_fn``,
``ops.block_train.block_train``, the differentiable block with
stochastic-depth branch masks (rates ``linspace(0, drop_path_rate,
depth)``), whatever ``use_pallas`` says.  The kernels run on the GPU and
their plain versions on the CPU.

Numerics (float32): block, Spatial and Temporal norms use eps 1e-6, the
head norm torch's default 1e-5; GELU is exact.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pafuse_tpu_torch.ops.attention import attention_reference, fused_attention
from pafuse_tpu_torch.ops.block import fused_block
from pafuse_tpu_torch.ops.block_temporal import fused_block_temporal
from pafuse_tpu_torch.ops.block_train import block_train
from pafuse_tpu_torch.ops.layer import fused_layer
from pafuse_tpu_torch.utils.device import resolve_device

#: per block, the (attention, MLP) branch masks, one value per sample
BranchMasks = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MixSTEConfig:
    num_frames: int = 27
    num_joints: int = 24
    in_chans: int = 5
    embed_dim: int = 384
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    out_dim: int = 3
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0

    @property
    def drop_path_rates(self) -> np.ndarray:
        return np.linspace(0.0, self.drop_path_rate, self.depth)


def branch_masks(rate: float, batch: int, device,
                 generator: Optional[torch.Generator] = None) -> BranchMasks:
    """Stochastic-depth scale factors of one block's two residual branches:
    per sample Bernoulli(1 - rate) / (1 - rate); all ones, with no draw,
    when the rate is 0 (the semantics of ``mixste.py:264-277``, with torch's
    generator instead of a JAX key)."""
    if rate <= 0.0:
        ones = torch.ones(batch, dtype=torch.float32, device=device)
        return ones, ones
    keep = 1.0 - rate
    m1 = (torch.rand(batch, generator=generator, device=device) < keep).float()
    m2 = (torch.rand(batch, generator=generator, device=device) < keep).float()
    return m1 / keep, m2 / keep


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) diffusion steps -> (B, dim) sin/cos embedding."""
    half = dim // 2
    freq = math.log(10000.0) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                    * -freq)
    emb = t.float()[:, None] * emb[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    """``time_mlp.0`` of the reference: the parameter-free step embedding."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_time_embedding(t, self.dim)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-LN transformer block; its forward is ``ops.block.fused_block``."""

    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def params(self):
        """The 12 block tensors the fused block functions take, in order."""
        return (self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight, self.attn.qkv.bias,
                self.attn.proj.weight, self.attn.proj.bias,
                self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias)


def unfused_block(x: torch.Tensor, block_params: Sequence[torch.Tensor],
                  outer_norm: Sequence[torch.Tensor], num_heads: int,
                  attention_fn) -> torch.Tensor:
    """The block with the fused-block kernel off, as the JAX package runs it
    (``mixste.py:_block`` followed by the outer ``_layernorm``): LN1 ->
    ``attention_fn`` -> +residual -> LN2 -> fc1 -> exact GELU -> fc2 ->
    +residual -> outer Spatial/Temporal LN, LayerNorms with eps 1e-6.
    Float32; x: (B, L, C), parameters as ``fused_block`` takes them."""
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2,
     bfc2) = block_params
    C = x.shape[-1]
    h = F.layer_norm(x, (C,), n1s, n1b, 1e-6)
    x = x + attention_fn(h, wqkv, bqkv, wproj, bproj, num_heads)
    h = F.layer_norm(x, (C,), n2s, n2b, 1e-6)
    x = x + F.linear(F.gelu(F.linear(h, wfc1, bfc1)), wfc2, bfc2)
    return F.layer_norm(x, (C,), outer_norm[0], outer_norm[1], 1e-6)


def _require_experimental(mode: str, experimental_kernels: bool) -> None:
    """The counterpart of the JAX package's ``require_experimental``."""
    if not experimental_kernels:
        raise ValueError(
            f"use_pallas={mode} is an EXPERIMENTAL path (a retained "
            "negative-result A/B variant of the JAX package), not a supported "
            "execution path. Set gpu.experimental_kernels=true (CLI) or pass "
            "experimental_kernels=True to run it anyway.")


def select_block_fn(use_pallas="auto", experimental_kernels: bool = False):
    """The eval-mode block function for ``use_pallas`` (the JAX package's
    ``tpu.use_pallas`` values; booleans as a config parser gives them):

    * ``auto``/``block``: ``fused_block``, kernel #1;
    * ``true``: :func:`unfused_block` with ``fused_attention``, kernel #2;
    * ``false``: :func:`unfused_block` with ``attention_reference``, the
      plain block that mirrors the JAX package's XLA path;
    * ``block_t``: ``fused_block``, which then runs the spatial blocks (the
      temporal ones go to :func:`select_block_t_fn`'s kernel #3);
    * ``layer``: :func:`unfused_block` with ``fused_attention``, the JAX
      package's ``block_fn``/``attention_fn`` pair for ``layer``, which
      :func:`select_layer_fn`'s kernel #4 leaves no block to run.

    ``block_t`` and ``layer`` raise ``ValueError`` unless
    ``experimental_kernels`` opens the gate."""
    mode = str(use_pallas).lower()
    if mode in ("block_t", "layer"):
        _require_experimental(mode, experimental_kernels)
    if mode in ("auto", "block", "block_t"):
        return fused_block
    if mode in ("true", "layer"):
        return functools.partial(unfused_block, attention_fn=fused_attention)
    if mode == "false":
        return functools.partial(unfused_block,
                                 attention_fn=attention_reference)
    raise ValueError(f"use_pallas={use_pallas!r}: expected auto, block, "
                     "true, false, block_t or layer")


def select_block_t_fn(use_pallas="auto", experimental_kernels: bool = False):
    """``fused_block_temporal`` (kernel #3) for every temporal block at
    ``use_pallas=block_t`` (behind the gate), else None."""
    mode = str(use_pallas).lower()
    if mode != "block_t":
        return None
    _require_experimental(mode, experimental_kernels)
    return fused_block_temporal


def select_layer_fn(use_pallas="auto", experimental_kernels: bool = False):
    """``fused_layer`` (kernel #4) for every layer at ``use_pallas=layer``
    (behind the gate), else None."""
    mode = str(use_pallas).lower()
    if mode != "layer":
        return None
    _require_experimental(mode, experimental_kernels)
    return fused_layer


def init_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    """torch's default Linear init, U(-1/sqrt(in), 1/sqrt(in)), drawn from
    ``generator``."""
    bound = 1.0 / math.sqrt(lin.in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)


class MixSTE2(nn.Module):
    """Denoise one window: (B,F,N,2) x (B,F,N,3) x (B,) -> (B,F,N,3).

    Weights are drawn on the CPU from ``generator`` (seed 0 when omitted),
    so a seed gives the same weights on every device, then moved to
    ``device`` once.  The module starts in eval mode; ``use_pallas`` and
    ``experimental_kernels`` select the eval-mode functions
    (:meth:`set_use_pallas`)."""

    def __init__(self, cfg: MixSTEConfig, device="cuda",
                 generator: torch.Generator | None = None,
                 use_pallas="auto", experimental_kernels: bool = False):
        super().__init__()
        self.cfg = cfg
        self.set_use_pallas(use_pallas, experimental_kernels)
        # every block goes through this in train mode; a check may swap in
        # block_train_plain
        self.train_block_fn = block_train
        C = cfg.embed_dim
        self.Spatial_patch_to_embedding = nn.Linear(cfg.in_chans, C)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, C))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_frames, C))
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(C), nn.Linear(C, 2 * C),
                                      nn.GELU(), nn.Linear(2 * C, C))
        self.STEblocks = nn.ModuleList(
            [Block(C, cfg.mlp_ratio) for _ in range(cfg.depth)])
        self.TTEblocks = nn.ModuleList(
            [Block(C, cfg.mlp_ratio) for _ in range(cfg.depth)])
        self.Spatial_norm = nn.LayerNorm(C, eps=1e-6)
        self.Temporal_norm = nn.LayerNorm(C, eps=1e-6)
        self.head = nn.Sequential(nn.LayerNorm(C), nn.Linear(C, cfg.out_dim))

        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, gen)
        self.to(resolve_device(device))
        self.eval()

    def set_use_pallas(self, use_pallas, experimental_kernels: bool = False):
        """Select the eval-mode functions as the JAX CLI selects them:
        ``block_fn`` (:func:`select_block_fn`), ``block_t_fn`` (kernel #3 at
        ``block_t``, else None) and ``layer_fn`` (kernel #4 at ``layer``,
        else None).  A check may also set the three attributes itself."""
        self.block_fn = select_block_fn(use_pallas, experimental_kernels)
        self.block_t_fn = select_block_t_fn(use_pallas, experimental_kernels)
        self.layer_fn = select_layer_fn(use_pallas, experimental_kernels)

    def _block(self, block: Block, norm: nn.LayerNorm, x: torch.Tensor,
               masks: Optional[BranchMasks]) -> torch.Tensor:
        """One block + outer norm over the -2 axis of (B, S, L, C); in train
        mode with the per-sample branch masks, repeated over S (the frames of
        a spatial block, the joints of a temporal one) like
        ``mixste.py:350, 380``."""
        B, S, L, C = x.shape
        xf = x.reshape(B * S, L, C)
        if self.training:
            m1, m2 = (m.repeat_interleave(S) for m in masks)
            y = self.train_block_fn(xf, m1, m2, block.params()
                                    + (norm.weight, norm.bias),
                                    self.cfg.num_heads)
        else:
            y = self.block_fn(xf, block.params(), (norm.weight, norm.bias),
                              self.cfg.num_heads)
        return y.view(B, S, L, C)

    def forward(self, x2d: torch.Tensor, x3d: torch.Tensor, t: torch.Tensor,
                masks: Optional[Sequence[BranchMasks]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode, ``masks`` gives each block's branch masks (2·depth
        pairs of (B,) tensors: layer i's spatial block at 2i, its temporal
        block at 2i+1); masks not given are drawn from ``generator``."""
        cfg = self.cfg
        if self.training:
            if cfg.drop_rate > 0.0 or cfg.attn_drop_rate > 0.0:
                raise NotImplementedError(
                    "MixSTE2: training with dropout > 0 is not ported (the "
                    "fused train block has no dropout; the JAX package then "
                    "runs XLA)")
            if masks is None:
                masks = [branch_masks(float(rate), x2d.shape[0], x2d.device,
                                      generator)
                         for rate in np.repeat(cfg.drop_path_rates, 2)]
            if len(masks) != 2 * cfg.depth:
                raise ValueError(f"MixSTE2: {len(masks)} mask pairs for "
                                 f"{2 * cfg.depth} blocks")
        else:
            masks = [None] * (2 * cfg.depth)
        x = self.Spatial_patch_to_embedding(torch.cat([x2d, x3d], dim=-1))
        x = x + self.Spatial_pos_embed[None]
        x = (x + self.time_mlp(t)[:, None, None, :]).contiguous()

        for i in range(cfg.depth):
            x = self._layer(i, x, masks[2 * i], masks[2 * i + 1])
        return self.head(x)

    def _layer(self, i: int, x: torch.Tensor,
               spatial_masks: Optional[BranchMasks],
               temporal_masks: Optional[BranchMasks]) -> torch.Tensor:
        """Layer i on (B, F, N, C): the spatial block, the temporal position
        embedding on layer 0, the temporal block (``mixste.py:342-413``).
        In eval mode ``layer_fn`` takes the whole layer and ``block_t_fn``
        the temporal block in place; otherwise the temporal block runs on
        the transposed (B, N, F, C) activation."""
        ste, tte = self.STEblocks[i], self.TTEblocks[i]
        heads = self.cfg.num_heads
        temporal_norm = (self.Temporal_norm.weight, self.Temporal_norm.bias)
        if self.layer_fn is not None and not self.training:
            return self.layer_fn(
                x, ste.params(),
                (self.Spatial_norm.weight, self.Spatial_norm.bias),
                tte.params(), temporal_norm, heads,
                tpe=self.Temporal_pos_embed[0] if i == 0 else None)
        # spatial: tokens = joints
        x = self._block(ste, self.Spatial_norm, x, spatial_masks)
        if i == 0:
            x = x + self.Temporal_pos_embed[:, :, None, :]
        # temporal: tokens = frames
        if self.block_t_fn is not None and not self.training:
            return self.block_t_fn(x, tte.params(), temporal_norm, heads)
        x = x.transpose(1, 2).contiguous()
        x = self._block(tte, self.Temporal_norm, x, temporal_masks)
        return x.transpose(1, 2).contiguous()
