"""MixSTE2 spatio-temporal transformer denoiser (eval forward).

Counterpart of ``pafuse_tpu/models/mixste.py``.  Submodules carry the
reference PAFUSE names (``STEblocks.3.attn.qkv``, ``time_mlp.1``,
``head.0`` ...), so a reference-named state dict, stripped of its
``pose_estimator.{part}.`` prefix, loads with ``strict=True``.

Every spatial and temporal block, together with its outer Spatial/Temporal
LayerNorm, goes through ``block_fn`` (``ops.block.fused_block`` by default:
the CUDA kernel on the GPU, the plain version on the CPU).

Numerics (float32): block, Spatial and Temporal norms use eps 1e-6, the
head norm torch's default 1e-5; GELU is exact.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from pafuse_tpu_torch.ops.block import fused_block
from pafuse_tpu_torch.utils.device import resolve_device


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
        """The 12 tensors ``fused_block`` takes, in its order."""
        return (self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight, self.attn.qkv.bias,
                self.attn.proj.weight, self.attn.proj.bias,
                self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias)


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
    ``device`` once."""

    def __init__(self, cfg: MixSTEConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        # every block goes through this; a check may swap in block_reference
        self.block_fn = fused_block
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

    def _block(self, block: Block, norm: nn.LayerNorm,
               x: torch.Tensor) -> torch.Tensor:
        """One block + outer norm over the -2 axis of (B, S, L, C)."""
        B, S, L, C = x.shape
        y = self.block_fn(x.reshape(B * S, L, C), block.params(),
                          (norm.weight, norm.bias), self.cfg.num_heads)
        return y.view(B, S, L, C)

    def forward(self, x2d: torch.Tensor, x3d: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        x = self.Spatial_patch_to_embedding(torch.cat([x2d, x3d], dim=-1))
        x = x + self.Spatial_pos_embed[None]
        x = (x + self.time_mlp(t)[:, None, None, :]).contiguous()

        for i in range(self.cfg.depth):
            # spatial: tokens = joints
            x = self._block(self.STEblocks[i], self.Spatial_norm, x)
            if i == 0:
                x = x + self.Temporal_pos_embed[:, :, None, :]
            # temporal: tokens = frames
            x = x.transpose(1, 2).contiguous()
            x = self._block(self.TTEblocks[i], self.Temporal_norm, x)
            x = x.transpose(1, 2).contiguous()

        return self.head(x)
