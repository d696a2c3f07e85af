"""Packed-parts execution: the part networks as one batched call.

Counterpart of ``pafuse_tpu/models/packed.py``.  Every part network is
padded to a common ``(J_max, C_max)`` (68 joints, 384 channels for the H3WB
parts), its parameters are stacked on a leading part axis, and one forward
runs over that axis, so each linear of a layer is one batched product
(``torch.bmm``) for all parts.  It is reached through
``PartModel(packed=True)`` in eval mode (``D3DP(packed_parts=True)``,
behind the experimental gate), and it runs no hand-written kernel: the JAX
package's packed path runs no Pallas kernel either.

Exactness, as in the JAX package (the unpacked path within 1e-5 in
float32):

* channel padding: weights, biases and LayerNorm parameters are
  zero-padded, so padded channels stay exactly zero through the linears,
  GELU and the residual adds;
* masked LayerNorm: the statistics cover the part's real ``C_p`` channels
  only, in closed form from full-width sums (which rests on the padded
  channels being zero): ``mean = S1 / C_p``, ``var = (sum((x - mean)^2) -
  (C_max - C_p) mean^2) / C_p``;
* per-head qkv packing: a part's head size is ``C_p / heads``, so qkv
  columns are placed per (section, head) slot and never mix two heads; the
  softmax scale ``d_p**-0.5`` is folded into the q columns in the
  parameters' float32 (then rounded to the compute dtype by the linear, as
  the JAX ``_linear`` rounds its kernel);
* masked softmax: padded joint tokens take non-zero k/v from the qkv bias,
  so spatial logits add ``-1e30`` at padded key columns (frames are never
  padded, so temporal attention needs no mask);
* per-part sinusoidal time embedding: each part keeps its own zero-padded
  frequency table, and the time MLP's first kernel is packed per sin/cos
  half.

Padded tokens' outputs are dropped by the final whole-body gather.

Parameters are packed from the part networks' modules (torch ``Linear``
weights are (out, in); the packed tree holds kernels (in, out), the JAX
orientation, so the JAX packing code carries over line for line).  The
compute dtype's rounding points are the JAX module's: a linear rounds its
input and kernel, accumulates in float32, adds the float32 bias and rounds;
the logits are float32 plus the mask, rounded, then softmax in float32 and
rounded; LayerNorm in float32; the head's linear in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from pafuse_tpu_torch.models.mixste import _gelu

#: the plan's tables that :func:`plan_tables` puts on the device
TABLES = ("joint_gather", "out_gather", "freqs", "key_mask", "c_real")


@dataclasses.dataclass(frozen=True)
class PackPlan:
    names: tuple                 # part order
    j_max: int
    c_max: int
    num_heads: int
    depth: int
    num_frames: int
    in_chans: int
    c_real: np.ndarray           # (P,) real channel widths
    j_real: np.ndarray           # (P,) real joint counts
    joint_gather: np.ndarray     # (P, j_max) whole-body indices (clamped)
    out_gather: np.ndarray       # (num_joints,) indices into (P*j_max)
    freqs: np.ndarray            # (P, c_max//2) sinusoidal freq tables
    key_mask: np.ndarray         # (P, 1, j_max) additive logits mask


def make_pack_plan(specs) -> PackPlan:
    """The static plan of ``specs`` (``models.parts.PartSpec``s sharing
    heads, depth, frames and an MLP ratio of 2)."""
    P = len(specs)
    j_max = max(len(s.joint_indices) for s in specs)
    c_max = max(s.config.embed_dim for s in specs)
    heads = specs[0].config.num_heads
    if any(s.config.num_heads != heads or s.config.mlp_ratio != 2.0
           for s in specs):
        raise ValueError("packed parts need one head count and mlp_ratio 2")

    c_real = np.array([s.config.embed_dim for s in specs], np.int32)
    j_real = np.array([len(s.joint_indices) for s in specs], np.int32)
    joint_gather = np.zeros((P, j_max), np.int32)
    for p, s in enumerate(specs):
        idx = np.asarray(s.joint_indices)
        joint_gather[p, :len(idx)] = idx           # padded slots read joint 0

    num_joints = int(max(s.joint_indices.max() for s in specs)) + 1
    out_gather = np.zeros((num_joints,), np.int32)
    for p, s in enumerate(specs):
        for i, g in enumerate(np.asarray(s.joint_indices)):
            out_gather[g] = p * j_max + i

    freqs = np.zeros((P, c_max // 2), np.float32)
    for p, s in enumerate(specs):
        half = s.config.embed_dim // 2
        f = math.log(10000.0) / (half - 1)
        freqs[p, :half] = np.exp(np.arange(half, dtype=np.float32) * -f)

    key_mask = np.zeros((P, 1, j_max), np.float32)
    for p, s in enumerate(specs):
        key_mask[p, 0, len(s.joint_indices):] = -1e30

    return PackPlan(names=tuple(s.name for s in specs), j_max=j_max,
                    c_max=c_max, num_heads=heads, depth=specs[0].config.depth,
                    num_frames=specs[0].config.num_frames,
                    in_chans=specs[0].config.in_chans, c_real=c_real,
                    j_real=j_real, joint_gather=joint_gather,
                    out_gather=out_gather, freqs=freqs, key_mask=key_mask)


def plan_tables(plan: PackPlan, device) -> Dict[str, torch.Tensor]:
    """The plan's index and mask tables as tensors on ``device`` (indices
    int64, the rest float32).  Copied from the host: make them once, not
    per call (``PartModel`` holds them as buffers)."""
    return {name: torch.as_tensor(getattr(plan, name), device=device).to(
        torch.long if name.endswith("gather") else torch.float32)
        for name in TABLES}


# ---------------------------------------------------------------------------
# Parameter packing (padding and reshapes on the parameters' device)
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    pads = []
    for s, t in reversed(list(zip(x.shape, shape))):
        pads += [0, t - s]
    return F.pad(x, pads) if any(pads) else x


def _kernel(linear) -> torch.Tensor:
    """A torch Linear's weight as the JAX kernel (in, out)."""
    return linear.weight.detach().t()


def _ln(norm, c_max: int) -> Dict[str, torch.Tensor]:
    return {"scale": _pad_to(norm.weight.detach(), (c_max,)),
            "bias": _pad_to(norm.bias.detach(), (c_max,))}


def _pack_qkv(kernel, bias, c_p: int, heads: int, c_max: int,
              scale_q: float):
    """(C_p, 3C_p) -> (C_max, 3C_max) with per-(section, head) placement;
    the softmax scale is folded into the q columns (in float32, the
    parameters' dtype, as JAX multiplies by a float32 scale array)."""
    d_p, d_max = c_p // heads, c_max // heads
    k4 = kernel.reshape(c_p, 3, heads, d_p)
    k4 = torch.cat([k4[:, :1] * scale_q, k4[:, 1:]], dim=1)
    k4 = _pad_to(k4, (c_max, 3, heads, d_max))
    b4 = bias.reshape(3, heads, d_p)
    b4 = torch.cat([b4[:1] * scale_q, b4[1:]], dim=0)
    b4 = _pad_to(b4, (3, heads, d_max))
    return k4.reshape(c_max, 3 * c_max), b4.reshape(3 * c_max)


def _pack_proj(kernel, bias, c_p: int, heads: int, c_max: int):
    """(C_p, C_p) with per-head input rows -> (C_max, C_max)."""
    d_p, d_max = c_p // heads, c_max // heads
    k3 = _pad_to(kernel.reshape(heads, d_p, c_p), (heads, d_max, c_max))
    return k3.reshape(c_max, c_max), _pad_to(bias, (c_max,))


def _pack_block(block, c_p: int, heads: int, c_max: int):
    qkv, proj = block.attn.qkv, block.attn.proj
    qkv_k, qkv_b = _pack_qkv(_kernel(qkv), qkv.bias.detach(), c_p, heads,
                             c_max, (c_p // heads) ** -0.5)
    proj_k, proj_b = _pack_proj(_kernel(proj), proj.bias.detach(), c_p,
                                heads, c_max)
    fc1, fc2 = block.mlp.fc1, block.mlp.fc2
    return {
        "norm1": _ln(block.norm1, c_max),
        "attn": {"qkv": {"kernel": qkv_k, "bias": qkv_b},
                 "proj": {"kernel": proj_k, "bias": proj_b}},
        "norm2": _ln(block.norm2, c_max),
        "mlp": {
            "fc1": {"kernel": _pad_to(_kernel(fc1), (c_max, 2 * c_max)),
                    "bias": _pad_to(fc1.bias.detach(), (2 * c_max,))},
            "fc2": {"kernel": _pad_to(_kernel(fc2), (2 * c_max, c_max)),
                    "bias": _pad_to(fc2.bias.detach(), (c_max,))},
        },
    }


def _pack_time_mlp(fc1, fc2, c_p: int, c_max: int):
    half_p, half_max = c_p // 2, c_max // 2
    k1 = _kernel(fc1).reshape(2, half_p, 2 * c_p)
    k1 = _pad_to(k1, (2, half_max, 2 * c_max)).reshape(c_max, 2 * c_max)
    return {
        "fc1": {"kernel": k1,
                "bias": _pad_to(fc1.bias.detach(), (2 * c_max,))},
        "fc2": {"kernel": _pad_to(_kernel(fc2), (2 * c_max, c_max)),
                "bias": _pad_to(fc2.bias.detach(), (c_max,))},
    }


def _pack_one(net, c_p: int, plan: PackPlan):
    """One ``MixSTE2``'s parameters padded to the plan's widths."""
    c_max, j_max, heads = plan.c_max, plan.j_max, plan.num_heads
    emb = net.Spatial_patch_to_embedding
    head_norm, head_fc = net.head
    return {
        "Spatial_patch_to_embedding": {
            "kernel": _pad_to(_kernel(emb), (plan.in_chans, c_max)),
            "bias": _pad_to(emb.bias.detach(), (c_max,))},
        "Spatial_pos_embed": _pad_to(net.Spatial_pos_embed.detach(),
                                     (1, j_max, c_max)),
        "Temporal_pos_embed": _pad_to(net.Temporal_pos_embed.detach(),
                                      (1, plan.num_frames, c_max)),
        "time_mlp": _pack_time_mlp(net.time_mlp[1], net.time_mlp[3], c_p,
                                   c_max),
        "STEblocks": [_pack_block(b, c_p, heads, c_max)
                      for b in net.STEblocks],
        "TTEblocks": [_pack_block(b, c_p, heads, c_max)
                      for b in net.TTEblocks],
        "Spatial_norm": _ln(net.Spatial_norm, c_max),
        "Temporal_norm": _ln(net.Temporal_norm, c_max),
        "head": {"norm": _ln(head_norm, c_max),
                 "fc": {"kernel": _pad_to(_kernel(head_fc), (c_max, 3)),
                        "bias": head_fc.bias.detach()}},
    }


def _stack(trees: List[Any]):
    """Trees of one structure -> one tree, leaves stacked on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees, 0)


def pack_params(parts: Mapping[str, torch.nn.Module], plan: PackPlan,
                tables: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The part networks ``parts`` ({name: MixSTE2}, in the plan's order)
    as one tree with a leading part axis on every leaf, plus the plan's
    device ``tables`` (:func:`plan_tables`) under ``"tables"``."""
    packed = [_pack_one(parts[name], int(c), plan)
              for name, c in zip(plan.names, plan.c_real)]
    return {**_stack(packed), "tables": tables}


# ---------------------------------------------------------------------------
# Packed forward (the part axis leads every activation)
# ---------------------------------------------------------------------------

def _linear(p, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """(P, ..., in) x stacked kernels (P, in, out): x and the kernel
    rounded to ``cd``, a float32 product, + the float32 bias, rounded."""
    P, k_in = x.shape[0], x.shape[-1]
    w = p["kernel"].to(cd).float()
    y = torch.bmm(x.to(cd).float().reshape(P, -1, k_in), w)
    y = y + p["bias"].float()[:, None, :]
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(cd)


def _per_part(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(P, ...) -> (P, 1, ..., 1, last) broadcasting over an ``ndim``-dim
    activation whose last axis is v's last."""
    return v.reshape(v.shape[0], *([1] * (ndim - 2)), v.shape[-1])


def _masked_layernorm(p, x: torch.Tensor, c_p: torch.Tensor, c_max: int,
                      eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over each part's real channels only (``c_p`` (P,) float32);
    padded channels are zero on entry and zeroed again by the zero-padded
    scale and bias."""
    xf = x.float()
    cp = c_p.reshape(-1, *([1] * (x.dim() - 1)))
    mean = xf.sum(-1, keepdim=True) / cp
    sq = (xf - mean).square().sum(-1, keepdim=True)
    var = (sq - (c_max - cp) * mean.square()) / cp
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * _per_part(p["scale"], x.dim()) + _per_part(p["bias"], x.dim())
    return y.to(x.dtype)


def _packed_attention(p, x: torch.Tensor, heads: int, cd: torch.dtype,
                      key_mask=None) -> torch.Tensor:
    """Attention over the -2 axis of (P, ..., L, C); the scale is folded
    into the packed q; ``key_mask`` (P, 1, L) is added to the logits."""
    P, L, C = x.shape[0], x.shape[-2], x.shape[-1]
    d = C // heads
    qkv = _linear(p["qkv"], x, cd).reshape(P, -1, L, 3, heads, d)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)           # (P, N, H, L, d)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if key_mask is not None:
        attn = attn + key_mask[:, None, None]          # (P, 1, 1, 1, L)
    attn = torch.softmax(attn.to(cd).float(), dim=-1).to(cd)
    out = torch.matmul(attn.float(), v.float()).to(cd)
    out = out.transpose(2, 3).reshape(x.shape)
    return _linear(p["proj"], out, cd)


def _packed_block(p, x, heads, cd, c_p, c_max, key_mask=None):
    x = x + _packed_attention(p["attn"],
                              _masked_layernorm(p["norm1"], x, c_p, c_max),
                              heads, cd, key_mask)
    h = _gelu(_linear(p["mlp"]["fc1"],
                      _masked_layernorm(p["norm2"], x, c_p, c_max), cd))
    return x + _linear(p["mlp"]["fc2"], h, cd)


def packed_forward(packed: Dict[str, Any], plan: PackPlan, x2d: torch.Tensor,
                   x3d: torch.Tensor, t: torch.Tensor, *,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """All parts in one batched call: (B, F, N, 2) x (B, F, N, 3) x (B,)
    -> (B, F, N, 3) float32.  ``packed``: :func:`pack_params`'s tree."""
    cd = compute_dtype
    tab = packed["tables"]
    c_p, c_max, heads = tab["c_real"], plan.c_max, plan.num_heads
    P, J = tab["joint_gather"].shape
    B, F_ = x2d.shape[:2]

    def parts_first(a):                              # -> (P, B, F, J, c)
        a = a.index_select(-2, tab["joint_gather"].reshape(-1))
        return a.reshape(B, F_, P, J, a.shape[-1]).permute(2, 0, 1, 3, 4)

    x = torch.cat([parts_first(x2d), parts_first(x3d)], dim=-1).to(cd)
    x = _linear(packed["Spatial_patch_to_embedding"], x, cd)
    x = x + packed["Spatial_pos_embed"][:, None].to(cd)

    ang = t.float()[None, :, None] * tab["freqs"][:, None, :]   # (P, B, C/2)
    te = torch.cat([ang.sin(), ang.cos()], dim=-1).to(cd)
    te = _gelu(_linear(packed["time_mlp"]["fc1"], te, cd))
    te = _linear(packed["time_mlp"]["fc2"], te, cd)
    x = x + te[:, :, None, None, :]

    key_mask = tab["key_mask"]
    for i in range(plan.depth):
        x = _packed_block(packed["STEblocks"][i], x, heads, cd, c_p, c_max,
                          key_mask)
        x = _masked_layernorm(packed["Spatial_norm"], x, c_p, c_max)
        if i == 0:
            x = x + packed["Temporal_pos_embed"][:, :, :, None, :].to(cd)
        x = x.transpose(2, 3)                        # frames are the tokens
        x = _packed_block(packed["TTEblocks"][i], x, heads, cd, c_p, c_max)
        x = _masked_layernorm(packed["Temporal_norm"], x, c_p, c_max)
        x = x.transpose(2, 3)

    x = _masked_layernorm(packed["head"]["norm"], x, c_p, c_max, eps=1e-5)
    out = _linear(packed["head"]["fc"], x, torch.float32)   # (P,B,F,J,3)
    out = out.permute(1, 2, 0, 3, 4).reshape(B, F_, P * J, 3)
    return out.index_select(-2, tab["out_gather"])
