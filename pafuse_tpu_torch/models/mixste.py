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
In train mode (``.train()``) the path is chosen as the JAX package chooses
it (``block_grad.select_train_block_fn``, ``mixste.py:326-332``), whatever
``use_pallas`` says: with ``train_kernel`` auto or true and no dropout,
every block goes through ``train_block_fn``, ``ops.block_train.block_train``
(kernels #5/#6), the differentiable block with stochastic-depth branch masks
(rates ``linspace(0, drop_path_rate, depth)``); with ``train_kernel=false``
or any dropout, every block is :func:`unfused_block` under
``torch.autograd`` with :func:`unfused_attention`, the same branch masks and
the dropout sites of the JAX model, and ``remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``).  The kernels run on the GPU and
their plain versions on the CPU.

Numerics: block, Spatial and Temporal norms use eps 1e-6, the head norm
torch's default 1e-5; GELU is exact.  ``compute_dtype`` (float32 or
bfloat16) is the activations' dtype, with the JAX model's rounding points:
a linear rounds its weight to the compute dtype, accumulates in float32,
adds the float32 bias and rounds once; LayerNorm statistics and affine run
in float32 and round back; residual and position-embedding adds run in the
compute dtype; the head's linear is float32 on the rounded activations, so
the model returns float32.  Parameters stay float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from pafuse_tpu_torch.ops.attention import fused_attention
from pafuse_tpu_torch.ops.block import fused_block
from pafuse_tpu_torch.ops.block_temporal import fused_block_temporal
from pafuse_tpu_torch.ops.block_train import select_train_block_fn
from pafuse_tpu_torch.ops.gemm import linear_reference
from pafuse_tpu_torch.ops.layer import fused_layer
from pafuse_tpu_torch.utils.device import resolve_device

#: per block, the (attention, MLP) branch masks, one value per sample
BranchMasks = Tuple[torch.Tensor, torch.Tensor]
#: per block, the keep masks (bool) of its dropout sites: "attn" on the
#: probabilities (B, H, L, L), "proj" after the projection, "fc1" after
#: the MLP's GELU and "fc2" after its second linear
BlockDropout = Dict[str, torch.Tensor]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(value) -> torch.dtype:
    """``gpu.compute_dtype`` (``float32`` | ``bfloat16``, or a torch dtype)
    as a torch dtype; any other value raises."""
    if isinstance(value, torch.dtype) and value in COMPUTE_DTYPES.values():
        return value
    if str(value) in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[str(value)]
    raise ValueError(f"compute_dtype={value!r}: expected float32 or bfloat16")


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
    def has_dropout(self) -> bool:
        return self.drop_rate > 0.0 or self.attn_drop_rate > 0.0

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


def _layernorm(x: torch.Tensor, weight, bias, eps: float = 1e-6
               ) -> torch.Tensor:
    """LayerNorm with float32 statistics and affine, back in x's dtype
    (``mixste.py:153-160``)."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias,
                        eps).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU computed in float32, back in x's dtype.  Below float32 it
    is ``jax.nn.gelu``'s ``0.5 x erfc(-x sqrt(1/2))`` with each operation
    rounded to x's dtype: sqrt(1/2), the erfc's argument, the erfc and the
    product."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    cd = x.dtype
    sqrt_half = float(torch.tensor(0.5 ** 0.5).to(cd))
    xf = x.float()
    erfc = torch.erfc((-xf * sqrt_half).to(cd).float()).to(cd).float()
    return (0.5 * xf * erfc).to(cd)


def _keep_prob(x: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep probability 1 - rate rounded to x's dtype, as a 0-dim
    tensor on x's device.  ``torch.full`` fills it on the device: a
    ``torch.tensor`` of a Python number would copy it from pageable host
    memory, which waits for every kernel queued before it."""
    return torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)


def _dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
             rate: float) -> torch.Tensor:
    """Inverted dropout as ``mixste.py:163-170``: kept elements divided by
    the keep probability in x's dtype, the rest zero; x unchanged at rate 0
    or without a mask."""
    if rate <= 0.0 or keep is None:
        return x
    return torch.where(keep, x / _keep_prob(x, rate), x.new_zeros(()))


def _drop_path(x: torch.Tensor, keep: Optional[torch.Tensor],
               rate: float) -> torch.Tensor:
    """Stochastic depth of a branch as ``mixste.py:217-224``: ``keep``
    (B,) is 1 for the sequences whose branch stays, which are divided by
    the keep probability in x's dtype; x unchanged at rate 0."""
    if rate <= 0.0 or keep is None:
        return x
    return (x * keep.to(x.dtype).view(-1, *([1] * (x.dim() - 1)))
            / _keep_prob(x, rate))


def unfused_attention(x: torch.Tensor, qkv_w: torch.Tensor,
                      qkv_b: torch.Tensor, proj_w: torch.Tensor,
                      proj_b: torch.Tensor, num_heads: int,
                      dropout: Optional[BlockDropout] = None,
                      rates: Tuple[float, float] = (0.0, 0.0)
                      ) -> torch.Tensor:
    """The model's own attention, ``mixste.py:_attention`` (``:173-204``),
    over the -2 axis of (..., L, C) in x's dtype: qkv rounded to it, the
    logits stored in it, the softmax in float32 and its probabilities
    rounded, the head outputs rounded before ``proj``.  In float32 every
    rounding is a no-op and this is ``ops.attention.attention_reference``.
    ``dropout`` gives the "attn" and "proj" keep masks, ``rates`` their
    (attention, projection) dropout rates."""
    cd = x.dtype
    *lead, L, C = x.shape
    d = C // num_heads
    drop = dropout or {}
    qkv = linear_reference(x.reshape(-1, L, C), qkv_w, qkv_b)
    q, k, v = qkv.view(-1, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    logits = (torch.matmul(q.float(), k.float().transpose(-1, -2))
              * d ** -0.5).to(cd)
    probs = torch.softmax(logits.float(), dim=-1).to(cd)
    probs = _dropout(probs, drop.get("attn"), rates[0])
    ao = torch.matmul(probs.float(), v.float()).to(cd)      # (B, H, L, d)
    ao = ao.transpose(1, 2).reshape(-1, L, C)
    out = _dropout(linear_reference(ao, proj_w, proj_b), drop.get("proj"),
                   rates[1])
    return out.reshape(*lead, L, C)


def unfused_block(x: torch.Tensor, block_params: Sequence[torch.Tensor],
                  outer_norm: Sequence[torch.Tensor], num_heads: int,
                  attention_fn, drop_path: Optional[tuple] = None,
                  dropout: Optional[BlockDropout] = None,
                  drop_rate: float = 0.0) -> torch.Tensor:
    """The block with the fused-block kernel off, as the JAX package runs it
    (``mixste.py:_block`` followed by the outer ``_layernorm``): LN1 ->
    ``attention_fn`` -> +residual -> LN2 -> fc1 -> exact GELU -> fc2 ->
    +residual -> outer Spatial/Temporal LN, LayerNorms with eps 1e-6, in
    x's dtype with the rounding points of the module docstring.  x: (B, L,
    C), parameters as ``fused_block`` takes them.

    Training extras (the autodiff path): ``drop_path`` = (attention keep,
    MLP keep, rate), each keep a (B,) mask of the sequences whose branch
    stays; ``dropout`` the keep masks of the MLP's two drops ("fc1",
    "fc2") at rate ``drop_rate``.  The attention's own dropout is
    ``attention_fn``'s (:func:`unfused_attention` with its masks, as
    ``mixste.py:232-240``)."""
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2,
     bfc2) = block_params
    keep1, keep2, rate = drop_path or (None, None, 0.0)
    drop = dropout or {}
    h = _layernorm(x, n1s, n1b)
    a = attention_fn(h, wqkv, bqkv, wproj, bproj, num_heads)
    x = x + _drop_path(a, keep1, rate)
    h = _gelu(linear_reference(_layernorm(x, n2s, n2b), wfc1, bfc1))
    h = _dropout(h, drop.get("fc1"), drop_rate)
    h = _dropout(linear_reference(h, wfc2, bfc2), drop.get("fc2"), drop_rate)
    x = x + _drop_path(h, keep2, rate)
    return _layernorm(x, *outer_norm)


def _require_experimental(name: str, experimental_kernels: bool) -> None:
    """The counterpart of the JAX package's ``require_experimental``:
    ``name`` (``use_pallas=block_t``, ``D3DP(packed_parts=True)``) raises
    unless ``experimental_kernels`` opens the gate."""
    if not experimental_kernels:
        raise ValueError(
            f"{name} is an EXPERIMENTAL path (a retained "
            "negative-result A/B variant of the JAX package), not a supported "
            "execution path. Set gpu.experimental_kernels=true (CLI) or pass "
            "experimental_kernels=True to run it anyway.")


def select_block_fn(use_pallas="auto", experimental_kernels: bool = False):
    """The eval-mode block function for ``use_pallas`` (the JAX package's
    ``tpu.use_pallas`` values; booleans as a config parser gives them):

    * ``auto``/``block``: ``fused_block``, kernel #1;
    * ``true``: :func:`unfused_block` with ``fused_attention``, kernel #2;
    * ``false``: :func:`unfused_block` with :func:`unfused_attention`,
      the plain block that mirrors the JAX package's XLA path;
    * ``block_t``: ``fused_block``, which then runs the spatial blocks (the
      temporal ones go to :func:`select_block_t_fn`'s kernel #3);
    * ``layer``: :func:`unfused_block` with ``fused_attention``, the JAX
      package's ``block_fn``/``attention_fn`` pair for ``layer``, which
      :func:`select_layer_fn`'s kernel #4 leaves no block to run.

    ``block_t`` and ``layer`` raise ``ValueError`` unless
    ``experimental_kernels`` opens the gate."""
    mode = str(use_pallas).lower()
    if mode in ("block_t", "layer"):
        _require_experimental(f"use_pallas={mode}", experimental_kernels)
    if mode in ("auto", "block", "block_t"):
        return fused_block
    if mode in ("true", "layer"):
        return functools.partial(unfused_block, attention_fn=fused_attention)
    if mode == "false":
        return functools.partial(unfused_block,
                                 attention_fn=unfused_attention)
    raise ValueError(f"use_pallas={use_pallas!r}: expected auto, block, "
                     "true, false, block_t or layer")


def select_block_t_fn(use_pallas="auto", experimental_kernels: bool = False):
    """``fused_block_temporal`` (kernel #3) for every temporal block at
    ``use_pallas=block_t`` (behind the gate), else None."""
    mode = str(use_pallas).lower()
    if mode != "block_t":
        return None
    _require_experimental(f"use_pallas={mode}", experimental_kernels)
    return fused_block_temporal


def select_layer_fn(use_pallas="auto", experimental_kernels: bool = False):
    """``fused_layer`` (kernel #4) for every layer at ``use_pallas=layer``
    (behind the gate), else None."""
    mode = str(use_pallas).lower()
    if mode != "layer":
        return None
    _require_experimental(f"use_pallas={mode}", experimental_kernels)
    return fused_layer


def init_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    """torch's default Linear init, U(-1/sqrt(in), 1/sqrt(in)), drawn from
    ``generator``."""
    bound = 1.0 / math.sqrt(lin.in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)


def draw_dropout_masks(cfg: MixSTEConfig, batch: int, device,
                       generator: Optional[torch.Generator] = None) -> dict:
    """Keep masks of every dropout site of one training forward, drawn from
    ``generator`` (keep with probability 1 - rate): {"pos": [after the
    embeddings, after layer 0's temporal position embedding] (B, F, N, C),
    "blocks": 2·depth dicts (layer i's spatial block at 2i, its temporal
    block at 2i+1) of "attn" (B·S, H, L, L, only with ``attn_drop_rate``),
    "proj", "fc1", "fc2" (B·S, L, width)} with (S, L) = (F, N) for a
    spatial block and (N, F) for a temporal one: the sites and shapes of
    ``mixste.py:313-321, 412`` and ``:195-214``."""
    B, F_, N, C, H = (batch, cfg.num_frames, cfg.num_joints, cfg.embed_dim,
                      cfg.num_heads)
    hidden = int(C * cfg.mlp_ratio)

    def keep(shape, rate):
        if rate <= 0.0:
            return None
        return torch.rand(shape, generator=generator, device=device) >= rate

    pos = [keep((B, F_, N, C), cfg.drop_rate) for _ in range(2)]
    blocks = []
    for _ in range(cfg.depth):
        for S, L in ((F_, N), (N, F_)):
            blocks.append({
                "attn": keep((B * S, H, L, L), cfg.attn_drop_rate),
                "proj": keep((B * S, L, C), cfg.drop_rate),
                "fc1": keep((B * S, L, hidden), cfg.drop_rate),
                "fc2": keep((B * S, L, C), cfg.drop_rate)})
    return {"pos": pos, "blocks": blocks}


class MixSTE2(nn.Module):
    """Denoise one window: (B,F,N,2) x (B,F,N,3) x (B,) -> (B,F,N,3).

    Weights are drawn on the CPU from ``generator`` (seed 0 when omitted),
    so a seed gives the same weights on every device, then moved to
    ``device`` once.  The module starts in eval mode; ``use_pallas`` and
    ``experimental_kernels`` select the eval-mode functions
    (:meth:`set_use_pallas`), ``train_kernel`` the training path
    (``select_train_block_fn``), ``compute_dtype`` the activations' dtype
    and ``remat`` whether the autodiff path recomputes each layer in the
    backward."""

    def __init__(self, cfg: MixSTEConfig, device="cuda",
                 generator: torch.Generator | None = None,
                 use_pallas="auto", experimental_kernels: bool = False,
                 compute_dtype=torch.float32, train_kernel="auto",
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.remat = bool(remat)
        self.set_use_pallas(use_pallas, experimental_kernels)
        # every block goes through this in train mode unless the autodiff
        # path is chosen (None); a check may swap in block_train_plain
        self.train_block_fn = select_train_block_fn(train_kernel)
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

    @property
    def train_path(self) -> str:
        """The training path: "kernels" (#5/#6 through ``train_block_fn``)
        or "autodiff" (``train_kernel=false``, or any dropout, which the
        kernels do not take)."""
        if self.train_block_fn is None or self.cfg.has_dropout:
            return "autodiff"
        return "kernels"

    def _block(self, i: int, block: Block, norm: nn.LayerNorm,
               x: torch.Tensor, masks: Optional[BranchMasks],
               dropout: Optional[BlockDropout]) -> torch.Tensor:
        """Block i of its kind + outer norm over the -2 axis of (B, S, L, C);
        in train mode with the per-sample branch masks, repeated over S (the
        frames of a spatial block, the joints of a temporal one) like
        ``mixste.py:350, 380``."""
        B, S, L, C = x.shape
        xf = x.reshape(B * S, L, C)
        outer = (norm.weight, norm.bias)
        if not self.training:
            y = self.block_fn(xf, block.params(), outer, self.cfg.num_heads)
        elif self.train_path == "kernels":
            m1, m2 = (m.repeat_interleave(S) for m in masks)
            y = self.train_block_fn(xf, m1, m2, block.params() + outer,
                                    self.cfg.num_heads)
        else:
            cfg = self.cfg
            keep1, keep2 = ((m != 0).repeat_interleave(S) for m in masks)
            attention = functools.partial(
                unfused_attention, dropout=dropout,
                rates=(cfg.attn_drop_rate, cfg.drop_rate))
            y = unfused_block(xf, block.params(), outer, cfg.num_heads,
                              attention,
                              (keep1, keep2, float(cfg.drop_path_rates[i])),
                              dropout, cfg.drop_rate)
        return y.view(B, S, L, C)

    def forward(self, x2d: torch.Tensor, x3d: torch.Tensor, t: torch.Tensor,
                masks: Optional[Sequence[BranchMasks]] = None,
                dropout_masks: Optional[dict] = None) -> torch.Tensor:
        """In train mode, ``masks`` gives each block's branch masks (2·depth
        pairs of (B,) tensors, 0 or 1/keep at the block's rate: layer i's
        spatial block at 2i, its temporal block at 2i+1) and, with dropout,
        ``dropout_masks`` the dropout keep masks
        (:func:`draw_dropout_masks`'s layout).  Both are drawn by the
        caller (``diffusion.D3DP.draw_train``)."""
        cfg = self.cfg
        cd = self.compute_dtype
        drop = None
        if self.training:
            if masks is None or len(masks) != 2 * cfg.depth:
                raise ValueError(
                    f"MixSTE2: train mode needs {2 * cfg.depth} mask pairs, "
                    f"got {None if masks is None else len(masks)}")
            if cfg.has_dropout:
                if dropout_masks is None:
                    raise ValueError("MixSTE2: train mode with dropout needs "
                                     "dropout_masks")
                drop = dropout_masks
        else:
            masks = [None] * (2 * cfg.depth)
        blocks = drop["blocks"] if drop else [None] * (2 * cfg.depth)
        pos = drop["pos"] if drop else [None, None]

        emb = self.Spatial_patch_to_embedding
        x = linear_reference(torch.cat([x2d, x3d], dim=-1).to(cd), emb.weight,
                             emb.bias)
        x = x + self.Spatial_pos_embed[None].to(cd)
        fc1, fc2 = self.time_mlp[1], self.time_mlp[3]
        te = sinusoidal_time_embedding(t, cfg.embed_dim).to(cd)
        te = _gelu(linear_reference(te, fc1.weight, fc1.bias))
        te = linear_reference(te, fc2.weight, fc2.bias)
        x = (x + te[:, None, None, :]).contiguous()
        x = _dropout(x, pos[0], cfg.drop_rate)

        remat = self.remat and self.training and self.train_path == "autodiff"
        for i in range(cfg.depth):
            args = (i, x, masks[2 * i], masks[2 * i + 1], blocks[2 * i],
                    blocks[2 * i + 1], pos[1])
            x = (torch.utils.checkpoint.checkpoint(self._layer, *args,
                                                   use_reentrant=False)
                 if remat else self._layer(*args))
        head_norm, head_fc = self.head
        x = _layernorm(x, head_norm.weight, head_norm.bias, head_norm.eps)
        return F.linear(x.float(), head_fc.weight, head_fc.bias)

    def _layer(self, i: int, x: torch.Tensor,
               spatial_masks: Optional[BranchMasks],
               temporal_masks: Optional[BranchMasks],
               spatial_drop: Optional[BlockDropout] = None,
               temporal_drop: Optional[BlockDropout] = None,
               pos_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Layer i on (B, F, N, C): the spatial block, the temporal position
        embedding (then ``pos_drop``) on layer 0, the temporal block
        (``mixste.py:342-413``).  In eval mode ``layer_fn`` takes the whole
        layer and ``block_t_fn`` the temporal block in place; otherwise the
        temporal block runs on the transposed (B, N, F, C) activation."""
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
        x = self._block(i, ste, self.Spatial_norm, x, spatial_masks,
                        spatial_drop)
        if i == 0:
            x = x + self.Temporal_pos_embed[:, :, None, :].to(x.dtype)
            x = _dropout(x, pos_drop, self.cfg.drop_rate)
        # temporal: tokens = frames
        if self.block_t_fn is not None and not self.training:
            return self.block_t_fn(x, tte.params(), temporal_norm, heads)
        x = x.transpose(1, 2).contiguous()
        x = self._block(i, tte, self.Temporal_norm, x, temporal_masks,
                        temporal_drop)
        return x.transpose(1, 2).contiguous()
