"""Part-based denoiser routing: one MixSTE2 per body part.

Counterpart of ``pafuse_tpu/models/parts.py``.  Unpacked execution (the
default): each part network sees a static gather of its joints, and the
outputs are concatenated back in whole-body joint order (an inverse
permutation covers part tables that are not contiguous and ordered).  In
train mode each part network takes its own stochastic-depth masks, as the
JAX router gives each part its own key.  Packed execution (``packed=True``
with more than one part, eval mode only): the parts padded to one width and
run as one batched call (:mod:`pafuse_tpu_torch.models.packed`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from pafuse_tpu_torch.models import packed as pk
from pafuse_tpu_torch.models.mixste import MixSTE2, MixSTEConfig
from pafuse_tpu_torch.utils.device import resolve_device

#: per-part embedding widths
PART_CHANNELS = {"body": 384, "face": 224, "hands": 256,
                 "left_hand": 256, "right_hand": 256}


@dataclasses.dataclass(frozen=True)
class PartSpec:
    name: str
    joint_indices: np.ndarray       # indices into the whole-body joint axis
    config: MixSTEConfig


def build_part_specs(parts_joint_indices: Dict[str, List[int]],
                     num_frames: int, in_chans: int, depth: int,
                     drop_path_rate: float = 0.0, drop_rate: float = 0.0,
                     attn_drop_rate: float = 0.0) -> List[PartSpec]:
    return [PartSpec(name=name,
                     joint_indices=np.asarray(idx, dtype=np.int32),
                     config=MixSTEConfig(num_frames=num_frames,
                                         num_joints=len(idx),
                                         in_chans=in_chans,
                                         embed_dim=PART_CHANNELS[name],
                                         depth=depth, drop_rate=drop_rate,
                                         attn_drop_rate=attn_drop_rate,
                                         drop_path_rate=drop_path_rate))
            for name, idx in parts_joint_indices.items()]


def monolithic_spec(num_joints: int, num_frames: int, in_chans: int,
                    embed_dim: int, depth: int, drop_path_rate: float = 0.0,
                    drop_rate: float = 0.0,
                    attn_drop_rate: float = 0.0) -> List[PartSpec]:
    """A single whole-body network."""
    return [PartSpec(name="whole_body",
                     joint_indices=np.arange(num_joints, dtype=np.int32),
                     config=MixSTEConfig(num_frames=num_frames,
                                         num_joints=num_joints,
                                         in_chans=in_chans,
                                         embed_dim=embed_dim, depth=depth,
                                         drop_rate=drop_rate,
                                         attn_drop_rate=attn_drop_rate,
                                         drop_path_rate=drop_path_rate))]


class PartModel(nn.ModuleDict):
    """Applies one MixSTE2 per part and reassembles the whole body:
    (B,F,N,2) x (B,F,N,3) x (B,) -> (B,F,N,3).

    State-dict keys are ``{part}.<MixSTE2 key>``, the reference's names
    under ``pose_estimator.``.  Part networks draw their weights from
    ``generator`` in spec order; ``use_pallas`` and
    ``experimental_kernels`` select their eval-mode functions
    (``MixSTE2.set_use_pallas``), and ``compute_dtype``, ``train_kernel``
    and ``remat`` reach every part network (``MixSTE2``).

    ``packed`` (with more than one part): eval-mode forwards run packed
    (:func:`~pafuse_tpu_torch.models.packed.packed_forward`, which takes
    ``compute_dtype`` only: no kernel runs on that path); train mode stays
    unpacked (stochastic depth needs the part networks)."""

    def __init__(self, specs: List[PartSpec], device="cuda",
                 generator: torch.Generator | None = None,
                 use_pallas="auto", experimental_kernels: bool = False,
                 compute_dtype=torch.float32, train_kernel="auto",
                 remat: bool = False, packed: bool = False):
        dev = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        super().__init__({s.name: MixSTE2(s.config, dev, gen, use_pallas,
                                          experimental_kernels,
                                          compute_dtype, train_kernel, remat)
                          for s in specs})
        self.specs = specs
        concat_order = np.concatenate([s.joint_indices for s in specs])
        self.num_joints = int(concat_order.max()) + 1
        if len(concat_order) != self.num_joints:
            raise ValueError("part tables must partition the joint set")
        self._is_identity = bool(np.all(concat_order == np.arange(self.num_joints)))
        self.register_buffer("_inverse", torch.as_tensor(
            np.argsort(concat_order), dtype=torch.long, device=dev),
            persistent=False)
        for s in specs:
            self.register_buffer(f"_idx_{s.name}", torch.as_tensor(
                s.joint_indices, dtype=torch.long, device=dev),
                persistent=False)
        self.packed = bool(packed) and len(specs) > 1
        if self.packed:
            self._plan = pk.make_pack_plan(specs)
            for name, table in pk.plan_tables(self._plan, dev).items():
                self.register_buffer(f"_pack_{name}", table, persistent=False)

    def prepare(self, train: bool = False) -> Optional[Dict[str, Any]]:
        """The packed parameters for repeated forwards (once per DDIM
        sampling call, as the JAX ``prepare`` packs once before its scan)
        when packed execution applies, else None."""
        if not self.packed or train:
            return None
        return pk.pack_params(self, self._plan, {
            name: getattr(self, f"_pack_{name}") for name in pk.TABLES})

    def forward(self, x2d: torch.Tensor, x3d: torch.Tensor, t: torch.Tensor,
                masks: Optional[Dict[str, Sequence]] = None,
                dropout_masks: Optional[Dict[str, dict]] = None,
                packed_params: Optional[Dict[str, Any]] = None
                ) -> torch.Tensor:
        """In train mode, ``masks`` and ``dropout_masks`` map each part to
        its network's branch and dropout masks (see
        :meth:`MixSTE2.forward`; drawn by ``diffusion.D3DP.draw_train``).
        ``packed_params`` (:meth:`prepare`'s) run the packed forward; a
        packed model in eval mode packs its parameters itself without
        them."""
        if packed_params is None and self.packed and not self.training:
            packed_params = self.prepare()
        if packed_params is not None:
            return pk.packed_forward(
                packed_params, self._plan, x2d, x3d, t,
                compute_dtype=next(iter(self.values())).compute_dtype)
        outs = []
        for s in self.specs:
            idx = getattr(self, f"_idx_{s.name}")
            part_masks = None
            if masks is not None and s.name in masks:
                part_masks = [tuple(torch.as_tensor(m, dtype=torch.float32,
                                                    device=x2d.device)
                                    for m in pair) for pair in masks[s.name]]
            outs.append(self[s.name](
                x2d.index_select(-2, idx), x3d.index_select(-2, idx), t,
                masks=part_masks,
                dropout_masks=(dropout_masks or {}).get(s.name)))
        merged = torch.cat(outs, dim=-2)
        if self._is_identity:
            return merged
        return merged.index_select(-2, self._inverse)
