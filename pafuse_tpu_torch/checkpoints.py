"""Weights into the port: from a JAX parameter tree, a JAX ``save_state``
npz, or a reference-named torch ``.bin``.

Each loader returns a state dict of float32 CPU tensors in the port's (and
the reference's) naming.  A tree of part networks ``{part: mixste_tree}``
gives ``{part}.<key>`` names, for :class:`~pafuse_tpu_torch.models.parts.
PartModel` (``D3DP.pose_estimator``); a single MixSTE tree gives plain
MixSTE2 names.  Load the result with ``load_state_dict(..., strict=True)``.

JAX layout -> torch layout: Linear ``kernel`` (in, out) becomes ``weight``
(out, in); LayerNorm ``scale`` becomes ``weight``; ``time_mlp.fc1/fc2``
become ``time_mlp.1/3`` and ``head.norm/fc`` become ``head.0/1``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_RENAME = {("time_mlp", "fc1"): ("time_mlp", "1"),
           ("time_mlp", "fc2"): ("time_mlp", "3"),
           ("head", "norm"): ("head", "0"),
           ("head", "fc"): ("head", "1")}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/b/0/c": array}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _torch_entry(path: str, value: np.ndarray):
    """One flattened JAX MixSTE leaf -> (torch key, tensor)."""
    parts = path.split("/")
    if tuple(parts[:2]) in _RENAME:
        parts[:2] = _RENAME[tuple(parts[:2])]
    value = np.array(value, dtype=np.float32)
    if parts[-1] == "kernel":
        parts[-1], value = "weight", value.T
    elif parts[-1] == "scale":
        parts[-1] = "weight"
    return ".".join(parts), torch.from_numpy(np.ascontiguousarray(value))


def _state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    single = any(k.startswith("STEblocks/") for k in flat)
    out = {}
    for path, value in flat.items():
        if single:
            key, tensor = _torch_entry(path, value)
        else:
            part, _, rest = path.partition("/")
            key, tensor = _torch_entry(rest, value)
            key = f"{part}.{key}"
        out[key] = tensor
    return out


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict from a JAX parameter tree held as NumPy arrays (the
    ``PartModel.init_params`` / ``load_state`` layout, or one MixSTE tree)."""
    return _state_dict(_flatten(tree))


def load_state_npz(path: str) -> Dict[str, torch.Tensor]:
    """State dict from the ``params/...`` entries of a JAX ``save_state``
    npz, read with NumPy alone."""
    with np.load(path, allow_pickle=False) as raw:
        flat = {k[len("params/"):]: raw[k] for k in raw.files
                if k.startswith("params/")}
    if not flat:
        raise ValueError(f"{path}: no params/ entries")
    return _state_dict(flat)


def load_reference_bin(path: str) -> Dict[str, torch.Tensor]:
    """State dict of the part networks from a reference-named torch
    checkpoint: a state dict, or a dict holding one under ``model_pos`` or
    ``state_dict``.  ``module.`` and ``pose_estimator.`` prefixes are
    stripped and the diffusion schedule buffers are dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_pos", ckpt.get("state_dict", ckpt))
    out = {}
    for key, value in sd.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.startswith("pose_estimator."):
            out[key[len("pose_estimator."):]] = value.float()
    if not out:
        raise ValueError(f"{path}: no pose_estimator.* entries")
    return out
