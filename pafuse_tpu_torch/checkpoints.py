"""Weights into and out of the port: a JAX parameter tree, a JAX
``save_state`` npz, a reference-named torch ``.bin``, and the port's own
training checkpoints.

Each loader returns a state dict of float32 CPU tensors in the port's (and
the reference's) naming.  A tree of part networks ``{part: mixste_tree}``
gives ``{part}.<key>`` names, for :class:`~pafuse_tpu_torch.models.parts.
PartModel` (``D3DP.pose_estimator``); a single MixSTE tree gives plain
MixSTE2 names.  Load the result with ``load_state_dict(..., strict=True)``.

JAX layout -> torch layout: Linear ``kernel`` (in, out) becomes ``weight``
(out, in); LayerNorm ``scale`` becomes ``weight``; ``time_mlp.fc1/fc2``
become ``time_mlp.1/3`` and ``head.norm/fc`` become ``head.0/1``.
:func:`params_to_jax` goes the other way.

:func:`save_state` writes ``{folder}/{tag}.npz`` in the layout of the JAX
``save_state``: ``params/...`` in the JAX tree layout (so the JAX
``load_state`` reads the port's weights), ``__meta__`` (epoch, lr, extra as
JSON), ``__random_state__`` (the sampler's pickled NumPy RandomState), the
AdamW state under ``opt/`` in the layout of the JAX ``make_optimizer()``
state (:func:`opt_state_to_jax`), which the JAX ``load_state`` restores
into its optax template, and the port's own ``__torch_rng__`` (the training
generator's state).  :func:`load_state` reads that layout, from either
package, into ``torch.optim.AdamW`` (:func:`opt_state_from_jax`), and also
the ``opt/{parameter}/{exp_avg,exp_avg_sq,step}`` entries of older port
files.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Any, Dict, Mapping, Optional, Sequence

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


_TO_JAX = {v: k for k, v in _RENAME.items()}


def _jax_entry(key: str, value: torch.Tensor):
    """One torch MixSTE2 entry -> (JAX path parts, array)."""
    parts = key.split(".")
    if tuple(parts[:2]) in _TO_JAX:
        parts[:2] = _TO_JAX[tuple(parts[:2])]
    value = value.detach().cpu().float().numpy()
    if parts[-1] == "weight":
        if value.ndim == 2:
            parts[-1], value = "kernel", value.T
        else:
            parts[-1] = "scale"
    return parts, np.ascontiguousarray(value)


def _lists(tree):
    """Dicts keyed 0..n-1 -> lists, as the JAX tree holds the blocks."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a port state dict
    (``{part}.<key>`` or plain MixSTE2 names) -> a JAX parameter tree of
    float32 NumPy arrays."""
    single = any(k.startswith("STEblocks.") for k in state)
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        if single:
            path, array = _jax_entry(key, value)
        else:
            part, _, rest = key.partition(".")
            path, array = _jax_entry(rest, value)
            path = [part] + path
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = array
    return _lists(tree)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict from a JAX parameter tree held as NumPy arrays (the
    ``PartModel.init_params`` / ``load_state`` layout, or one MixSTE tree)."""
    return _state_dict(_flatten(tree))


# The optax state of the JAX ``make_optimizer()``
# (``inject_hyperparams(adamw)``), flattened as the JAX ``save_state`` writes
# it: ``0`` the step count, ``1/{b1,b2,eps,eps_root,learning_rate,
# weight_decay}`` the hyperparameters, ``3/0/0`` Adam's step count and
# ``3/0/1/<params path>``, ``3/0/2/<params path>`` its first and second
# moments (mu, nu) in the JAX parameter layout.
_ADAM_COUNT, _MU, _NU = "3/0/0", "3/0/1/", "3/0/2/"


def opt_state_to_jax(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> list:
    """The AdamW state of ``optimizer`` over ``model``'s parameters (a D3DP,
    PartModel or MixSTE2) as the JAX ``make_optimizer()`` state tree: its
    namedtuple fields as a list (count, hyperparams, hyperparams_states,
    inner_state), moments in the JAX parameter layout (Linear weights
    transposed), counts int32, hyperparameters float32 scalars with the
    optimizer's current lr.  A parameter the optimizer has not stepped
    has zero moments."""
    net = _part_model(model)
    group = optimizer.param_groups[0]
    moments, steps = ({}, {}), set()
    for name, p in net.named_parameters():
        st = optimizer.state.get(p, {})
        steps.add(int(torch.as_tensor(st.get("step", 0)).item()))
        for out, key in zip(moments, ("exp_avg", "exp_avg_sq")):
            out[name] = st[key] if key in st else torch.zeros_like(p)
    if len(steps) > 1:
        raise ValueError(f"opt_state_to_jax: parameters at different step "
                         f"counts {sorted(steps)}; optax keeps one count")
    count = np.int32(steps.pop() if steps else 0)
    f32 = np.float32
    hyper = {"b1": f32(group["betas"][0]), "b2": f32(group["betas"][1]),
             "eps": f32(group["eps"]), "eps_root": f32(0.0),
             "learning_rate": f32(group["lr"]),
             "weight_decay": f32(group["weight_decay"])}
    mu, nu = (params_to_jax(m) for m in moments)
    return [count, hyper, {}, [[count, mu, nu]]]


def opt_state_from_jax(tree: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """AdamW state per port parameter name, {name: {"step", "exp_avg",
    "exp_avg_sq"}}, from a JAX ``make_optimizer()`` state (the optax tree,
    or the flat ``opt/`` entries of a ``save_state`` npz without the
    prefix): mu -> exp_avg, nu -> exp_avg_sq with kernels transposed as
    :func:`params_from_jax` does, Adam's count -> step."""
    flat = _flatten(tree)
    if _ADAM_COUNT not in flat:
        raise ValueError(f"no optax Adam count ({_ADAM_COUNT}) among the "
                         f"optimizer entries {sorted(flat)[:4]}")
    step = torch.tensor(float(np.asarray(flat[_ADAM_COUNT])))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for prefix, key in ((_MU, "exp_avg"), (_NU, "exp_avg_sq")):
        for name, value in _state_dict({k[len(prefix):]: v for k, v in
                                        flat.items()
                                        if k.startswith(prefix)}).items():
            out.setdefault(name, {"step": step.clone()})[key] = value
    return out


def _opt_state(flat: Dict[str, np.ndarray], names: Sequence[str]
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The AdamW state per parameter name from a file's ``opt/`` entries
    (prefix removed): the optax layout, or the ``{name}/{key}`` entries of
    older port files.  An entry that maps to no parameter of ``names``, or
    a parameter without its full state, raises."""
    if _ADAM_COUNT in flat:
        state = opt_state_from_jax(flat)
        stray = [k for k in flat if k not in ("0", _ADAM_COUNT)
                 and not k.startswith(("1/", _MU, _NU))]
    else:
        state, stray = {}, []
        for k, v in flat.items():
            name, _, key = k.rpartition("/")
            if key in ("exp_avg", "exp_avg_sq", "step"):
                state.setdefault(name, {})[key] = torch.from_numpy(v.copy())
            else:
                stray.append(k)
    stray += sorted(set(state) - set(names))
    if stray:
        raise ValueError(f"optimizer entries that map to no parameter: "
                         f"{stray[:4]}")
    partial = [n for n in names
               if set(state.get(n, {})) != {"step", "exp_avg", "exp_avg_sq"}]
    if partial:
        raise ValueError(f"no full AdamW state for {partial[:4]}")
    return state


def load_state_npz(path: str) -> Dict[str, torch.Tensor]:
    """State dict from the ``params/...`` entries of a JAX ``save_state``
    npz, read with NumPy alone."""
    with np.load(path, allow_pickle=False) as raw:
        flat = {k[len("params/"):]: raw[k] for k in raw.files
                if k.startswith("params/")}
    if not flat:
        raise ValueError(f"{path}: no params/ entries")
    return _state_dict(flat)


def _random_state_globals() -> list:
    """The NumPy globals that a pickled ``np.random.RandomState`` names: its
    and its bit generator's constructors, the MT19937 class, and the array
    (``_reconstruct``, ``ndarray``, ``dtype``) of its key.  NumPy 1.x
    pickles ``_reconstruct`` under ``numpy.core.multiarray``, NumPy 2.x
    under ``numpy._core.multiarray``: both names are allowed."""
    from numpy.random import _mt19937, _pickle
    reconstruct = np.empty(0).__reduce__()[0]
    return [getattr(_pickle, "__randomstate_ctor"),
            getattr(_pickle, "__bit_generator_ctor"), _mt19937.MT19937,
            np.random.RandomState,
            np.ndarray, np.dtype, type(np.dtype(np.uint32)),
            (reconstruct, "numpy.core.multiarray._reconstruct"),
            (reconstruct, "numpy._core.multiarray._reconstruct")]


def load_reference_bin(path: str, parts: Sequence[str] = ()
                       ) -> Dict[str, torch.Tensor]:
    """State dict of the part networks from a reference-named torch
    checkpoint: a state dict, or a dict holding one under ``model_pos`` or
    ``state_dict``.  ``module.`` and ``pose_estimator.`` prefixes are
    stripped and the diffusion schedule buffers are dropped.

    ``parts``: the part names of the model to load into.  A model with one
    part (``general.part_based_model=false``: ``whole_body``) takes the
    reference's monolithic keys (``pose_estimator.STEblocks...``, no part
    name) under that part's name, as the JAX loader maps them into its one
    tree.

    The reference's ``save_state`` also writes ``epoch``, ``lr``,
    ``optimizer`` and ``random_state``, a pickled ``np.random.RandomState``;
    the file is read with ``weights_only=True`` and only the NumPy globals
    such a pickle names allowed (:func:`_random_state_globals`)."""
    with torch.serialization.safe_globals(_random_state_globals()):
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
    if len(parts) == 1 and not any(k.startswith(f"{parts[0]}.") for k in out):
        out = {f"{parts[0]}.{k}": v for k, v in out.items()}
    return out


#: the reference D3DP's registered schedule buffers that its strict load
#: needs, computed as ``diffusion.make_schedule`` computes them
_SCHEDULE_BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                     "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                     "sqrt_recip_alphas_cumprod",
                     "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                     "posterior_log_variance_clipped",
                     "posterior_mean_coef1", "posterior_mean_coef2")


def export_reference_state_dict(model: torch.nn.Module,
                                schedule_timesteps: Optional[int] = None
                                ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_reference_bin`, the counterpart of the JAX
    ``export_torch_state_dict``: the part networks of ``model`` (a D3DP or
    a PartModel) as the reference's ``pose_estimator.*`` state dict of
    float32 CPU tensors (``pose_estimator.{part}.<key>``; the monolithic
    model, one ``whole_body`` network, as ``pose_estimator.<key>``).
    ``schedule_timesteps`` also adds the D3DP schedule buffers of that many
    steps, ``log_one_minus_alphas_cumprod`` included, which the
    reference's strict load needs.  Save it as ``{"model_pos": ...}`` with
    ``torch.save`` for a reference ``.bin``."""
    from pafuse_tpu_torch.diffusion import make_schedule
    out: Dict[str, torch.Tensor] = {}
    if schedule_timesteps is not None:
        sched = make_schedule(schedule_timesteps)
        for name in _SCHEDULE_BUFFERS:
            out[name] = torch.from_numpy(getattr(sched, name).copy())
        # registered by the reference, unused by the sampler
        out["log_one_minus_alphas_cumprod"] = torch.from_numpy(np.log(
            1.0 - sched.alphas_cumprod.astype(np.float64)).astype(np.float32))
    net = _part_model(model)
    monolithic = [s.name for s in net.specs] == ["whole_body"]
    for key, value in net.state_dict().items():
        if monolithic:
            key = key[len("whole_body."):]
        out[f"pose_estimator.{key}"] = value.detach().cpu().float().clone()
    return out


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load the part networks' weights of a reference ``.bin``
    (:func:`load_reference_bin`) or a port or JAX ``.npz``
    (:func:`load_state`) into the D3DP ``model``, strictly."""
    if path.endswith(".bin"):
        model.pose_estimator.load_state_dict(load_reference_bin(
            path, [s.name for s in model.pose_estimator.specs]), strict=True)
    else:
        load_state(path, model)


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

def _part_model(model: torch.nn.Module) -> torch.nn.Module:
    """The module whose state dict has the ``params/`` naming (a D3DP's
    part router, or the module itself)."""
    return getattr(model, "pose_estimator", model)


def save_state(folder: str, tag: str, *, model: torch.nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None,
               epoch: int = 0, lr: float = 0.0, random_state=None,
               generator: Optional[torch.Generator] = None,
               extra: Optional[dict] = None) -> str:
    """Write ``{folder}/{tag}.npz`` (layout in the module docstring) and
    return its path.  ``model``: a D3DP, PartModel or MixSTE2."""
    net = _part_model(model)
    arrays = {f"params/{k}": v for k, v in _flatten(
        params_to_jax(net.state_dict())).items()}
    if optimizer is not None:
        arrays.update({f"opt/{k}": v for k, v in _flatten(
            opt_state_to_jax(net, optimizer)).items()})
    meta = {"epoch": int(epoch), "lr": float(lr), "extra": extra or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    if random_state is not None:
        arrays["__random_state__"] = np.frombuffer(pickle.dumps(random_state),
                                                   np.uint8)
    if generator is not None:
        arrays["__torch_rng__"] = generator.get_state().numpy()
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{tag}.npz")
    np.savez(path, **arrays)
    return path


def load_state(path: str, model: Optional[torch.nn.Module] = None,
               optimizer: Optional[torch.optim.Optimizer] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Restore a :func:`save_state` checkpoint of either package: loads the
    params into ``model`` (strict), the AdamW state into ``optimizer``
    (:func:`_opt_state`; the lr set to the file's) and the generator state
    into ``generator`` when given and the file has them (a JAX checkpoint
    has no generator state).  Returns {"params", "epoch", "lr", "extra"}
    and "random_state" when the file has one."""
    out: Dict[str, Any] = {"params": load_state_npz(path)}
    with np.load(path, allow_pickle=False) as raw:
        out.update(json.loads(bytes(raw["__meta__"]).decode()))
        if "__random_state__" in raw.files:
            out["random_state"] = pickle.loads(bytes(raw["__random_state__"]))
        if generator is not None and "__torch_rng__" in raw.files:
            generator.set_state(torch.from_numpy(raw["__torch_rng__"].copy()))
        opt = {k[len("opt/"):]: raw[k] for k in raw.files
               if k.startswith("opt/")}
    if model is not None:
        _part_model(model).load_state_dict(out["params"], strict=True)
    if optimizer is not None:
        if opt:
            names = {id(p): n
                     for n, p in _part_model(model).named_parameters()}
            state = _opt_state(opt, list(names.values()))
            sd = optimizer.state_dict()
            params = [p for g in optimizer.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                sd["state"][i] = state[names[id(p)]]
            optimizer.load_state_dict(sd)
        for g in optimizer.param_groups:
            g["lr"] = out["lr"]
    return out


def latest_checkpoint(folder: str) -> Optional[str]:
    """The ``epoch_N.npz`` of ``folder`` with the largest N (for
    ``general.resume=auto``), or None."""
    best, best_epoch = None, -1
    if not os.path.isdir(folder):
        return None
    for name in os.listdir(folder):
        m = re.fullmatch(r"epoch_(\d+)\.npz", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(folder, name)
    return best
