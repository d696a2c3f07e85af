"""Hydra-style configuration: the default tree, ``a.b=value`` overrides and
a plain printer, with the standard library alone.

Counterpart of ``pafuse_tpu/config.py`` and ``pafuse_tpu/configs/
config.yaml``.  The groups and keys of the reference (general, mlflow,
data, model, experiment, viz, ft2d, in_the_wild) and ``serve`` are those
of the JAX package; its TPU group is replaced by ``gpu``.  Overrides are
strict: an unknown key (a typo, or a TPU-only key such as
``tpu.donate_buffers``) raises,
and ``+a.b=value`` adds a new key.  Values are parsed as YAML scalars are:
null, booleans (true/false/yes/no/on/off), ints, floats, quoted strings
and flat ``[a, b]`` lists; anything else stays a string.  ``--config
file.json`` replaces the default tree.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Dict, Iterable, List

DEFAULTS: Dict[str, Dict[str, Any]] = {
    "general": {
        "checkpoint": "",               # checkpoint directory
        "log": "log/default",           # log directory prefix
        "checkpoint_frequency": 20,     # an epoch_N checkpoint every N epochs
        "resume": "",                   # checkpoint to resume ('auto': latest)
        "nolog": False,                 # no logging.log tee
        "evaluate": "",                 # checkpoint to evaluate; '' = train
        "render": False,                # evaluate viz.viz_subject only
        "by_subject": False,            # report per subject
        "export_training_curves": False,
        "part_based_model": True,       # body/face/hands networks
    },
    "mlflow": {"mlflow_on": False, "mlflow_uri": "", "experiment": "default"},
    "data": {
        "dataset": "h3wb",
        "data_dir": "data",             # train_h3wb.npz / task1_test_3d.npz
        "synthetic": "auto",            # auto | true | false
        "synthetic_actions": 2,         # synthetic: actions per subject
        "synthetic_frames": 120,        # synthetic: frames per action
        "num_kps": 134,
        "subjects_train": "S1,S5,S6,S7",
        "subjects_test": "S8",
        "subjects_unlabeled": "",
        "actions": "*",
        "merge_hands": True,            # one network for both hands
    },
    "model": {
        "diff_model": "MixSTE2",
        "stride": 27,
        "number_of_frames": 27,         # receptive field
        "epochs": 400,
        "batch_size": 1024,             # frames a step (// number_of_frames sequences)
        "data_augmentation": True,      # train-time horizontal flips
        "test_time_augmentation": True,
        "dropout": 0.0,
        "learning_rate": 0.00006,
        "lr_decay": 0.993,
        "coverlr": False,
        "min_loss": 100000,
        "cs": 288,                      # channels of the monolithic model
        "dep": 8,                       # transformer depth
        "alpha": 0.01,
        "beta": 2,
        "input_size": 5,
        "wb_loss": False,
        "mse_loss": False,
        "weighted_loss": False,
    },
    "experiment": {
        "gpu": "0", "subset": 1, "downsample": 1, "warmup": 1,
        "no_eval": False, "ft": False, "ftpath": "", "ftchk": "",
    },
    "viz": {
        "viz_subject": "S8", "viz_action": "Sitting", "viz_camera": 0,
        "viz_video": "", "viz_skip": 0, "viz_output": "test.gif",
        "viz_export": "", "viz_bitrate": 3000, "viz_no_ground_truth": False,
        "viz_limit": -1, "viz_downsample": 1, "viz_size": 5, "compare": False,
    },
    "ft2d": {
        "linear_channel_size": 1024,
        "depth": 4,
        "lr_decay_gap": 10000,
        "scale": 1.0,                   # SNR scale
        "timestep": 1000,               # diffusion timesteps
        "sampling_timesteps": 5,        # DDIM steps at evaluation
        "num_proposals": 10,            # hypotheses at evaluation
        "debug": False,
        "p2": False,                    # protocol #2 metrics
    },
    "in_the_wild": {"video_path": ""},
    "serve": {
        "host": "127.0.0.1",
        "port": 8012,
        "buckets": [1, 2, 4, 8, 16],    # window-batch chunk sizes; the
                                        # largest caps a co-batched call
        "shard": "auto",                # auto: one replica per visible
                                        # card, window rows split over
                                        # them; off: gpu.device alone
        "batching": "auto",             # auto: co-batch concurrent requests'
                                        # windows; off: serialise requests
        "max_frames": 100000,           # per-request frame cap
        "noise": "host",                # host: per-window noise drawn on the
                                        # host (the JAX service's draws);
                                        # device: drawn on the card from
                                        # per-window seeds (another universe)
        "readback": "all",              # all: every hypothesis read back;
                                        # mean: averaged on the card
                                        # (all_hypotheses rejected)
        "op_points": [],                # (P,T) tiers over the same weights,
                                        # e.g. ['10x5', '1x1']; first is the
                                        # default; [] = ft2d's P and T
    },
    "gpu": {
        "device": "cuda",               # cuda | cuda:N | cpu
        # auto | block: kernel #1; true: kernel #2 in the unfused block;
        # false: the plain block; block_t: kernel #3 on temporal blocks and
        # #1 on spatial ones; layer: kernel #4 on every layer (block_t and
        # layer need experimental_kernels=true)
        "use_pallas": "auto",
        "experimental_kernels": False,  # unlock the JAX package's retained
                                        # negative-result A/B paths
        # auto | true: training on kernels #5/#6; false: the autodiff path
        # (any model.dropout > 0 takes it too: the kernels have no dropout)
        "train_kernel": "auto",
        # float32 | bfloat16: the denoiser's activations (float32 stays the
        # default for parity-grade evaluation; parameters, the loss, the
        # optimizer and the sampler stay float32)
        "compute_dtype": "float32",
        "remat": False,                 # recompute each layer in the
                                        # backward of the autodiff path
        "seed": 1,
        # the data-parallel world (parallel/mesh.py): [-1] = every rank of
        # the launch (torchrun), one rank per card; only 'data' is sharded
        "mesh_shape": [-1],
        "mesh_axis_names": ["data"],
        "profile": False,               # torch.profiler trace of the first
                                        # trained epoch (<checkpoint>/profile)
    },
}


class ConfigNode:
    """Recursive attribute/str-key view over a nested dict."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", {})
        for k, v in data.items():
            self._data[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(f"No config key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = ConfigNode(value) if isinstance(value, dict) else value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v
                for k, v in self._data.items()}

    def __repr__(self) -> str:  # pragma: no cover
        return f"ConfigNode({self.to_dict()!r})"


def _format(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, list):
        return "[" + ", ".join(_format(x) for x in v) + "]"
    if isinstance(v, str) and (v == "" or _parse_value(v) != v):
        return repr(v)
    return str(v)


def to_yaml(cfg: ConfigNode, indent: int = 0) -> str:
    """YAML-style text of the tree, for the log."""
    lines = []
    for k, v in cfg.items():
        if isinstance(v, ConfigNode):
            lines.append(f"{' ' * indent}{k}:")
            lines.append(to_yaml(v, indent + 2).rstrip("\n"))
        else:
            lines.append(f"{' ' * indent}{k}: {_format(v)}")
    return "\n".join(lines) + "\n"


_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}
_INT = re.compile(r"[-+]?\d+")
_FLOAT = re.compile(r"[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?")


def _split_list(body: str) -> List[str]:
    """Top-level comma split of a flow list's body (quotes and nested
    brackets kept whole)."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _parse_value(raw: str) -> Any:
    """A YAML-like scalar or flat list from an override's value text."""
    s = raw.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s.lower() in _BOOLS and s in (s.lower(), s.upper(), s.capitalize()):
        return _BOOLS[s.lower()]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s.startswith("[") and s.endswith("]"):
        return [_parse_value(item) for item in _split_list(s[1:-1])]
    return raw


def apply_overrides(cfg: ConfigNode, overrides: Iterable[str]) -> ConfigNode:
    """Apply ``a.b.c=value`` overrides in place (hydra's strict mode: an
    unknown key raises; ``+a.b.c=value`` adds one and raises if it
    exists)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} is not of the form key=value")
        path, raw = ov.split("=", 1)
        path = path.strip()
        allow_new = path.startswith("+")
        if allow_new:
            path = path[1:]
        keys = path.split(".")
        node = cfg
        for i, k in enumerate(keys[:-1]):
            if k in node and not isinstance(node[k], ConfigNode):
                raise KeyError(
                    f"Config path component {'.'.join(keys[:i + 1])!r} in "
                    f"override {ov!r} is a value, not a group")
            if k not in node:
                if not allow_new:
                    raise KeyError(
                        f"Unknown config group {'.'.join(keys[:i + 1])!r} "
                        f"in override {ov!r} (use +{path}=... to add "
                        "new keys)")
                node[k] = {}
            node = node[k]
        if keys[-1] not in node and not allow_new:
            raise KeyError(
                f"Unknown config key {path!r} in override {ov!r} "
                f"(use +{path}=... to add new keys)")
        if keys[-1] in node and allow_new:
            raise KeyError(
                f"Config key {path!r} already exists; drop the '+' in "
                f"override {ov!r}")
        node[keys[-1]] = _parse_value(raw)
    return cfg


def load_config(path: str | None = None,
                overrides: Iterable[str] | None = None) -> ConfigNode:
    """The default tree (or a JSON file's) with the overrides applied."""
    if path is None:
        cfg = ConfigNode(copy.deepcopy(DEFAULTS))
    else:
        with open(path) as f:
            cfg = ConfigNode(json.load(f))
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def parse_cli(argv: List[str]) -> ConfigNode:
    """Every positional argument is a dotted override; ``--config
    path.json`` selects another root tree."""
    path = None
    overrides: List[str] = []
    it = iter(argv)
    for arg in it:
        if arg in ("--config", "-c"):
            path = next(it)
        elif arg.startswith("--config="):
            path = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    return load_config(path, overrides)
