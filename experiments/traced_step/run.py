"""Profile 8 float32 H3WB training steps one at a time (depth 8, 37
sequences, after 2 warm ones) on the tree in the working directory; for
each, the device total as chip_smoke.py's groups sum it, the device ms of
the events it files under no group (the "PyTorch" group) and their top
five by name.  Run from the root of a checkout on the card:

    python3 experiments/traced_step/run.py

From another tree's root it measures that tree (its package and its
chip_smoke.py come first on sys.path)."""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from pafuse_tpu_torch import train as tr
from pafuse_tpu_torch.data import h3wb
from pafuse_tpu_torch.data.sampling import ChunkedSampler
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.utils.device import resolve_device
dev = resolve_device("cuda")
_build.build_all()
subjects = ["S1", "S5", "S6", "S7"]
ds = h3wb.load_dataset(synthetic=True, subjects=tuple(subjects), seed=0)
kp3 = h3wb.prepare_data(ds)
cams, p3d, p2d = h3wb.fetch(subjects, kp3, ds)
sampler = ChunkedSampler(37, cams, p3d, p2d, 27, shuffle=True, augment=True, flip_permutation=ds.flip_permutation)
model = D3DP(D3DPConfig(depth=8, drop_path_rate=0.1), device=dev, generator=torch.Generator().manual_seed(0))
state = tr.create_train_state(model, seed=0, device=dev)
step = tr.build_train_step(model, state.optimizer, weights=tr.mixste_weight_table(134))
batches = []
for b in sampler.next_epoch():
    batches.append(b)
    if len(batches) == 10:
        break
for _, b3d, b2d in batches[:2]:
    float(step(state, 6e-5, b2d, b3d))
for i, (_, b3d, b2d) in enumerate(batches[2:]):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(state, 6e-5, b2d, b3d))
    rest, total = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            total += e.self_device_time_total / 1e3
            if chip_smoke.kernel_group(e.key, chip_smoke.TRAIN_GROUPS) is None:
                rest[e.key[:90]] = (e.self_device_time_total / 1e3, e.count)
    top = sorted(rest.items(), key=lambda kv: -kv[1][0])[:5]
    print(json.dumps({"tree": os.getcwd(), "step": i, "device_ms": round(total, 2),
                      "pytorch_ms": round(sum(v[0] for v in rest.values()), 2),
                      "top": [(k, round(v[0], 2), v[1]) for k, v in top]}), flush=True)
