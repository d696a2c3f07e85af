"""Three investigations on the card, each in one call (see PERF.md §6):

1. **Readback A/B** (``--parent DIR``): the device's idle share of the
   training loop and of the evaluation drain, this tree against another
   checkout of the port (e.g. the parent commit unpacked with ``git
   archive``), run parent, change, change, parent, each in its own
   process on its own tree.  Windows: three steps of the H3WB trainer
   (depth 8, 37 sequences) and of the 3DHP trainer through the tree's
   training loop (``train.run_epoch``; a tree from before it has the
   loop copied below, ``float(loss)`` one step behind), and the
   ``eval_profile`` window of ``chip_smoke.py`` (one 152-window action at
   ``use_pallas=true``, P=10, T=1: two 64-row batches and a 24-row tail).
2. **Routing** (ROADMAP §3 item 8, while it is open): ``--routing N``
   runs the check of
   ``tests/test_torch_cuda.py::test_kernels_2_and_6_run_their_gemms_on_the_tensor_cores_on_gpu``
   for kernel #2 N times, each time also holding #2's output against
   ``attention_reference``, and counts the calls whose profile lacks the
   wgmma GEMM; with ``--suite`` it first runs that test file's ``cuda``
   tests in the same process (the only context in which the check has
   failed).

3. **Kernel A/B** (``--kernels DIR``): this tree against another
   checkout of the port (e.g. the parent commit unpacked with ``git
   archive``), parent, change, change, parent, each in its own process on
   its own tree: kernels #1, #3 and #4 at serve bucket 16 (16 windows x
   P=10 x flip, 27 frames; #1 one spatial and one temporal block of each
   part, #3 the temporal blocks, #4 one layer of each part) in float32 and
   bfloat16, the bfloat16 GEMM alone (``ops.gemm.fused_linear``, the four
   stages of each part at bucket 16), #2 at bucket 16 and #5/#6 at the
   training shapes in float32, a 405-frame request of a bfloat16
   ``LiftingService`` (depth 8, P=10, T=5), a bfloat16 ``use_pallas=auto``
   evaluation of the 76-window action (synthetic S8, 500 frames), the same
   evaluation in float32 at ``use_pallas=true`` (kernel #2), and a
   float32 training step (depth 8, 37 sequences); times are device ms
   (CUDA events) or host ms ending in a synchronisation.  Beside the
   times of #1, #2, #5 and #6, the device ms of their attention stages
   (every kernel whose name holds "attention" or "attn_bwd" in one
   profiled call of each shape: ``#1_attention_*``, ``#2_attention_*``,
   ``#5_attention_*``, ``#6_attention_*``).  Each worker also
   hashes the float32 outputs of #1-#6 on the same seeded inputs and the
   float32 training window's losses and parameters, and the summary says
   whether each hash is equal across the two trees and across each tree's
   two runs (a repeat); ``--changed`` names the kernels whose float32
   outputs this change may alter (e.g. ``#1,#3,#4``), every other hash must
   be equal across the trees (the training window's hash belongs to #5 and
   #6).  First it compiles both trees' CUDA sources
   and holds the SASS of every kernel the two have in common equal (the
   float32 GEMM's instantiations among them).

    python3 chip_ab.py --parent build/parent --routing 50
    python3 chip_ab.py --suite --routing 50
    python3 chip_ab.py --kernels build/parent [--changed '#2,#5,#6']

Prints JSON lines; the last is ``{"ok": true, ...}``.  It exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 3                 # steps in a training window (after 2 warm steps)
SEQS = 1024 // 27         # the CLI's sequences a step
#: the kernels whose float32 outputs a hash depends on, where its key does
#: not start with the kernel ("#1_body_0" belongs to #1)
DIGEST_KERNELS = {"train_window": ("#5", "#6")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def idle_profile(fn, device):
    """``fn()`` under torch.profiler: wall ms (host clock, ending in a
    synchronisation), device ms (the CUDA kernels' self time) and the idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize(device)
        wall = (time.time() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"wall_ms": wall, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / wall if dev_ms else "not measured"}


def old_loop(step, state, lr, batches, seqs):
    """The CLIs' training loop of a tree without ``train.run_epoch`` (its
    ``cli/main_h3wb.py``): step N's loss read by ``float()`` after step
    N+1 has been queued."""
    from pafuse_tpu_torch import train as tr
    total, pending = 0.0, None
    for _, b3d, b2d in batches:
        b2d, real = tr.pad_batch(b2d, seqs)
        b3d, _ = tr.pad_batch(b3d, seqs)
        loss = step(state, lr, b2d, b3d)
        if pending is not None:
            total += pending[1] * float(pending[0])
        pending = (loss, real)
    total += pending[1] * float(pending[0])
    return total


def train_window(name, cfg, sampler, mode, weights=None, part_based=True,
                 flip_permutation=None):
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP

    dev = torch.device("cuda")
    model = D3DP(cfg, device=dev, generator=torch.Generator().manual_seed(0),
                 flip_permutation=flip_permutation)
    state = tr.create_train_state(model, seed=0, device=dev)
    step = tr.build_train_step(model, state.optimizer, weights=weights,
                               part_based=part_based)
    batches = []
    for batch in sampler.next_epoch():
        batches.append(batch)
        if len(batches) == 2 + STEPS:
            break
    for _, b3d, b2d in batches[:2]:
        float(step(state, 6e-5, b2d, b3d))
    if hasattr(tr, "run_epoch"):
        run = lambda: tr.run_epoch(step, state, 6e-5, batches[2:], SEQS)  # noqa: E731
    else:
        run = lambda: old_loop(step, state, 6e-5, batches[2:], SEQS)  # noqa: E731
    out = idle_profile(run, dev)
    emit({"window": name, "mode": mode, "steps": STEPS, **out})


def worker(mode: str):
    """One tree's windows (its package is first on sys.path)."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import evaluate as ev, skeleton as sk, train as tr
    from pafuse_tpu_torch.data import dhp3, h3wb
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    _build.build_all()
    subjects = ["S1", "S5", "S6", "S7"]
    ds = h3wb.load_dataset(synthetic=True, subjects=tuple(subjects), seed=0)
    kp = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(subjects, kp, ds)
    train_window("train", D3DPConfig(depth=8, drop_path_rate=0.1),
                 ChunkedSampler(SEQS, cams, p3d, p2d, 27, shuffle=True,
                                augment=True,
                                flip_permutation=ds.flip_permutation), mode,
                 weights=tr.mixste_weight_table(134))
    train3, _ = dhp3.make_synthetic(num_train_seqs=16, frames=1000, seed=0)
    q3, q2 = dhp3.train_arrays(train3)
    train_window("dhp3_train",
                 D3DPConfig(num_kps=sk.NUM_JOINTS_3DHP, cs=288, depth=8,
                            part_based=False, mm_scale=True,
                            drop_path_rate=0.1),
                 ChunkedSampler(SEQS, None, q3, q2, 27, augment=True,
                                flip_permutation=sk.FLIP_PERMUTATION_3DHP),
                 mode, part_based=False,
                 flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    # chip_smoke.py's eval_profile window: one S8 action of 1000 frames
    ds = h3wb.load_dataset(synthetic=True, actions_per_subject=2,
                           frames_per_action=1000)
    kp = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(["S8"], kp, ds)
    seqs = list(zip(cams, p3d, p2d))[:4]
    model = D3DP(D3DPConfig(depth=8, num_proposals=10, sampling_timesteps=1),
                 device="cuda", generator=torch.Generator().manual_seed(0),
                 use_pallas="true")

    def run():
        acc, _ = ev.evaluate_sequences(model, seqs, receptive_field=27,
                                       num_proposals=10, sampling_timesteps=1,
                                       window_batch=64)
        assert all(np.all(np.isfinite(v)) for v in acc.means_mm().values())

    run()
    emit({"window": "eval", "mode": mode, "windows": 152,
          **idle_profile(run, torch.device("cuda"))})


def _cuda_ms(fn, reps=5, warm=2):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _block_params(C, seed, device):
    """The 14 block tensors, Linear weights U(+-1/sqrt(in)), LayerNorm
    affines near (1, 0), from a numpy seed (the same in every tree)."""
    import numpy as np
    import torch
    r = np.random.RandomState(seed)

    def u(shape, fan_in):
        return r.uniform(-1, 1, shape) / np.sqrt(fan_in)

    def ln():
        return [1 + 0.1 * r.randn(C), 0.1 * r.randn(C)]

    hid = 2 * C
    arrays = (ln() + [u((3 * C, C), C), u((3 * C,), C), u((C, C), C),
                      u((C,), C)] + ln()
              + [u((hid, C), C), u((hid,), C), u((C, hid), hid), u((C,), hid)]
              + ln())
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def kernels_worker(mode: str):
    """One tree's kernel A/B numbers (its package is first on sys.path)."""
    import hashlib
    import numpy as np
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.evaluate import evaluate_sequences
    from pafuse_tpu_torch.models.mixste import MixSTE2
    from pafuse_tpu_torch.models.parts import PART_CHANNELS
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.ops.attention import fused_attention
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.ops.block_temporal import fused_block_temporal
    from pafuse_tpu_torch.ops.block_train import (block_train_bwd,
                                                  block_train_fwd)
    from pafuse_tpu_torch.ops.gemm import fused_linear
    from pafuse_tpu_torch.ops.layer import fused_layer
    from pafuse_tpu_torch.serve import LiftingService
    from pafuse_tpu_torch.skeleton import parts_table
    from pafuse_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    _build.build_all()
    heads, seqs, frames = 8, 16 * 10 * 2, 27
    parts = [(name, len(j), PART_CHANNELS[name])
             for name, j in parts_table(True).items()]
    times, digests = {}, {}

    def add(key, ms):
        times[key] = times.get(key, 0.0) + ms

    def digest(key, *outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
        digests[key] = h.hexdigest()[:16]

    def attention_ms(fn):
        """Device ms of the attention kernels of one profiled call (the
        tensor-core stages and the scalar ones they replaced)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and ("attention" in e.key or "attn_bwd" in e.key)) / 1e3

    # every float32 reading first (all parts), then the bfloat16 ones, so
    # no float32 time follows the bfloat16 kernels' load on the card
    for dtype in (torch.float32, torch.bfloat16):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        for i, (part, J, C) in enumerate(parts):
            p = _block_params(C, 100 + i, dev)
            q = _block_params(C, 200 + i, dev)
            gen = torch.Generator(device=dev).manual_seed(300 + i)
            x = torch.randn(seqs, frames, J, C, generator=gen, device=dev).to(dtype)
            spatial = x.reshape(seqs * frames, J, C)
            temporal = x.transpose(1, 2).reshape(seqs * J, frames, C).contiguous()
            runs = {
                "#1": [lambda: fused_block(spatial, p[:12], p[12:], heads),
                       lambda: fused_block(temporal, q[:12], q[12:], heads)],
                "#3": [lambda: fused_block_temporal(x, q[:12], q[12:], heads)],
                "#4": [lambda: fused_layer(x, p[:12], p[12:], q[:12], q[12:],
                                           heads)]}
            if dtype == torch.float32:
                # #2 at the same shapes
                runs["#2"] = [
                    lambda: fused_attention(spatial, p[2], p[3], p[4], p[5], heads),
                    lambda: fused_attention(temporal, q[2], q[3], q[4], q[5], heads)]
            for k, fns in runs.items():
                for j, fn in enumerate(fns):
                    add(f"{k}_{name}_ms", _cuda_ms(fn))
                    if dtype == torch.float32:
                        digest(f"{k}_{part}_{j}", fn())
            for k in ("#1", "#2") if dtype == torch.float32 else ("#1",):
                for fn in runs[k]:
                    add(f"{k}_attention_{name}_ms", attention_ms(fn))
            del x, spatial, temporal
            if dtype == torch.bfloat16:
                # the bfloat16 GEMM alone: each stage on its A, R
                M = seqs * frames * J
                a = {K: torch.randn(M, K, generator=gen, device=dev).to(dtype)
                     for K in (C, 2 * C)}
                res = torch.randn(M, C, generator=gen, device=dev).to(dtype)
                for w, b, ln, epi, K in ((p[2], p[3], p[0:2], "store", C),
                                         (p[4], p[5], None, "residual", C),
                                         (p[8], p[9], p[6:8], "gelu", C),
                                         (p[10], p[11], None, "residual",
                                          2 * C)):
                    add("gemm_bfloat16_ms", _cuda_ms(lambda: fused_linear(
                        a[K], w, b, ln, epi,
                        res if epi == "residual" else None)))
                    add("gemm_bfloat16_flop", 2 * M * w.shape[0] * K)
                del a, res
            else:
                # #5/#6 at the training shapes (37 sequences x 27 frames)
                gen = torch.Generator(device=dev).manual_seed(400 + i)
                for j, (B, L) in enumerate(((37 * frames, J), (37 * J, frames))):
                    xt = torch.randn(B, L, C, generator=gen, device=dev)
                    g = torch.randn(B, L, C, generator=gen, device=dev)
                    m = torch.tensor(np.array([0.0, 1 / 0.9, 1.0], np.float32)[
                        np.arange(B) % 3], device=dev)
                    fwd = lambda: block_train_fwd(xt, m, m, p, heads)  # noqa: E731
                    add("#5_float32_ms", _cuda_ms(lambda: fwd()[0]))
                    y, saved = fwd()
                    add("#6_float32_ms", _cuda_ms(lambda: block_train_bwd(saved, g)))
                    add("#5_attention_float32_ms", attention_ms(lambda: fwd()[0]))
                    add("#6_attention_float32_ms",
                        attention_ms(lambda: block_train_bwd(saved, g)))
                    dx, grads = block_train_bwd(saved, g)
                    digest(f"#5_{part}_{j}", y)
                    digest(f"#6_{part}_{j}", dx, *grads)
            torch.cuda.empty_cache()
    times["gemm_bfloat16_tflops"] = (times.pop("gemm_bfloat16_flop")
                                     / times["gemm_bfloat16_ms"] / 1e9)

    # a 405-frame request of the bfloat16 service (host ms)
    cfg = D3DPConfig(depth=8)
    model = D3DP(cfg, device=dev, generator=torch.Generator().manual_seed(0),
                 compute_dtype="bfloat16")
    svc = LiftingService(model, buckets=(1, 2, 4, 8, 16), device=dev)
    svc.warmup()
    kp = np.random.RandomState(0).uniform(-1, 1, (405, 134, 2)).astype(
        np.float32)
    svc.lift(kp, seed=0)
    lat = []
    for _ in range(3):
        t0 = time.time()
        svc.lift(kp, seed=0)
        torch.cuda.synchronize()
        lat.append((time.time() - t0) * 1e3)
    times["bf16_serve_405_ms"] = float(np.median(lat))
    svc.close()
    del svc, model
    # bfloat16 auto evaluation of the 76-window action (host s)
    ds = h3wb.load_dataset(synthetic=True, actions_per_subject=1,
                           frames_per_action=500)
    kp3 = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(["S8"], kp3, ds)
    eval_seqs = list(zip(cams, p3d, p2d))[:4]
    model = D3DP(D3DPConfig(depth=8), device=dev,
                 generator=torch.Generator().manual_seed(0),
                 compute_dtype="bfloat16")

    def evaluate():
        acc, _ = evaluate_sequences(model, eval_seqs, receptive_field=27,
                                    num_proposals=10, sampling_timesteps=5,
                                    window_batch=64)
        torch.cuda.synchronize()
        assert all(np.all(np.isfinite(v)) for v in acc.means_mm().values())

    evaluate()
    t0 = time.time()
    evaluate()
    times["bf16_eval_auto_s"] = time.time() - t0
    # the same action in float32 at use_pallas=true (kernel #2, the CLI's
    # `true` evaluation; host s)
    model = D3DP(D3DPConfig(depth=8), device=dev,
                 generator=torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, MixSTE2):
            m.set_use_pallas("true")
    evaluate()
    t0 = time.time()
    evaluate()
    times["eval_true_float32_s"] = time.time() - t0
    del model
    # a float32 training step (host ms, ending in the loss)
    subjects = ["S1", "S5", "S6", "S7"]
    ds = h3wb.load_dataset(synthetic=True, subjects=tuple(subjects), seed=0)
    kp3 = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(subjects, kp3, ds)
    sampler = ChunkedSampler(SEQS, cams, p3d, p2d, 27, shuffle=True,
                             augment=True, flip_permutation=ds.flip_permutation)
    model = D3DP(D3DPConfig(depth=8, drop_path_rate=0.1), device=dev,
                 generator=torch.Generator().manual_seed(0))
    state = tr.create_train_state(model, seed=0, device=dev)
    step = tr.build_train_step(model, state.optimizer,
                               weights=tr.mixste_weight_table(134))
    batches = []
    for batch in sampler.next_epoch():
        batches.append(batch)
        if len(batches) == 2 + STEPS:
            break
    losses = [float(step(state, 6e-5, b2d, b3d)) for _, b3d, b2d in batches[:2]]
    t0 = time.time()
    for _, b3d, b2d in batches[2:]:
        losses.append(float(step(state, 6e-5, b2d, b3d)))
    times["train_step_float32_ms"] = (time.time() - t0) * 1e3 / STEPS
    digest("train_window", torch.tensor(losses),
           *[q for q in model.parameters()])
    emit({"kernels_ab": mode, "times": times, "float32_digests": digests})


def sass_compare(other: str):
    """Compile every CUDA source of both trees to a cubin (sm_90a, -O3) and
    compare the SASS (cuobjdump) of each kernel the two have in common,
    names taken without the anonymous namespace (which holds the file's
    name and a hash): a source of this tree against the other tree's source
    of the same name, or, where the other tree has none (a source split in
    two), against the kernel of that name in any of its sources."""
    from pafuse_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = os.path.join(HERE, "build", "chip_ab_sass")
    os.makedirs(out, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    trees = {"parent": other, "change": HERE}
    sources = {tree: sorted(f[:-3] for f in os.listdir(os.path.join(
        root, "pafuse_tpu_torch", "ops", "csrc")) if f.endswith(".cu"))
        for tree, root in trees.items()}
    jobs = {}
    for tree, root in trees.items():
        for name in sources[tree]:
            src = os.path.join(root, "pafuse_tpu_torch", "ops", "csrc",
                               f"{name}.cu")
            cubin = os.path.join(out, f"{name}.{tree}.cubin")
            jobs[(name, tree)] = (cubin, subprocess.Popen(
                [nvcc, *flags, "-cubin", "-o", cubin, src],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    for (name, tree), (_, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc -cubin failed on {tree}'s {name}.cu")

    def kernels(cubin):
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
        found, cur = {}, None
        for line in sass.splitlines():
            line = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                          "_ZN", line)
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                cur = found.setdefault(m.group(1), [])
            elif cur is not None:
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
                if m:
                    cur.append(" ".join(m.group(1).split()))
        return found

    par = {name: kernels(jobs[(name, "parent")][0])
           for name in sources["parent"]}
    pooled = {}
    for name in sources["parent"]:
        for k, v in par[name].items():
            pooled.setdefault(k, v)
    common = identical = 0
    differing = []
    for name in sources["change"]:
        ref = par.get(name, pooled)
        chg = kernels(jobs[(name, "change")][0])
        for k in sorted(set(ref) & set(chg)):
            common += 1
            if ref[k] == chg[k]:
                identical += 1
            else:
                differing.append(f"{name}.cu: {k}")
    return {"phase": "kernels_ab_sass", "common_kernels": common,
            "identical": identical, "differing": differing}


def kernels_summary(results, changed=()):
    """Per metric: the parent's and the change's readings, each tree's
    spread, the change over the parent, and whether the change is faster
    (or, for the float32 rows, within 5%) beyond the spread; whether each
    float32 hash repeats within each tree, and agrees across the trees for
    every kernel not in ``changed``."""
    runs = {"parent": [], "change": []}
    for res in results:
        runs[res["kernels_ab"]].append(res)
    out = {}
    for key in runs["change"][0]["times"]:
        par = [r["times"][key] for r in runs["parent"]]
        chg = [r["times"][key] for r in runs["change"]]
        higher_better = key.endswith("tflops")
        row = {"parent": par, "change": chg,
               "change_over_parent": (sum(chg) / len(chg)) / (sum(par) / len(par)),
               "spread": max(max(par) - min(par), max(chg) - min(chg))}
        if higher_better:
            row["faster_beyond_spread"] = min(chg) > max(par)
        else:
            row["faster_beyond_spread"] = max(chg) < min(par)
        if "float32" in key:
            row["within_5_percent"] = max(chg) <= 1.05 * max(par)
        out[key] = row
    keys = runs["change"][0]["float32_digests"]
    same = {k: len({r["float32_digests"][k] for r in runs["parent"]
                    + runs["change"]}) == 1 for k in keys}
    repeat = {k: all(len({r["float32_digests"][k] for r in rs}) == 1
                     for rs in runs.values()) for k in keys}
    kept = {k: v for k, v in same.items()
            if not set(DIGEST_KERNELS.get(k, (k.split("_")[0],))) & set(changed)}
    return {"phase": "kernels_ab", "metrics": out,
            "float32_bit_identical": all(kept.values()),
            "float32_outputs_differing": sorted(k for k, v in same.items()
                                                if not v),
            "changed": sorted(changed),
            "float32_repeat_bit_identical": all(repeat.values()),
            "float32_not_repeating": sorted(k for k, v in repeat.items()
                                            if not v)}


def routing(runs: int):
    """Kernel #2 under the routing test's profile, ``runs`` times."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pafuse_tpu_torch.ops.attention import (attention_reference,
                                                fused_attention)

    dev = torch.device("cuda")
    r = np.random.RandomState(4)
    C, heads = 224, 8

    def u(shape, fan_in):
        return torch.tensor(r.uniform(-fan_in ** -0.5, fan_in ** -0.5, shape),
                            dtype=torch.float32, device=dev)

    w = (u((3 * C, C), C), u((3 * C,), C), u((C, C), C), u((C,), C))
    x = torch.tensor(np.random.RandomState(3).randn(8, 68, C),
                     dtype=torch.float32, device=dev)
    want = attention_reference(x, *w, heads)
    missing, errs, sets = [], [], {}
    for i in range(runs):
        fused_attention(x, *w, heads)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = fused_attention(x, *w, heads)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        err = float((y - want).abs().max())
        errs.append(err)
        short = tuple(sorted({re.sub(r"<.*", "", n)[:60] for n in names}))
        sets[short] = sets.get(short, 0) + 1
        if not any("sm90::gemm_kernel" in n for n in names):
            missing.append({"run": i, "max_abs_err": err, "kernels": names})
    out = {"phase": "routing", "runs": runs, "gemm_missing": len(missing),
           "missing_runs": missing[:5], "max_abs_err": max(errs),
           "outputs_within_1e-5": sum(e <= 1e-5 for e in errs),
           "kernel_sets": [{"kernels": list(k), "runs": v}
                           for k, v in sets.items()]}
    emit(out)
    if max(errs) > 1e-5:
        raise AssertionError(f"kernel #2 disagrees with attention_reference: "
                             f"{max(errs):.3e}")
    return out


def paired(other: str, flag: str):
    """Run ``flag``'s worker on the other tree, this one, this one and the
    other, each in its own process from its own root; returns their JSON
    lines."""
    other = os.path.abspath(other)
    results = []
    for mode, tree in (("parent", other), ("change", HERE),
                       ("change", HERE), ("parent", other)):
        env = dict(os.environ, PYTHONPATH=tree)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            flag, mode], cwd=tree, env=env,
                           capture_output=True, text=True, timeout=900)
        sys.stderr.write(r.stderr[-3000:])
        if r.returncode != 0:
            raise RuntimeError(f"{mode} worker failed: {r.stderr[-2000:]}")
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                results.append(json.loads(line))
                print(line, flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout of the port")
    ap.add_argument("--routing", type=int, default=0,
                    help="runs of the kernel #2 routing check")
    ap.add_argument("--suite", action="store_true",
                    help="run tests/test_torch_cuda.py in this process first")
    ap.add_argument("--kernels", metavar="DIR",
                    help="the kernel A/B against another checkout of the port")
    ap.add_argument("--changed", default="",
                    help="kernels whose float32 outputs may differ, e.g. "
                         "'#1,#3,#4'")
    ap.add_argument("--worker", choices=("parent", "change"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--kernels-worker", choices=("parent", "change"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.worker or args.kernels_worker:
        sys.path.insert(0, os.getcwd())     # the tree under test comes first
        if args.worker:
            worker(args.worker)
        else:
            kernels_worker(args.kernels_worker)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi})
    results = []
    if args.parent:
        results = paired(args.parent, "--worker")
        summary = {}
        for res in results:
            key = f'{res["window"]}_{res["mode"]}'
            summary.setdefault(key, []).append(res["idle_share"])
        emit({"phase": "idle_shares", "runs": summary})
    if args.kernels:
        sass = sass_compare(os.path.abspath(args.kernels))
        emit(sass)
        if sass["differing"]:
            raise AssertionError(f"kernels whose instructions differ from the "
                                 f"other tree's: {sass['differing']}")
        changed = tuple(k for k in args.changed.split(",") if k)
        summary = kernels_summary(paired(args.kernels, "--kernels-worker"),
                                  changed)
        emit(summary)
        if not summary["float32_bit_identical"]:
            raise AssertionError(f"float32 outputs differ from the other "
                                 f"tree's: {summary['float32_outputs_differing']}")
        if not summary["float32_repeat_bit_identical"]:
            raise AssertionError(f"float32 outputs differ between two runs "
                                 f"of one tree: "
                                 f"{summary['float32_not_repeating']}")
    if args.suite:
        import pytest
        rc = pytest.main([os.path.join(HERE, "tests", "test_torch_cuda.py"),
                          "-m", "cuda", "--noconftest", "-q",
                          "-p", "no:cacheprovider"])
        emit({"phase": "suite", "exit_code": int(rc)})
    if args.routing:
        from pafuse_tpu_torch.ops import _build
        _build.build_all()
        routing(args.routing)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
