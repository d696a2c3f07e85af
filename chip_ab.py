"""Three investigations on the card, each in one call (see PERF.md §6):

1. **Readback A/B** (``--parent DIR``): the device's idle share of the
   training loop and of the evaluation drain, this tree against another
   checkout of the port (e.g. the parent commit unpacked with ``git
   archive``), run parent, change, change, parent, each in its own
   process on its own tree.  Windows: three steps of the H3WB trainer
   (depth 8, 37 sequences) and of the 3DHP trainer through the tree's
   training loop (``train.run_epoch``), and the
   ``eval_profile`` window of ``chip_smoke.py`` (one 152-window action at
   ``use_pallas=true``, P=10, T=1: two 64-row batches and a 24-row tail).
2. **Kernel A/B** (``--kernels DIR``): this tree against another
   checkout of the port (e.g. the parent commit unpacked with ``git
   archive``), ``--runs`` processes a tree (parent, change, change, parent,
   parent, change, ... each in its own process on its own tree; 3 by
   default: two processes of identical code differ by 0.3-0.5%): kernels
   #1, #3 and #4 at serve bucket 16 (16 windows x
   P=10 x flip, 27 frames; #1 one spatial and one temporal block of each
   part, #3 the temporal blocks, #4 one layer of each part) in float32 and
   bfloat16, the bfloat16 GEMM alone (``ops.gemm.fused_linear``, the four
   stages of each part at bucket 16), #2 at bucket 16 and #5/#6 at the
   training shapes in float32, a 405-frame request of a bfloat16
   ``LiftingService`` (depth 8, P=10, T=5), a bfloat16 ``use_pallas=auto``
   evaluation of the 76-window action (synthetic S8, 500 frames), the same
   evaluation in float32 at ``use_pallas=true`` (kernel #2), and a
   float32 training step (depth 8, 37 sequences), then the streamed
   attention kernels at MixSTE's shapes (8 heads; STREAMED_FWD in float32
   and bfloat16 and STREAMED_BWD, each beside its plain version and SDPA,
   or SDPA's autograd, on the same inputs; every forward on the route the
   library takes), kernel #1 in bfloat16 at MixSTE's two serve windows
   (MIXSTE_WINDOWS) beside its library composition, and 3 depth-8
   training steps of MixSTE's model (``model.cs=512
   model.number_of_frames=243``, 4 sequences); times are device ms (CUDA
   events) or host ms ending in a synchronisation.  ``--only streamed``
   runs the streamed kernels, MixSTE's #1 and its steps alone, ``--only
   serve`` the bfloat16 request and
   evaluation alone, ``--only train`` the float32 hashes of #1-#6 (no
   times), #6's weight- and bias-gradient stage alone at H3WB's and
   MixSTE's shapes (WGRAD_ROWS), product by product and summed, beside its
   bound and cuBLAS's ``d.t() @ x`` (and with ``d.sum(0)``), with its
   ordered pass's own time, #6's LayerNorm backward alone in its three forms at
   LN_ROWS (ln_section: device ms beside ln_bwd_bound_ms and aten's
   ``native_layer_norm_backward`` with the residual add and the mask
   multiply; ``F.layer_norm`` beside #5's forward LayerNorm's bound), the
   ordered sums' bound, the H3WB float32 step with one more under
   torch.profiler and MixSTE's steps with one more (their device ms by
   chip_smoke.py's kernel groups, reported per tree), ``--only resident`` the float32 hashes of #1-#6, the
   resident attention stages at their main-path shapes (RESIDENT_BWD,
   RESIDENT_FWD: H3WB's, 3DHP's, the monolithic model's and MixSTE's
   spatial blocks) beside their plain versions and SDPA (or its autograd),
   each stage's bound and the launches of one call by kernel, then the
   H3WB step with a profiled one and MixSTE's steps (the backward also
   at RESIDENT_BWD_LONG; ``--only stages``: the resident stages alone);
   ``--only fwd`` the float32 hashes of #1-#6, the float32 attention
   forward alone at its main-path shapes (fwd_section: #1's six stages at
   serve bucket 16, #2's at window batch 64 and FWD_GROUPS) beside SDPA, its
   plain version and its bound, #1's stages at bucket 16 (chain_section,
   with the LayerNorms' bounds and F.layer_norm's time), float32 serve
   requests at SERVE_FRAMES, the float32 ``auto`` and ``true`` evaluation
   and the H3WB step with a profiled one;
   ``--alt DIR`` times a third tree in the same turns
   (e.g. this tree with one part of the change taken out; its hashes must
   agree too, its SASS is not compared).  Beside the
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
   #6, and so do MixSTE's steps; #6's input gradient dx and its
   LayerNorm parameters' gradients are hashed apart from its weight and
   bias gradients, as ``#6dx`` and ``#6ln``).  The streamed kernels' outputs are
   hashed too (float32 and bfloat16) and must be equal across the trees,
   but where ``--changed`` names them: ``#6`` owns the streamed backward's
   hashes, ``bf16`` the bfloat16 streamed forward's.
   First it compiles both trees' CUDA sources and holds the SASS of every
   kernel the two have in common equal (the float32 GEMM's instantiations
   among them), but for the kernels whose names hold one of the
   ``--redesigned`` names.
3. **ptxas** (``--ptxas [DIR]``): registers, spill bytes and wgmma notes
   of the kernels of PTXAS_SOURCES (the attention libraries, #6's library
   with the LayerNorm and weight-gradient kernels, the GEMM, #1's chain,
   #2's), on this tree or on the checkout DIR.
4. **Precision witness** (``--witness``): this tree's attention backward
   and its plain version in float32, each against the plain version in
   float64, at the cuda suite's 1000-token shapes (WITNESS_BWD).

    python3 chip_ab.py --parent build/parent
    python3 chip_ab.py --kernels build/parent [--changed '#2,#5,#6'] \
        [--redesigned attention_stream_kernel,attention_bwd_stream_] \
        [--runs 3] [--only streamed|serve|train] [--alt DIR]
    python3 chip_ab.py --kernels build/parent --only streamed \
        --changed '#6,bf16' --redesigned attention_stream_kernel,attention_bwd_stream_
    python3 chip_ab.py --kernels build/parent --only train --changed '#6' \
        --redesigned wgrad_,reduce_partials_kernel
    python3 chip_ab.py --kernels build/parent --only train \
        --changed '#6,#6dx,#6ln' --redesigned ln_bwd_kernel,ln_sums_kernel
    python3 chip_ab.py --kernels build/parent --only resident \
        --changed '#2,#5,#6' 
    python3 chip_ab.py --kernels build/parent --only fwd
    python3 chip_ab.py --route-tree pack build/pack --kernels build/parent \
        --only stages --alt build/pack --changed '#6' --redesigned attention_bwd_
    python3 chip_ab.py --witness
    python3 chip_ab.py --ptxas

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
DIGEST_KERNELS = {"train_window": ("#5", "#6"), "mixste_window": ("#5", "#6")}


def digest_kernels(key):
    """The kernels a hash belongs to: DIGEST_KERNELS, the streamed backward's
    to #6 (its attention backward), the bfloat16 streamed forward's to
    ``bf16``, else the key's first word."""
    if key in DIGEST_KERNELS:
        return DIGEST_KERNELS[key]
    if key.startswith(("stream_bwd", "resident_bwd")):
        return ("#6",)
    if key.startswith("resident_fwd"):
        return ("#2", "#5")
    if key.endswith("_bfloat16") and "_fwd_" in key:
        return ("bf16",)
    return (key.split("_")[0],)


#: the streamed forward's shapes (B, L, C at 8 heads), in float32 and
#: bfloat16: MixSTE's temporal attention at 243 frames (cs 512, d = 64) and
#: at 351 (cs 512 and 384), d = 128 (cs 1024) at its 243 frames and 134
#: joints, and 243 frames at d = 48; the first and the last on the route
#: the library takes in each dtype (float32 resident at d = 48)
STREAMED_FWD = ((536, 243, 512), (536, 351, 512), (536, 351, 384),
                (536, 243, 1024), (972, 134, 1024), (64, 243, 384))
#: kernel #1's MixSTE serve windows (frames, P: chip_smoke.py's
#: MIXSTE_WINDOWS) at cs 512, one window, flip on
MIXSTE_WINDOWS = ((243, 10), (351, 5))
#: the streamed backward's: MixSTE's temporal block at 243 and 351 frames,
#: and d = 128 at 243
STREAMED_BWD = ((536, 243, 512), (536, 351, 512), (536, 243, 1024))
MIXSTE_SEQS = 1024 // 243
#: the resident attention backward's main-path shapes (B, L, C at 8 heads):
#: H3WB's six training shapes (37 sequences x 27 frames, each part's
#: spatial and temporal block), the monolithic model's pair, 3DHP's pair
#: and MixSTE's spatial block (4 sequences x 243 frames, 134 joints)
RESIDENT_BWD = ((999, 24, 384), (888, 27, 384), (999, 68, 224),
                (2516, 27, 224), (999, 42, 256), (1554, 27, 256),
                (999, 134, 288), (4958, 27, 288), (999, 17, 288),
                (629, 27, 288), (972, 134, 512))
#: the backward at 243 frames at each part width (d = 28, 32, 36, 48; 64
#: sequences x 8 heads, as the cuda suite's): past one key chunk, where the
#: routes between the wgmma, the mma.sync and the streamed kernels part
RESIDENT_BWD_LONG = ((64, 243, 224), (64, 243, 256), (64, 243, 288),
                     (64, 243, 384))
#: the float32 forward's shapes at 134 keys: the monolithic model's and
#: MixSTE's spatial blocks
RESIDENT_FWD = ((999, 134, 288), (972, 134, 512))
#: the float32 resident forward's shapes by group (B, L, C at 8 heads):
#: #1's six stages at serve bucket 16 and #2's at window batch 64
#: (chip_smoke.block_cases: 16 or 64 windows x P=10 x flip, 27 frames, each
#: part's spatial and temporal block), #5's six at the H3WB step
#: (RESIDENT_BWD's first six), 3DHP's pair, and 243 frames at each part
#: width (past 144 keys: resident at d <= 32, streamed at d = 36, 48)
FWD_GROUPS = {"h3wb": RESIDENT_BWD[:6], "dhp3": RESIDENT_BWD[8:10],
              "long": RESIDENT_BWD_LONG}
#: requests of the float32 serve A/B (frames)
SERVE_FRAMES = (27, 100, 405)
#: trees that differ from this one only in the backward's route
#: (attention_bwd_sm90.cuh), for --route-tree: "pack" sends every unit of
#: up to 64 keys at d <= 48 to attention_bwd_pack_kernel (one warpgroup a
#: CTA, 64 // L-rounded-up-to-8 units a block, S and dP once), "wg" every
#: unit of up to 256 keys at d <= 48 to attention_bwd_wg_kernel (two
#: warpgroups a unit, 64-row blocks); each patch is (text, its replacement)
ROUTE_PATCHES = {
    "pack": (("constexpr bool PACK_SHORT_UNITS = false;",
              "constexpr bool PACK_SHORT_UNITS = true;"),),
    "wg": (("if (L <= ONE_CHUNK || L > MAX_ROWS || d < 1 || d > 48) return false;",
            "if (L < 1 || L > MAX_ROWS || d < 1 || d > 48) return false;"),),
}


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
    out = idle_profile(
        lambda: tr.run_epoch(step, state, 6e-5, batches[2:], SEQS), dev)
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


def _device_ms(fn, reps=10, warm=2):
    """The device time of one ``fn()`` call, for a wrapper whose host work
    is about as long as its kernels (where back-to-back CUDA events would
    time the host): the ``reps`` calls are queued behind a spin of the
    device (``torch.cuda._sleep``), so the events around them see the
    device alone; the spin grows until the first event is still pending
    when the last call has been queued."""
    import torch
    for _ in range(warm):
        fn()
    cycles = 1 << 24                # ~9 ms at the H100's clock
    while cycles <= 1 << 32:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        stop.record()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise RuntimeError("_device_ms: the host could not queue the calls ahead "
                       "of the device")


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


def streamed_section(times, digests, dev):
    """The streamed attention kernels at STREAMED_FWD (float32 and
    bfloat16, each on the route the library takes) and STREAMED_BWD: device
    ms of the kernel (``ops.attention_core``), of its plain version and of
    SDPA (the forward) or SDPA's autograd (the backward) on the same seeded
    inputs, and a hash of each kernel output."""
    import hashlib
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.attention_core import (
        attention_core, attention_core_bwd, attention_core_bwd_reference,
        attention_core_reference)
    heads = 8

    def digest(key, out):
        digests[key] = hashlib.sha256(
            out.float().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    def split_heads(qkv):
        B, L, C3 = qkv.shape
        return qkv.view(B, L, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1, 4)

    for i, (B, L, C) in enumerate(STREAMED_FWD):
        for dtype in ("float32", "bfloat16"):
            gen = torch.Generator(device=dev).manual_seed(500 + i)
            qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev).to(
                getattr(torch, dtype))
            key = f"stream_fwd_{B}x{L}x{C}_{dtype}"
            times[f"{key}_ms"] = _cuda_ms(lambda: attention_core(qkv, heads))
            digest(key, attention_core(qkv, heads))
            q, k, v = split_heads(qkv)
            times[f"{key}_sdpa_ms"] = _cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))
            times[f"{key}_plain_ms"] = _cuda_ms(
                lambda: attention_core_reference(qkv, heads))
            del qkv, q, k, v
    for i, (B, L, C) in enumerate(STREAMED_BWD):
        gen = torch.Generator(device=dev).manual_seed(600 + i)
        qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev)
        do = torch.randn(B, L, C, generator=gen, device=dev)
        key = f"stream_bwd_{B}x{L}x{C}_float32"
        times[f"{key}_ms"] = _cuda_ms(lambda: attention_core_bwd(qkv, do, heads))
        digest(key, attention_core_bwd(qkv, do, heads))
        q, k, v = (t.detach().requires_grad_() for t in split_heads(qkv))
        o = F.scaled_dot_product_attention(q, k, v)
        go = do.view(B, L, heads, C // heads).transpose(1, 2)
        times[f"{key}_sdpa_ms"] = _cuda_ms(lambda: torch.autograd.grad(
            o, (q, k, v), go, retain_graph=True))
        times[f"{key}_plain_ms"] = _cuda_ms(
            lambda: attention_core_bwd_reference(qkv, do, heads))
        del qkv, do, q, k, v, o, go
        torch.cuda.empty_cache()


def resident_section(times, digests, dev):
    """The resident float32 attention stages at RESIDENT_BWD (the backward)
    and RESIDENT_FWD (the forward), each on the route the library takes:
    device ms of the kernel (``ops.attention_core``), of its plain version
    and of SDPA's autograd (the backward) or SDPA (the forward) on the same
    seeded inputs, the stage's bound (``attention_bound_ms``), the
    library's launch counts of one call by kernel, and a hash of each kernel
    output (twice: a call repeats bit for bit)."""
    import hashlib
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.ops.attention_core import (
        attention_core, attention_core_bwd, attention_core_bwd_reference,
        attention_core_reference)
    heads = 8

    def digest(key, fn):
        outs = [hashlib.sha256(fn().float().contiguous().cpu().numpy()
                               .tobytes()).hexdigest()[:16] for _ in range(2)]
        if outs[0] != outs[1]:
            raise AssertionError(f"{key}: two calls differ")
        digests[key] = outs[0]

    def split_heads(qkv):
        B, L, C3 = qkv.shape
        return qkv.view(B, L, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1, 4)

    def launches(fn):
        for lib in ("attention_core", "attention_core_bwd"):
            _build.kernel_launches(lib, zero=True)
        fn()
        torch.cuda.synchronize()
        return {f"{lib}:{k}": n for lib in ("attention_core", "attention_core_bwd")
                for k, n in _build.kernel_launches(lib).items() if n}

    routes = {}
    for i, (B, L, C) in enumerate(RESIDENT_FWD):
        gen = torch.Generator(device=dev).manual_seed(700 + i)
        qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev)
        key = f"resident_fwd_{B}x{L}x{C}_float32"
        times[f"{key}_ms"] = _cuda_ms(lambda: attention_core(qkv, heads))
        digest(key, lambda: attention_core(qkv, heads))
        routes[key] = launches(lambda: attention_core(qkv, heads))
        q, k, v = split_heads(qkv)
        times[f"{key}_sdpa_ms"] = _cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
        times[f"{key}_plain_ms"] = _cuda_ms(
            lambda: attention_core_reference(qkv, heads))
        times[f"{key}_bound_ms"] = attention_bound_ms(B, L, C, False)
        del qkv, q, k, v
    for i, (B, L, C) in enumerate(RESIDENT_BWD + RESIDENT_BWD_LONG):
        gen = torch.Generator(device=dev).manual_seed(800 + i)
        qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev)
        do = torch.randn(B, L, C, generator=gen, device=dev)
        key = f"resident_bwd_{B}x{L}x{C}_float32"
        times[f"{key}_ms"] = _cuda_ms(lambda: attention_core_bwd(qkv, do, heads))
        digest(key, lambda: attention_core_bwd(qkv, do, heads))
        routes[key] = launches(lambda: attention_core_bwd(qkv, do, heads))
        q, k, v = (t.detach().requires_grad_() for t in split_heads(qkv))
        o = F.scaled_dot_product_attention(q, k, v)
        go = do.view(B, L, heads, C // heads).transpose(1, 2)
        times[f"{key}_sdpa_ms"] = _cuda_ms(lambda: torch.autograd.grad(
            o, (q, k, v), go, retain_graph=True))
        times[f"{key}_plain_ms"] = _cuda_ms(
            lambda: attention_core_bwd_reference(qkv, do, heads))
        times[f"{key}_bound_ms"] = attention_bound_ms(B, L, C, True)
        del qkv, do, q, k, v, o, go
        torch.cuda.empty_cache()
    return routes


def fwd_section(times, digests, dev):
    """The float32 attention forward alone at FWD_GROUPS and #1's and #2's
    stages (serve bucket 16, window batch 64), each on the route the
    library takes: device ms of the kernel (``ops.attention_core``), of SDPA
    and of the plain version on the same seeded inputs, the stage's bound
    (``attention_bound_ms``), each group's sums, the library's launch counts
    of one call by kernel, and a hash of each output (twice: a call repeats
    bit for bit).  Returns the launch counts by stage."""
    import hashlib
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.ops.attention_core import (attention_core,
                                                     attention_core_reference)
    heads = 8
    groups = {"serve16": tuple(c[2:] for c in chip_smoke.block_cases(16, 10, 27)),
              "eval64": tuple(c[2:] for c in chip_smoke.block_cases(64, 10, 27)),
              **FWD_GROUPS}
    routes = {}
    for g, shapes in groups.items():
        for key in ("ms", "sdpa_ms", "plain_ms", "bound_ms"):
            times[f"fwd_{g}_{key}"] = 0.0
        for i, (B, L, C) in enumerate(shapes):
            gen = torch.Generator(device=dev).manual_seed(900 + i)
            qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev)
            key = f"resident_fwd_{g}_{B}x{L}x{C}_float32"
            outs = [hashlib.sha256(attention_core(qkv, heads).cpu().numpy().tobytes())
                    .hexdigest()[:16] for _ in range(2)]
            if outs[0] != outs[1]:
                raise AssertionError(f"{key}: two calls differ")
            digests[key] = outs[0]
            _build.kernel_launches("attention_core", zero=True)
            attention_core(qkv, heads)
            torch.cuda.synchronize()
            routes[key] = {k: n for k, n in
                           _build.kernel_launches("attention_core").items() if n}
            q, k, v = qkv.view(B, L, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
            row = {"ms": _cuda_ms(lambda: attention_core(qkv, heads)),
                   "sdpa_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   "plain_ms": _cuda_ms(lambda: attention_core_reference(qkv, heads)),
                   "bound_ms": attention_bound_ms(B, L, C, False)}
            for name, ms in row.items():
                times[f"{key}_{name}"] = ms
                times[f"fwd_{g}_{name}"] += ms
            del qkv, q, k, v
            torch.cuda.empty_cache()
    return routes


def chain_section(times, dev):
    """Kernel #1 in float32 at serve bucket 16 (chip_smoke.block_cases), one
    profiled call a shape (chip_smoke.chain_stages): device ms by stage
    summed over the six calls (``chain_<stage>_ms``: the attention, the
    outer LayerNorm ``layernorm_kernel``, LN1's and LN2's row statistics
    ``row_stats_kernel``, the GEMMs, the weight split), the LayerNorms'
    bounds (the outer one reads x and writes y once, 8 M C bytes; each row
    statistics pass reads x once and writes two floats a row, 4 M C + 8 M;
    at 3.35 TB/s) and F.layer_norm's ms for the three LayerNorms of each
    call on the same rows (the library's call for what the chain does in
    three kernels, two of them inside GEMM prologues)."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from pafuse_tpu_torch.ops.block import fused_block
    heads = 8
    times["chain_ln_bound_ms"] = times["chain_row_stats_bound_ms"] = 0.0
    times["chain_layer_norm_library_ms"] = 0.0
    for i, (part, kind, B, L, C) in enumerate(chip_smoke.block_cases(16, 10, 27)):
        p = _block_params(C, 100 + i, dev)
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        x = torch.randn(B, L, C, generator=gen, device=dev)
        for stage, ms in chip_smoke.chain_stages(
                lambda: fused_block(x, p[:12], p[12:], heads)).items():
            times[f"chain_{stage}_ms"] = times.get(f"chain_{stage}_ms", 0.0) + ms
        M = B * L
        times["chain_ln_bound_ms"] += 8 * M * C / 3.35e12 * 1e3
        times["chain_row_stats_bound_ms"] += 2 * (4 * M * C + 8 * M) / 3.35e12 * 1e3
        rows = x.view(M, C)
        times["chain_layer_norm_library_ms"] += 3 * _cuda_ms(
            lambda: F.layer_norm(rows, (C,), p[0], p[1]))
        del x, rows
        torch.cuda.empty_cache()


def attention_bound_ms(B, L, C, backward):
    """The least time an H100 SXM (700 W data-sheet peaks) could take for
    one float32 attention stage: the larger of its operations (forward 4
    B L^2 C, backward 10 B L^2 C) at 165 TFLOP/s (495 TF32 / the three
    products float32 takes) and its bytes (qkv read and the output written
    once, 16 B L C; the backward also dO read and dqkv written, 28 B L C) at
    3.35 TB/s."""
    ops = (10 if backward else 4) * B * L * L * C
    nbytes = (28 if backward else 16) * B * L * C
    return max(ops / 165e12, nbytes / 3.35e12) * 1e3


def ordered_sums_bound_ms(depth=8, seqs=SEQS, frames=27):
    """The least time an H100 SXM (3.35 TB/s at 700 W) could take for the
    ordered partial sums of one float32 H3WB training step (#6's
    reduce_partials_kernel): every part's spatial and temporal block at
    ``depth`` layers, each call's four weight products (partials of
    ``weight_grad_chunk_rows`` chunks of N K + N floats: dW and db) and
    three LayerNorm backwards (ceil(M / 64) partials of 2C floats), each
    partial read once and each sum written once."""
    from pafuse_tpu_torch.models.parts import PART_CHANNELS
    from pafuse_tpu_torch.ops.block_train import weight_grad_chunk_rows
    from pafuse_tpu_torch.skeleton import parts_table
    nbytes = 0
    for name, joints in parts_table(True).items():
        C = PART_CHANNELS[name]
        M = seqs * frames * len(joints)
        for N, K in ((3 * C, C), (C, C), (2 * C, C), (C, 2 * C)):
            chunks = -(-M // weight_grad_chunk_rows(M, N, K))
            nbytes += 2 * depth * 4 * (chunks + 1) * (N * K + N)
        nbytes += 2 * depth * 3 * 4 * (ln_partials(M, C) + 1) * 2 * C
    return nbytes / 3.35e12 * 1e3


def ln_partials(M, C):
    """The LayerNorm backward's partials of 2C floats in a call over M rows
    of C: one a CTA of the tree's ``ln_backward_rows(M, C)`` rows, or, in a
    tree without that rule, one a 64 rows."""
    from pafuse_tpu_torch.ops import block_train as bt
    rows = getattr(bt, "ln_backward_rows", None)
    return -(-M // (rows(M, C) if rows else 64))


def ln_bwd_bound_ms(M, C, form, seq_len=1):
    """The least time an H100 SXM (3.35 TB/s at 700 W) could take for one
    float32 LayerNorm backward of #6 over M rows of C, by its bytes: g and
    x read and dx written (16 B an element), the LN2 form ("ln2") also the
    residual read and the outer and LN2 forms dxm = mask * dx written; the
    row statistics (8 B a row), the mask (4 B a sequence of seq_len rows),
    the scale read and dscale, dbias written (12 B a column), and the
    tree's partials written and read once (16 B a column a partial)."""
    per = {"outer": 16, "ln2": 20, "ln1": 16}[form]
    nbytes = (per * M * C + 8 * M + (4 * (M // seq_len) if form != "ln1" else 0)
              + 12 * C + 16 * ln_partials(M, C) * C)
    return nbytes / 3.35e12 * 1e3


#: (rows M, width C, sequence length L) of #6's LayerNorm backward: H3WB's
#: three parts (37 sequences x 27 frames x their joints) and MixSTE's
#: (model.cs 512: 4 x 243 frames x 134 joints); a part's spatial and
#: temporal blocks have the same M and C, and each block of the 16 a step
#: (8 layers, two kinds) calls it three times, once in each form
LN_ROWS = {"h3wb": ((999 * 24, 384, 27), (999 * 68, 224, 27), (999 * 42, 256, 27)),
           "mixste": ((4 * 243 * 134, 512, 243),)}
LN_BLOCKS = 16


def ln_section(times, dev):
    """#6's LayerNorm backward alone on seeded float32 inputs at LN_ROWS,
    in its three forms (outer: g and x, dx and dxm = mask * dx; LN2: the
    residual as well; LN1: the residual, no mask): the tree's own call
    (``ops.block_train.ln_backward``; a tree without one has no such time:
    its kernel's time is the profiled step's "LayerNorm backward" group),
    and the library composition of the same function (aten's
    ``native_layer_norm_backward``, the residual add and the mask multiply),
    device ms per form and width (``ln_bwd_<form>_<C>_*``) and summed as a
    step launches them (``ln_bwd_<model>_*``, x LN_BLOCKS), beside
    ln_bwd_bound_ms; device ms of the calls (_device_ms: the wrapper's
    host work is about as long as its kernels).  Then #5's forward
    LayerNorm's yardstick at the same shapes: ``F.layer_norm``, three a
    block, and its bound (x read and y written, 8 B an element, and the row
    statistics written)."""
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops import block_train as bt
    fn = getattr(bt, "ln_backward", None)
    for model, shapes in LN_ROWS.items():
        for i, (M, C, L) in enumerate(shapes):
            gen = torch.Generator(device=dev).manual_seed(700 + i)
            x, g, r = (torch.randn(M, C, generator=gen, device=dev) for _ in range(3))
            scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            mean = x.mean(1)
            rstd = torch.rsqrt(x.var(1, unbiased=False) + 1e-6)
            B = M // L
            mask = torch.tensor([0.0, 1 / 0.9, 1.0], device=dev)[
                torch.arange(B, device=dev) % 3]
            for form, kw in (("outer", {"mask": mask}),
                             ("ln2", {"residual": r, "mask": mask}),
                             ("ln1", {"residual": r})):
                def library():
                    dx, ds, db = torch.ops.aten.native_layer_norm_backward(
                        g, x, [C], mean[:, None], rstd[:, None], scale, bias,
                        [True, True, True])
                    if "residual" in kw:
                        dx = r + dx
                    if "mask" in kw:
                        return dx, dx.view(B, L, C) * mask[:, None, None], ds, db
                    return dx, ds, db

                timed = {"library_ms": _device_ms(library),
                         "bound_ms": ln_bwd_bound_ms(M, C, form, L)}
                if fn is not None:
                    timed["ms"] = _device_ms(lambda: fn(g, x, mean, rstd, scale,
                                                        seq_len=L, **kw))
                for k, v in timed.items():
                    times[f"ln_bwd_{form}_{C}_{k}"] = v
                    key = f"ln_bwd_{model}_{k}"
                    times[key] = times.get(key, 0.0) + LN_BLOCKS * v
            ms = _device_ms(lambda: F.layer_norm(x, (C,), scale, bias, 1e-6))
            for k, v in (("library_ms", ms),
                         ("bound_ms", (8 * M * C + 8 * M) / 3.35e12 * 1e3)):
                key = f"ln_fwd_{model}_{k}"
                times[key] = times.get(key, 0.0) + 3 * LN_BLOCKS * v
            del x, g, r
            torch.cuda.empty_cache()
        if fn is not None:
            times[f"ln_bwd_{model}_share_of_bound"] = (
                times[f"ln_bwd_{model}_bound_ms"] / times[f"ln_bwd_{model}_ms"])


def _library_block(x, bp, on, heads):
    """Kernel #1's block as one composition of PyTorch library calls
    (layer_norm, cuBLAS linear, SDPA in chunks of 32768 sequences, gelu),
    as chip_smoke.py's library_block: the yardstick, never the port's."""
    import torch
    import torch.nn.functional as F
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2,
     bfc2) = bp
    B, L, C = x.shape
    h = F.layer_norm(x, (C,), n1s, n1b, 1e-6)
    q, k, v = F.linear(h, wqkv, bqkv).view(B, L, 3, heads, C // heads).permute(
        2, 0, 3, 1, 4)
    a = torch.cat([F.scaled_dot_product_attention(
        q[i:i + 32768], k[i:i + 32768], v[i:i + 32768])
        for i in range(0, B, 32768)]).transpose(1, 2).reshape(B, L, C)
    x = x + F.linear(a, wproj, bproj)
    x = x + F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), n2s, n2b, 1e-6),
                                     wfc1, bfc1)), wfc2, bfc2)
    return F.layer_norm(x, (C,), on[0], on[1], 1e-6)


def mixste_block_section(times, dev):
    """Kernel #1 in bfloat16 at MixSTE's serve windows (MIXSTE_WINDOWS,
    cs 512, 8 heads): device ms of one spatial (B = P*2*frames sequences of
    134 joints) and one temporal block (B = P*2*134 sequences of the
    frames) summed a window, beside the library composition of the same
    blocks."""
    import torch
    from pafuse_tpu_torch.ops.block import fused_block
    heads, C = 8, 512
    for i, (frames, P) in enumerate(MIXSTE_WINDOWS):
        key = f"#1_mixste{frames}_bfloat16"
        for j, (B, L) in enumerate(((P * 2 * frames, 134), (P * 2 * 134, frames))):
            params = _block_params(C, 700 + 10 * i + j, dev)
            bp, on = params[:12], params[12:]
            gen = torch.Generator(device=dev).manual_seed(800 + 10 * i + j)
            x = torch.randn(B, L, C, generator=gen, device=dev).to(torch.bfloat16)
            lib_bp = [t.to(torch.bfloat16) for t in bp]
            lib_on = [t.to(torch.bfloat16) for t in on]
            times[f"{key}_ms"] = times.get(f"{key}_ms", 0.0) + _cuda_ms(
                lambda: fused_block(x, bp, on, heads))
            times[f"{key}_library_ms"] = times.get(f"{key}_library_ms", 0.0) + _cuda_ms(
                lambda: _library_block(x, lib_bp, lib_on, heads))
            del x
        torch.cuda.empty_cache()


def mixste_section(times, digests, dev, traced=False):
    """3 training steps (after 2 warm ones) of MixSTE's model at depth 8
    (``model.cs=512 model.number_of_frames=243``, monolithic, 4 sequences
    a step, as chip_smoke.py's mixste243 phase): host ms a step, ending in
    its loss, and a hash of the losses and parameters; with ``traced``, one
    more step under torch.profiler, its device ms by kernel group in
    times["traced_mixste_groups_ms"] (after the hash)."""
    import hashlib
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

    subjects = ["S1", "S5", "S6", "S7"]
    ds = h3wb.load_dataset(synthetic=True, subjects=tuple(subjects), seed=0)
    kp = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(subjects, kp, ds)
    sampler = ChunkedSampler(MIXSTE_SEQS, cams, p3d, p2d, 243, shuffle=True,
                             augment=True, flip_permutation=ds.flip_permutation)
    cfg = D3DPConfig(depth=8, part_based=False, cs=512, frames=243,
                     drop_path_rate=0.1)
    model = D3DP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    state = tr.create_train_state(model, seed=0, device=dev)
    step = tr.build_train_step(model, state.optimizer, part_based=False)
    batches = []
    for _, b3d, b2d in sampler.next_epoch():
        batches.append((tr.pad_batch(b2d, MIXSTE_SEQS)[0],
                        tr.pad_batch(b3d, MIXSTE_SEQS)[0]))
        if len(batches) == 2 + STEPS:
            break
    losses = [float(step(state, 6e-5, b2d, b3d)) for b2d, b3d in batches[:2]]
    torch.cuda.synchronize()
    t0 = time.time()
    for b2d, b3d in batches[2:]:
        losses.append(float(step(state, 6e-5, b2d, b3d)))
    times["mixste_step_float32_ms"] = (time.time() - t0) * 1e3 / STEPS
    h = hashlib.sha256(torch.tensor(losses).numpy().tobytes())
    for q in model.parameters():
        h.update(q.detach().float().contiguous().cpu().numpy().tobytes())
    digests["mixste_window"] = h.hexdigest()[:16]
    if traced:
        b2d, b3d = batches[-1]
        times["traced_mixste_groups_ms"] = traced_groups(
            lambda: float(step(state, 6e-5, b2d, b3d)))
    del model, state, step
    torch.cuda.empty_cache()


def _eval_action():
    """A function that evaluates the 76-window action (synthetic S8, 500
    frames) with a model (P=10, T=5, flip-TTA, window batch 64), ending in
    a synchronisation."""
    import numpy as np
    import torch
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.evaluate import evaluate_sequences

    ds = h3wb.load_dataset(synthetic=True, actions_per_subject=1,
                           frames_per_action=500)
    kp3 = h3wb.prepare_data(ds)
    cams, p3d, p2d = h3wb.fetch(["S8"], kp3, ds)
    eval_seqs = list(zip(cams, p3d, p2d))[:4]

    def evaluate(model):
        acc, _ = evaluate_sequences(model, eval_seqs, receptive_field=27,
                                    num_proposals=10, sampling_timesteps=5,
                                    window_batch=64)
        torch.cuda.synchronize()
        assert all(np.all(np.isfinite(v)) for v in acc.means_mm().values())

    return evaluate


def serve_405_ms(dev, compute_dtype="float32", frames=(405,)):
    """A request of each of ``frames`` frames to a ``LiftingService`` in
    ``compute_dtype`` (depth 8, P=10, T=5, buckets 1..16): host ms, the
    median of 3 after a warm one (a list where several lengths are asked,
    a number for one)."""
    import numpy as np
    import torch
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.serve import LiftingService

    model = D3DP(D3DPConfig(depth=8), device=dev,
                 generator=torch.Generator().manual_seed(0),
                 compute_dtype=compute_dtype)
    svc = LiftingService(model, buckets=(1, 2, 4, 8, 16), device=dev)
    svc.warmup()
    got = []
    for n in frames:
        kp = np.random.RandomState(0).uniform(-1, 1, (n, 134, 2)).astype(
            np.float32)
        svc.lift(kp, seed=0)
        lat = []
        for _ in range(3):
            t0 = time.time()
            svc.lift(kp, seed=0)
            torch.cuda.synchronize()
            lat.append((time.time() - t0) * 1e3)
        got.append(float(np.median(lat)))
    svc.close()
    del svc, model
    torch.cuda.empty_cache()
    return got if len(got) > 1 else got[0]


def serve_section(times, dev):
    """The bfloat16 host-clock paths: a 405-frame request of the service
    (serve_405_ms) and the use_pallas=auto evaluation of the 76-window
    action (one after a warm one).  Returns the evaluation of
    ``_eval_action()``."""
    import torch
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

    times["bf16_serve_405_ms"] = serve_405_ms(dev, "bfloat16")
    evaluate = _eval_action()
    model = D3DP(D3DPConfig(depth=8), device=dev,
                 generator=torch.Generator().manual_seed(0),
                 compute_dtype="bfloat16")
    evaluate(model)
    t0 = time.time()
    evaluate(model)
    times["bf16_eval_auto_s"] = time.time() - t0
    del model
    return evaluate


#: (rows M, width C) of #6's weight-gradient stage: H3WB's parts (37
#: sequences x 27 frames x their joints) and MixSTE's two blocks (4 x 243
#: frames x 134 joints, model.cs 512), each block's four products (fc2,
#: fc1, proj, qkv)
WGRAD_ROWS = {"h3wb": ((999 * 24, 384), (999 * 68, 224), (999 * 42, 256)),
              "mixste": ((4 * 243 * 134, 512), (4 * 243 * 134, 512))}
WGRAD_BLOCKS = {"h3wb": ("body", "face", "hands"), "mixste": ("block0", "block1")}


def _pass_ms(calls):
    """The device ms of the ordered pass (``reduce_partials_kernel``) of
    each of ``calls``, run once each in order under one torch.profiler
    session (each call launches one pass; a tree without the pass reads
    0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    ms = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "reduce_partials_kernel" in e.name)
    return [t for _, t in ms] if len(ms) == len(calls) else [0.0] * len(calls)


def train_section(times, dev):
    """#6's weight- and bias-gradient stage alone on seeded float32 d and x
    at WGRAD_ROWS, product by product (``wgrad_<model>_<block>_<stage>_*``)
    and summed over each model's (``wgrad_<model>_*``): the tree's own call
    (``ops.block_train.weight_grads``, dW and db; a tree that has only
    ``weight_grad`` takes dW alone, its bias sums ran apart in the
    backward), its device ms and TFLOP/s (2 M N K), the bound (the larger
    of 2 M N K at 165 TFLOP/s and the bytes, d and x read and dW and db
    written, at 3.35 TB/s), cuBLAS's ``d.t() @ x`` and that with
    ``d.sum(0)``, and the ordered pass's device ms alone (``pass_ms``,
    torch.profiler)."""
    import torch
    from pafuse_tpu_torch.ops import block_train as bt
    stage = getattr(bt, "weight_grads", None) or bt.weight_grad
    for model, blocks in WGRAD_ROWS.items():
        flop = 0
        calls, keys = [], []
        for i, (M, C) in enumerate(blocks):
            for j, (name, (N, K)) in enumerate(zip(
                    ("fc2", "fc1", "proj", "qkv"),
                    ((C, 2 * C), (2 * C, C), (C, C), (3 * C, C)))):
                gen = torch.Generator(device=dev).manual_seed(900 + 10 * i + j)
                d = torch.randn(M, N, generator=gen, device=dev)
                x = torch.randn(M, K, generator=gen, device=dev)
                key = f"wgrad_{model}_{WGRAD_BLOCKS[model][i]}_{name}"
                f = 2 * M * N * K
                times[f"{key}_bound_ms"] = max(
                    f / 165e12, 4 * (M * (N + K) + N * K + N) / 3.35e12) * 1e3
                for what, fn in (("ms", lambda: stage(d, x)),
                                 ("cublas_ms", lambda: d.t() @ x),
                                 ("cublas_sum_ms", lambda: (d.t() @ x, d.sum(0)))):
                    times[f"{key}_{what}"] = _cuda_ms(fn)
                times[f"{key}_tflops"] = f / times[f"{key}_ms"] / 1e9
                for what in ("ms", "cublas_ms", "cublas_sum_ms", "bound_ms"):
                    times[f"wgrad_{model}_{what}"] = (times.get(f"wgrad_{model}_{what}", 0.0)
                                                     + times[f"{key}_{what}"])
                calls.append(lambda d=d, x=x: stage(d, x))
                keys.append(key)
                flop += f
        for key, ms in zip(keys, _pass_ms(calls)):
            times[f"{key}_pass_ms"] = ms
            times[f"wgrad_{model}_pass_ms"] = times.get(f"wgrad_{model}_pass_ms", 0.0) + ms
        del calls
        torch.cuda.empty_cache()
        for what in ("", "_cublas", "_cublas_sum"):
            times[f"wgrad_{model}{what}_tflops"] = (
                flop / times[f"wgrad_{model}{what}_ms"] / 1e9)


#: the float32 GEMM's main-path shapes, (rows M, width C) a part: serve
#: bucket 16 (16 windows x P=10 x flip x 27 frames x the part's joints; #1's
#: spatial and temporal blocks have the same rows) and the training step's
#: blocks (37 sequences x 27 frames x the joints; MixSTE: 4 x 243 frames x
#: 134 joints at model.cs 512)
GEMM_ROWS = {"serve16": ((16 * 10 * 2 * 27 * 24, 384), (16 * 10 * 2 * 27 * 68, 224),
                         (16 * 10 * 2 * 27 * 42, 256)),
             "h3wb": ((999 * 24, 384), (999 * 68, 224), (999 * 42, 256)),
             "mixste": ((4 * 243 * 134, 512),)}


def gemm_section(times, digests, dev):
    """The float32 wgmma GEMM alone (gemm_sm90.cuh's gemm_kernel, with the
    weight split and row statistics its wrappers launch) on seeded inputs at
    GEMM_ROWS: ``ops.gemm.fused_linear`` at serve bucket 16's four stages of
    each part (qkv with the LayerNorm, proj + residual, fc1 with the
    LayerNorm and GELU, fc2 + residual: the chain's products of #1, #3, #4),
    ``ops.block_train.fwd_linear`` at the training shapes' four forward
    products (#5: store, mask-scaled residual, the pair (u, gelu(u)),
    residual) and ``data_grad`` at their four data gradients (#6: fc2's
    with gelu'(u), fc1's, proj's, qkv's).  Each stage: device ms, TFLOP/s (2
    M N K, three TF32 products counted once), the bound (max of the FLOPs at
    165 TFLOP/s and the bytes at 3.35 TB/s: A, W, b, R and the outputs once)
    and cuBLAS's float32 ``F.linear`` (or ``a @ w``) at the same shape; the
    sums a group; a hash of each output (one seeded call)."""
    import hashlib
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.block_train import data_grad, fwd_linear
    from pafuse_tpu_torch.ops.gemm import fused_linear

    def row(key, fn, lib, M, N, K, extra_mn):
        """extra_mn: the M x N arrays besides Y (R, aux, Y2)"""
        out = fn()
        h = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            h.update(t.float().contiguous().cpu().numpy().tobytes())
        digests[key] = h.hexdigest()[:16]
        del out
        flop = 2 * M * N * K
        nbytes = 4 * (M * K + N * K + N + (1 + extra_mn) * M * N)
        ms, lib_ms = _cuda_ms(fn), _cuda_ms(lib)
        bound = max(flop / 165e12, nbytes / 3.35e12) * 1e3
        group = key.rsplit("_", 2)[0]
        for k, v in (("ms", ms), ("cublas_ms", lib_ms), ("bound_ms", bound),
                     ("flop", flop)):
            times[f"{key}_{k}"] = v
            times[f"{group}_{k}"] = times.get(f"{group}_{k}", 0.0) + v
        times[f"{key}_tflops"] = flop / ms / 1e9

    for model, rows in GEMM_ROWS.items():
        for i, (M, C) in enumerate(rows):
            part = ("body", "face", "hands")[i] if model != "mixste" else "block"
            gen = torch.Generator(device=dev).manual_seed(1100 + 10 * i + len(model))
            p = _block_params(C, 1200 + 10 * i + len(model), dev)
            a = {K: torch.randn(M, K, generator=gen, device=dev) for K in (C, 2 * C, 3 * C)}
            r = torch.randn(M, C, generator=gen, device=dev)
            if model == "serve16":
                for stage, w, b, ln, epi in (("qkv", p[2], p[3], p[0:2], "store"),
                                             ("proj", p[4], p[5], None, "residual"),
                                             ("fc1", p[8], p[9], p[6:8], "gelu"),
                                             ("fc2", p[10], p[11], None, "residual")):
                    N, K = w.shape
                    res = r if epi == "residual" else None
                    row(f"gemm_serve16_{part}_{stage}",
                        lambda: fused_linear(a[K], w, b, ln, epi, res),
                        lambda: F.linear(a[K], w, b), M, N, K, epi == "residual")
            else:
                mask = torch.tensor([0.0, 1 / 0.9, 1.0], device=dev)[
                    torch.arange(M // 27 if model == "h3wb" else M // 134, device=dev) % 3]
                L = 27 if model == "h3wb" else 134
                for stage, w, b, epi in (("qkv", p[2], p[3], "store"),
                                         ("proj", p[4], p[5], "residual"),
                                         ("fc1", p[8], p[9], "gelu"),
                                         ("fc2", p[10], p[11], "residual")):
                    N, K = w.shape
                    res = r if epi == "residual" else None
                    row(f"gemm_{model}fwd_{part}_{stage}",
                        lambda: fwd_linear(a[K], w, b, epi, res, mask, L),
                        lambda: F.linear(a[K], w, b), M, N, K,
                        {"store": 0, "residual": 1, "gelu": 1}[epi])
                u = torch.randn(M, 2 * C, generator=gen, device=dev)
                for stage, w, aux in (("fc2", p[10], u), ("fc1", p[8], None),
                                      ("proj", p[4], None), ("qkv", p[2], None)):
                    K, N = w.shape
                    row(f"gemm_{model}dgrad_{part}_{stage}",
                        lambda: data_grad(a[K], w, aux), lambda: a[K] @ w, M, N, K,
                        aux is not None)
                del u, mask
            del a, r
            torch.cuda.empty_cache()
    for key in [k for k in times if k.startswith("gemm_") and k.endswith("_flop")]:
        base = key[:-len("_flop")]
        flop = times.pop(key)
        if f"{base}_tflops" not in times:           # a group's sums
            times[f"{base}_tflops"] = flop / times[f"{base}_ms"] / 1e9
            times[f"{base}_cublas_tflops"] = flop / times[f"{base}_cublas_ms"] / 1e9


def _tracer():
    """This tree's chip_smoke.py as a module of its own name (a worker's
    ``import chip_smoke`` finds the tree under test's, whose groups name
    its kernels; the tracer is this tree's)."""
    import importlib.util
    mod = sys.modules.get("chip_ab_tracer")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "chip_ab_tracer", os.path.join(HERE, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_ab_tracer"] = mod
        spec.loader.exec_module(mod)
    return mod


def traced_groups(run):
    """``run()`` (a training step ending in its loss) once under
    torch.profiler, read by this tree's chip_smoke.traced (device kernels,
    copies and fills, not the GPU user annotations; each kind of the port's
    kernels against its libraries' counts, every launch call against the
    kernels): its device ms by the tree's chip_smoke.py kernel groups
    (TRAIN_GROUPS, then KERNEL_GROUPS), largest first, their sum as
    "device", the idle share of the run's host time, and beside them what
    the reading before this tracer added (the annotations' ms and the idle
    share with them counted).  A profile that dropped kernels is taken once
    more; if that one drops kernels too, only {"dropped": ...} is
    returned."""
    import chip_smoke
    tracer = _tracer()
    for _ in range(2):
        events, dropped, wall_ms, annotations = tracer.traced(run)
        if not dropped:
            break
    if dropped:
        return {"dropped": dropped}
    groups = {}
    for key, (ms, _) in events.items():
        g = chip_smoke.kernel_group(key, chip_smoke.TRAIN_GROUPS,
                                    "PyTorch (embedding, head, loss, AdamW)")
        groups[g] = groups.get(g, 0.0) + ms
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    groups["device"] = sum(groups.values())
    groups["idle_share"] = 1 - groups["device"] / wall_ms
    # the reading before the repair counted the annotations as device time
    groups["user_annotations"] = sum(ms for ms, _ in annotations.values())
    groups["idle_share_with_annotations"] = 1 - (
        groups["device"] + groups["user_annotations"]) / wall_ms
    return groups


def train_step_section(times, digests, dev, traced=False):
    """A float32 H3WB training step (depth 8, 37 sequences; host ms over
    STEPS steps after 2 warm ones, ending in the loss) and a hash of the
    losses and parameters; with ``traced``, one more step under
    torch.profiler, its device ms by the tree's chip_smoke.py kernel groups
    (TRAIN_GROUPS, then KERNEL_GROUPS) in times["traced_step_groups_ms"]."""
    import hashlib
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

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
        if len(batches) == 2 + STEPS + traced:
            break
    losses = [float(step(state, 6e-5, b2d, b3d)) for _, b3d, b2d in batches[:2]]
    t0 = time.time()
    for _, b3d, b2d in batches[2:2 + STEPS]:
        losses.append(float(step(state, 6e-5, b2d, b3d)))
    times["train_step_float32_ms"] = (time.time() - t0) * 1e3 / STEPS
    h = hashlib.sha256(torch.tensor(losses).numpy().tobytes())
    for q in model.parameters():
        h.update(q.detach().float().contiguous().cpu().numpy().tobytes())
    digests["train_window"] = h.hexdigest()[:16]
    if traced:
        _, b3d, b2d = batches[-1]
        times["traced_step_groups_ms"] = traced_groups(
            lambda: float(step(state, 6e-5, b2d, b3d)))
    del model, state, step, sampler, batches
    torch.cuda.empty_cache()


def kernels_worker(mode: str, only=None):
    """One tree's kernel A/B numbers (its package is first on sys.path);
    ``only="streamed"``: the streamed kernels and MixSTE's steps alone;
    ``only="serve"``: the bfloat16 request and evaluation alone;
    ``only="train"``: the float32 hashes of #1-#6 (no times), #6's weight-
    and bias-gradient stage alone (train_section), the H3WB float32 step
    with a profiled one, and MixSTE's steps."""
    import hashlib
    import numpy as np
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
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
    from pafuse_tpu_torch.skeleton import parts_table
    from pafuse_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    _build.build_all()
    if only == "stages":
        times, digests = {}, {}
        routes = resident_section(times, digests, dev)
        emit({"kernels_ab": mode, "times": times, "float32_digests": digests,
              "launches": routes})
        return
    if only == "streamed":
        times, digests = {}, {}
        streamed_section(times, digests, dev)
        mixste_block_section(times, dev)
        mixste_section(times, digests, dev)
        emit({"kernels_ab": mode, "times": times, "float32_digests": digests})
        return
    if only == "serve":
        times = {}
        serve_section(times, dev)
        emit({"kernels_ab": mode, "times": times, "float32_digests": {}})
        return
    heads, seqs, frames = 8, 16 * 10 * 2, 27
    parts = [(name, len(j), PART_CHANNELS[name])
             for name, j in parts_table(True).items()]
    times, digests = {}, {}
    timed = only not in ("train", "resident", "gemm", "fwd")

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
    for dtype in (torch.float32, torch.bfloat16) if timed else (torch.float32,):
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
                    if timed:
                        add(f"{k}_{name}_ms", _cuda_ms(fn))
                    if dtype == torch.float32:
                        digest(f"{k}_{part}_{j}", fn())
            for k in (("#1", "#2") if dtype == torch.float32 else ("#1",)) if timed else ():
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
                    y, saved = fwd()
                    if timed:
                        add("#5_float32_ms", _cuda_ms(lambda: fwd()[0]))
                        add("#6_float32_ms", _cuda_ms(lambda: block_train_bwd(saved, g)))
                        add("#5_attention_float32_ms", attention_ms(lambda: fwd()[0]))
                        add("#6_attention_float32_ms",
                            attention_ms(lambda: block_train_bwd(saved, g)))
                    dx, grads = block_train_bwd(saved, g)
                    digest(f"#5_{part}_{j}", y)
                    # #6's input gradient, its LayerNorm parameters'
                    # gradients and its weight and bias gradients apart
                    digest(f"#6dx_{part}_{j}", dx)
                    digest(f"#6ln_{part}_{j}", *[grads[k] for k in (0, 1, 6, 7, 12, 13)])
                    digest(f"#6_{part}_{j}", *[grads[k] for k in (2, 3, 4, 5, 8, 9, 10, 11)])
            torch.cuda.empty_cache()
    if timed:
        times["gemm_bfloat16_tflops"] = (times.pop("gemm_bfloat16_flop")
                                         / times["gemm_bfloat16_ms"] / 1e9)
    elif only == "gemm":
        gemm_section(times, digests, dev)
        times["serve_405_float32_ms"] = serve_405_ms(dev)
        train_step_section(times, digests, dev, traced=True)
        mixste_section(times, digests, dev, traced=True)
        emit({"kernels_ab": mode, "times": times, "float32_digests": digests,
              **{k: times.pop(k) for k in TRACED}})
        return
    elif only == "fwd":
        # the profiled step first: a process's later profiles drop kernels
        train_step_section(times, digests, dev, traced=True)
        routes = fwd_section(times, digests, dev)
        chain_section(times, dev)
        for n, ms in zip(SERVE_FRAMES, serve_405_ms(dev, frames=SERVE_FRAMES)):
            times[f"serve_{n}_float32_ms"] = ms
        # the 76-window action in float32 at use_pallas=auto (#1) and true
        # (#2), host s
        evaluate = _eval_action()
        for pallas in ("auto", "true"):
            model = D3DP(D3DPConfig(depth=8), device=dev,
                         generator=torch.Generator().manual_seed(0))
            for m in model.modules():
                if isinstance(m, MixSTE2):
                    m.set_use_pallas(pallas)
            evaluate(model)
            t0 = time.time()
            evaluate(model)
            times[f"eval_{pallas}_float32_s"] = time.time() - t0
            del model
        emit({"kernels_ab": mode, "times": times, "float32_digests": digests,
              **{k: times.pop(k) for k in TRACED if k in times},
              "launches": routes})
        return
    elif only == "resident":
        routes = resident_section(times, digests, dev)
        times["ordered_sums_bound_ms"] = ordered_sums_bound_ms()
        train_step_section(times, digests, dev, traced=True)
        mixste_section(times, digests, dev)
        emit({"kernels_ab": mode, "times": times, "float32_digests": digests,
              **{k: times.pop(k) for k in TRACED if k in times},
              "launches": routes})
        return
    else:
        train_section(times, dev)
        ln_section(times, dev)
        times["ordered_sums_bound_ms"] = ordered_sums_bound_ms()
        train_step_section(times, digests, dev, traced=True)
        mixste_section(times, digests, dev, traced=True)
        emit({"kernels_ab": mode, "times": times, "float32_digests": digests,
              **{k: times.pop(k) for k in TRACED}})
        return

    evaluate = serve_section(times, dev)
    # the same action in float32 at use_pallas=true (kernel #2, the CLI's
    # `true` evaluation; host s)
    model = D3DP(D3DPConfig(depth=8), device=dev,
                 generator=torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, MixSTE2):
            m.set_use_pallas("true")
    evaluate(model)
    t0 = time.time()
    evaluate(model)
    times["eval_true_float32_s"] = time.time() - t0
    del model
    train_step_section(times, digests, dev)
    streamed_section(times, digests, dev)
    mixste_block_section(times, dev)
    mixste_section(times, digests, dev)
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


#: the sources whose kernels --ptxas reports: the attention libraries, #6's
#: (block_train.cu: the LayerNorm kernels, the weight-gradient kernel and
#: the GEMM's instantiations it holds), the GEMM alone, #1's chain and #2's
#: (attention.cu: the GEMM with a bf16 output of a float32 A)
PTXAS_SOURCES = ("attention_core", "attention_core_bwd", "block_train", "gemm",
                 "block", "attention")


def _kernel_names(nvcc, mangled):
    """Readable names of the ``mangled`` kernel names, by cu++filt: the
    function with its template arguments, without the anonymous namespace,
    the return type and the parameters; a name cu++filt does not take stays
    as it is."""
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not mangled or not os.path.exists(filt):
        return {m: m for m in mangled}
    out = subprocess.run([filt], input="\n".join(mangled), capture_output=True,
                         text=True).stdout.splitlines()
    names = {}
    for m, d in zip(mangled, out):
        d = re.sub(r"^void ", "", re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", d))
        depth = 0
        for i, ch in enumerate(d):           # cut the parameter list
            depth += ch == "<"
            depth -= ch == ">"
            if ch == "(" and depth == 0:
                d = d[:i]
                break
        names[m] = d or m
    return names


def ptxas_report(sources=PTXAS_SOURCES, root=HERE):
    """Registers, spill bytes and the wgmma notes (C7517 injected waits,
    C7518 and C7520 serialisations) that ``nvcc -Xptxas -v`` gives for each
    kernel of ``sources`` of the tree at ``root`` (the build's flags,
    sm_90a), all compiled at once; keyed "<source>.cu: <kernel>"."""
    from pafuse_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    root = os.path.abspath(root)
    out = os.path.join(HERE, "build", "chip_ab_ptxas",
                       "change" if root == HERE else os.path.basename(root))
    os.makedirs(out, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {name: subprocess.Popen(
        [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o",
         os.path.join(out, f"{name}.cubin"),
         os.path.join(root, "pafuse_tpu_torch", "ops", "csrc", f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in sources}
    found = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed on {name}.cu:\n{log[-3000:]}")
        cur = None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) "
                          r"'?(_Z\w+)", line)
            if m:
                cur = found.setdefault((name, m.group(1)), {"notes": []})
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and cur is not None:
                cur["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
            m = re.search(r"\((C75(17|18|20))\).*function '(_Z\w+)'", line)
            if m:
                found.setdefault((name, m.group(3)), {"notes": []})["notes"].append(
                    m.group(1))
    names = _kernel_names(nvcc, sorted({k for _, k in found}))
    return {"phase": "ptxas", "tree": root,
            "kernels": {f"{src}.cu: {names[k]}": v for (src, k), v in sorted(found.items())}}


#: (B, L, C) of the backward's precision witness: the two 1000-token shapes
#: of tests/test_torch_cuda.py's ATTN_BWD_SHAPES, and MixSTE's temporal
#: block at 243 frames beside them
WITNESS_BWD = ((8, 1000, 512), (4, 1000, 1024), (64, 243, 512))


def witness():
    """Which of the attention backward's two float32 results drifts from
    the float64 one: at WITNESS_BWD, with the cuda suite's inputs (numpy
    seed B + L + C, unit-variance qkv and dO, 8 heads), max|a - b| /
    max|float64| for each of dq, dk and dv, for the kernel against the
    plain version in float32 (the suite's test), the kernel against the
    plain version in float64, and the float32 plain version against the
    float64 one."""
    import numpy as np
    import torch
    from pafuse_tpu_torch.ops.attention_core import (
        attention_core_bwd, attention_core_bwd_reference)

    rows = []
    for B, L, C in WITNESS_BWD:
        r = np.random.RandomState(B + L + C)
        qkv, do = (torch.tensor(r.randn(B, L, n), dtype=torch.float32,
                                device="cuda") for n in (3 * C, C))
        got = attention_core_bwd(qkv, do, 8)
        f32 = attention_core_bwd_reference(qkv, do, 8)
        f64 = attention_core_bwd_reference(qkv.double(), do.double(), 8)

        def errs(a, b):
            return [float((a[..., i * C:(i + 1) * C].double()
                           - b[..., i * C:(i + 1) * C].double()).abs().max()
                          / f64[..., i * C:(i + 1) * C].abs().max())
                    for i in range(3)]

        rows.append({"shape": [B, L, C], "kernel_vs_float32": errs(got, f32),
                     "kernel_vs_float64": errs(got, f64),
                     "float32_vs_float64": errs(f32, f64)})
        del qkv, do, got, f32, f64
        torch.cuda.empty_cache()
    return {"phase": "witness_bwd", "rows": rows}


#: the profiled steps' device ms by kernel group that a worker reports:
#: the H3WB step's and (``--only train``) MixSTE's
TRACED = ("traced_step_groups_ms", "traced_mixste_groups_ms")


def kernels_summary(results, changed=()):
    """Per metric: the parent's and the change's readings, each tree's
    spread, the change over the parent, and whether the change is faster
    (or, for the float32 rows, within 5%) beyond the spread; whether each
    float32 hash repeats within each tree, and agrees across the trees for
    every kernel not in ``changed``."""
    runs = {"parent": [], "change": []}
    for res in results:
        runs.setdefault(res["kernels_ab"], []).append(res)
    out = {}
    for key in runs["change"][0]["times"]:
        par = [r["times"][key] for r in runs["parent"] if key in r["times"]]
        chg = [r["times"][key] for r in runs["change"]]
        if not par:             # a call the other tree does not have
            out[key] = {"change": chg, "spread": max(chg) - min(chg)}
            continue
        higher_better = key.endswith("tflops")
        row = {"parent": par, "change": chg,
               "change_over_parent": (sum(chg) / len(chg)) / (sum(par) / len(par)),
               "spread": max(max(par) - min(par), max(chg) - min(chg))}
        if runs.get("alt"):
            alt = [r["times"][key] for r in runs["alt"]]
            row.update(alt=alt, alt_over_parent=(sum(alt) / len(alt))
                       / (sum(par) / len(par)))
        if higher_better:
            row["faster_beyond_spread"] = min(chg) > max(par)
        else:
            row["faster_beyond_spread"] = max(chg) < min(par)
        if "float32" in key:
            row["within_5_percent"] = max(chg) <= 1.05 * max(par)
        out[key] = row
    traced = {name: {mode: [r[name] for r in rs if name in r]
                     for mode, rs in runs.items()} for name in TRACED}
    # each group's median over a tree's profiles that dropped no kernel
    medians = {}
    for name, t in traced.items():
        for mode, profiles in t.items():
            whole = [g for g in profiles if "dropped" not in g]
            for group in {k for g in whole for k in g}:
                vals = sorted(g.get(group, 0.0) for g in whole)
                medians.setdefault(f"{name}_median", {}).setdefault(mode, {})[group] = (
                    vals[len(vals) // 2] if len(vals) % 2
                    else (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2)
    keys = runs["change"][0]["float32_digests"]
    same = {k: len({r["float32_digests"][k] for rs in runs.values()
                    for r in rs}) == 1 for k in keys}
    repeat = {k: all(len({r["float32_digests"][k] for r in rs}) == 1
                     for rs in runs.values()) for k in keys}
    kept = {k: v for k, v in same.items()
            if not set(digest_kernels(k)) & set(changed)}
    return {"phase": "kernels_ab", "metrics": out,
            **{name: {k: v for k, v in t.items() if v}
               for name, t in traced.items()},
            **medians,
            "float32_bit_identical": all(kept.values()),
            "float32_outputs_differing": sorted(k for k, v in same.items()
                                                if not v),
            "changed": sorted(changed),
            "float32_repeat_bit_identical": all(repeat.values()),
            "float32_not_repeating": sorted(k for k, v in repeat.items()
                                            if not v)}


def paired(other: str, flag: str, runs: int = 2, extra=(), alt=None):
    """Run ``flag``'s worker ``runs`` times on each tree, in turns (the
    other tree, this one, this one, the other, the other, ...; with a third
    tree ``alt``, each round starts one tree later: parent, change, alt,
    change, alt, parent, ...), each in its own process from its own root;
    returns their JSON lines."""
    trees = [("parent", os.path.abspath(other)), ("change", HERE)]
    if alt:
        trees.append(("alt", os.path.abspath(alt)))
    results = []
    order = []
    for i in range(runs):
        k = i % len(trees)
        order += trees[k:] + trees[:k]
    for mode, tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            flag, mode, *extra], cwd=tree, env=env,
                           capture_output=True, text=True, timeout=900)
        sys.stderr.write(r.stderr[-3000:])
        if r.returncode != 0:
            raise RuntimeError(f"{mode} worker failed: {r.stderr[-2000:]}")
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                results.append(json.loads(line))
                print(line, flush=True)
    return results


def route_tree(name: str, dst: str):
    """A copy of this tree at ``dst`` (but its build outputs, chiprun_out/
    and .git) with ROUTE_PATCHES[name] applied to the backward's route;
    raises where a patch's text is missing."""
    import shutil
    if os.path.exists(dst):
        shutil.rmtree(dst)
    top = {"build", "chiprun_out", ".git"}
    shutil.copytree(HERE, dst, ignore=lambda d, names: [
        n for n in names if n == "__pycache__"
        or (os.path.abspath(d) == HERE and n in top)])
    src = os.path.join(dst, "pafuse_tpu_torch/ops/csrc/attention_bwd_sm90.cuh")
    text = open(src).read()
    for old, new in ROUTE_PATCHES[name]:
        if old not in text:
            raise AssertionError(f"route {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    open(src, "w").write(text)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout of the port")
    ap.add_argument("--kernels", metavar="DIR",
                    help="the kernel A/B against another checkout of the port")
    ap.add_argument("--changed", default="",
                    help="kernels whose hashed outputs may differ, e.g. "
                         "'#1,#3,#4' ('bf16': the bfloat16 streamed forward; "
                         "'#6': #6's weight and bias gradients, '#6ln' its "
                         "LayerNorm parameters' gradients, '#6dx' its input "
                         "gradient)")
    ap.add_argument("--redesigned", default="",
                    help="names (or parts of names) of the kernels whose SASS "
                         "may differ, e.g. 'attention_stream_kernel'")
    ap.add_argument("--runs", type=int, default=3,
                    help="kernel A/B processes a tree")
    ap.add_argument("--only", choices=("streamed", "serve", "train", "resident",
                                       "stages", "gemm", "fwd"),
                    help="time the streamed attention kernels and MixSTE's "
                         "steps alone, the bfloat16 request and "
                         "evaluation alone, or #6's weight-gradient stage, "
                         "the H3WB step (and a profiled one) and MixSTE's "
                         "steps (with the float32 hashes of #1-#6), or the "
                         "resident float32 attention stages at their "
                         "main-path shapes (RESIDENT_BWD, RESIDENT_FWD) with "
                         "the float32 hashes of #1-#6, the H3WB step (and a "
                         "profiled one) and MixSTE's steps; 'stages': those "
                         "stages alone; 'gemm': the float32 GEMM alone at "
                         "GEMM_ROWS beside cuBLAS, with the float32 hashes of "
                         "#1-#6, the float32 405-frame serve request, the "
                         "H3WB step (and a profiled one) and MixSTE's steps "
                         "(and a profiled one); 'fwd': the float32 attention "
                         "forward alone at its main-path shapes (fwd_section) "
                         "and #1's stages at serve bucket 16 (chain_section) "
                         "with the float32 hashes of #1-#6, the float32 serve "
                         "requests at SERVE_FRAMES, the float32 auto and true "
                         "evaluation and the H3WB step (and a profiled one, "
                         "first)")
    ap.add_argument("--alt", metavar="DIR",
                    help="with --kernels, a third checkout timed in the same "
                         "turns (e.g. this tree with one part of the change "
                         "taken out); its SASS is not compared")
    ap.add_argument("--route-tree", nargs=2, metavar=("NAME", "DIR"),
                    help="write this tree with ROUTE_PATCHES[NAME] applied to "
                         "DIR first (e.g. for --alt DIR)")
    ap.add_argument("--ptxas", nargs="?", const=HERE, metavar="DIR",
                    help="registers, spills and wgmma notes of the kernels of "
                         "PTXAS_SOURCES from nvcc -Xptxas -v, on this tree "
                         "(or on the checkout DIR)")
    ap.add_argument("--witness", action="store_true",
                    help="the attention backward's float32 results against "
                         "float64 at WITNESS_BWD, on this tree")
    ap.add_argument("--worker", choices=("parent", "change"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--kernels-worker", choices=("parent", "change", "alt"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.route_tree:
        route_tree(*args.route_tree)
    if args.worker or args.kernels_worker:
        sys.path.insert(0, os.getcwd())     # the tree under test comes first
        if args.worker:
            worker(args.worker)
        else:
            kernels_worker(args.kernels_worker, args.only)
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
        redesigned = [k for k in args.redesigned.split(",") if k]
        sass["redesigned"] = [k for k in sass["differing"]
                              if any(r in k for r in redesigned)]
        emit(sass)
        unexpected = [k for k in sass["differing"]
                      if k not in sass["redesigned"]]
        if unexpected:
            raise AssertionError(f"kernels whose instructions differ from the "
                                 f"other tree's: {unexpected}")
        changed = tuple(k for k in args.changed.split(",") if k)
        extra = ("--only", args.only) if args.only else ()
        summary = kernels_summary(paired(args.kernels, "--kernels-worker",
                                         args.runs, extra, args.alt), changed)
        emit(summary)
        if not summary["float32_bit_identical"]:
            raise AssertionError(f"float32 outputs differ from the other "
                                 f"tree's: {summary['float32_outputs_differing']}")
        if not summary["float32_repeat_bit_identical"]:
            raise AssertionError(f"float32 outputs differ between two runs "
                                 f"of one tree: "
                                 f"{summary['float32_not_repeating']}")
    if args.witness:
        emit(witness())
    if args.ptxas:
        emit(ptxas_report(root=args.ptxas))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
