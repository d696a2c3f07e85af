#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pafuse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - nvcc builds every kernel from the repository's sources.
  3. kernel  - the fused block kernel against its plain PyTorch version on
               the same seeded inputs, at every part's spatial and temporal
               shape as the serving path gives it at bucket 16 (P=10, flip
               on), in float32 and bfloat16, with its time, the plain
               version's, one PyTorch library composition's (SDPA + cuBLAS,
               a yardstick only) and the card's lower bound.
  4. serve   - LiftingService at full width (the D3DPConfig defaults: part
               based, merged hands, 27 frames, 134 joints, depth 8) with
               seeded weights, P=10, T=5, buckets (1,2,4,8,16), float32:
               warm-up and three requests, with shape, finiteness,
               determinism and kernel-launch checks, and one request held
               against the same service with every block on the plain
               version.
Then the {"kernels": [...]} line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no result.  Without CUDA it exits non-zero at once.

Tolerances (max abs, elementwise):
  kernel float32   1e-4: same rounding points, only the order of f32 sums
                   differs (TF32 off on both sides);
  kernel bfloat16  max 2^-4 and mean 1e-3: both sides round the output and
                   five intermediates to bfloat16, so an order-of-summation
                   difference flips a bf16 ulp somewhere; a flip of the
                   residual stream x2 (|x2| up to ~8, ulp 2^-5) passes
                   through the outer LayerNorm into the output, and the
                   output's own rounding adds one ulp (2^-6 at |y| in
                   [2, 4)).  Such flips touch ~1% of elements, so the mean
                   stays near 1e-4, while a misplaced rounding point or a
                   wrong index moves most elements.  A flat 5e-3 max cannot
                   hold: one output ulp at |y| >= 2 is 0.0156;
  serve            1e-3 on poses (O(1) values): 16 blocks per part network,
                   5 DDIM steps feeding back, each block within ~1e-6.
"""

import argparse
import json
import subprocess
import sys
import time

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
KERNEL_TOL_F32 = 1e-4
KERNEL_TOL_BF16 = (2.0 ** -4, 1e-3)     # (max, mean)
SERVE_TOL = 1e-3
REPLACES = "pafuse_tpu/ops/attention.py:405"
SOURCE = "pafuse_tpu_torch/ops/csrc/block.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, reps: int = 5, warm: int = 2) -> float:
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


def library_block(x, bp, on, num_heads):
    """The same block as one composition of PyTorch library calls
    (layer_norm, cuBLAS linear, scaled_dot_product_attention, gelu): the
    yardstick ``library_ms``.  The port never calls it."""
    import torch.nn.functional as F
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2,
     bfc2) = bp
    B, L, C = x.shape
    d = C // num_heads
    h = F.layer_norm(x, (C,), n1s, n1b, 1e-6)
    q, k, v = F.linear(h, wqkv, bqkv).view(B, L, 3, num_heads, d).permute(
        2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, L, C)
    x = x + F.linear(a, wproj, bproj)
    x = x + F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), n2s, n2b, 1e-6),
                                      wfc1, bfc1)), wfc2, bfc2)
    return F.layer_norm(x, (C,), on[0], on[1], 1e-6)


def block_bound(B, L, C, dtype_name, param_bytes):
    """Least time for one block call: operations over the peak for the
    operand type, bytes (x read once, out written once, params) over HBM."""
    M = B * L
    flops = 16 * M * C * C + 4 * B * L * L * C
    itemsize = 4 if dtype_name == "float32" else 2
    nbytes = 2 * M * C * itemsize + param_bytes
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(seed: int, windows: int, P: int, frames: int):
    import torch
    from pafuse_tpu_torch.ops.block import block_reference, fused_block
    from pafuse_tpu_torch.skeleton import parts_table
    from pafuse_tpu_torch.models.parts import PART_CHANNELS
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    cases = []
    for part, joints in parts_table(True).items():
        C = PART_CHANNELS[part]
        seqs = windows * P * 2                      # windows x hypotheses x flip
        cases.append((part, "spatial", seqs * frames, len(joints), C))
        cases.append((part, "temporal", seqs * len(joints), frames, C))

    results = []
    for i, (part, kind, B, L, C) in enumerate(cases):
        g = torch.Generator().manual_seed(seed * 100 + i)

        def u(*shape, scale):
            return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev)

        hid = 2 * C
        bp = (1 + u(C, scale=0.1), u(C, scale=0.1),
              u(3 * C, C, scale=C ** -0.5), u(3 * C, scale=C ** -0.5),
              u(C, C, scale=C ** -0.5), u(C, scale=C ** -0.5),
              1 + u(C, scale=0.1), u(C, scale=0.1),
              u(hid, C, scale=C ** -0.5), u(hid, scale=C ** -0.5),
              u(C, hid, scale=hid ** -0.5), u(C, scale=hid ** -0.5))
        on = (1 + u(C, scale=0.1), u(C, scale=0.1))
        param_bytes = 4 * sum(t.numel() for t in bp + on)
        x32 = torch.randn(B, L, C, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            x = x32.to(dtype)
            got = fused_block(x, bp, on, heads)
            sync(dev)           # a fault inside the kernel surfaces here
            want = block_reference(x, bp, on, heads)
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool(diff.max() <= KERNEL_TOL_F32)
            else:
                max_tol, mean_tol = KERNEL_TOL_BF16
                ok = bool(diff.max() <= max_tol and diff.mean() <= mean_tol)
            lib_bp = tuple(t.to(dtype) for t in bp)
            lib_on = tuple(t.to(dtype) for t in on)
            ms = cuda_time_ms(lambda: fused_block(x, bp, on, heads))
            plain_ms = cuda_time_ms(lambda: block_reference(x, bp, on, heads))
            lib_ms = cuda_time_ms(
                lambda: library_block(x, lib_bp, lib_on, heads))
            bound_ms, bound_by = block_bound(B, L, C, name, param_bytes)
            r = {"phase": "kernel", "name": "fused_block", "part": part,
                 "kind": kind, "dtype": name, "B": B, "L": L, "C": C,
                 "max_abs_err": float(diff.max()),
                 "mean_abs_err": float(diff.mean()), "ok": ok, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
            emit(r)
            results.append(r)
            del got, want, diff
        del x32, x
        torch.cuda.empty_cache()
    return results


def serve_phase(seed: int):
    import numpy as np
    import torch
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models.mixste import MixSTE2
    from pafuse_tpu_torch.ops.block import block_reference, fused_block
    from pafuse_tpu_torch.serve import LiftingService, bucket_for

    cfg = D3DPConfig()              # flagship: depth 8, 27 frames, P=10, T=5
    model = D3DP(cfg, device="cuda",
                 generator=torch.Generator().manual_seed(seed))
    svc = LiftingService(model, buckets=(1, 2, 4, 8, 16), device="cuda")
    P, T = cfg.num_proposals, cfg.sampling_timesteps
    parts = len(model.pose_estimator.specs)
    per_chunk = parts * cfg.depth * 2 * T   # blocks per DDIM call x steps
    rng = np.random.RandomState(seed)

    def chunks(frames):
        w = max(1, -(-frames // cfg.frames))
        return -(-w // bucket_for(w, svc.buckets))

    main_path_launches = 0
    fused_block.launches = 0
    t0 = time.time()
    svc.warmup()
    warm_s = time.time() - t0
    expected = per_chunk * len(svc.buckets)
    if fused_block.launches != expected:
        raise AssertionError(f"warmup: {fused_block.launches} launches, "
                             f"expected {expected}")
    emit({"phase": "serve_warmup", "seconds": warm_s,
          "launches": fused_block.launches})
    main_path_launches += fused_block.launches

    requests = [
        ("27 frames", (27, 134, 2), {}),
        ("100 frames, pixels, world", (100, 134, 2),
         {"width": 1280, "height": 720, "world": True}),
        ("405 frames, all hypotheses", (405, 134, 2), {"all_hypotheses": True}),
        ("27 frames again", None, {}),
    ]
    outputs = {}
    first_kp = None
    for label, shape, kw in requests:
        if shape is None:
            kp = first_kp
        else:
            kp = rng.uniform(-1, 1, shape).astype(np.float32)
            if "width" in kw:
                kp = (kp + 1) * 0.5 * np.array([kw["width"], kw["height"]],
                                               np.float32)
        if first_kp is None:
            first_kp = kp
        fused_block.launches = 0
        res = svc.lift(kp, seed=seed, **kw)
        launches = fused_block.launches
        main_path_launches += launches
        poses = res["poses"]
        want_shape = ((P,) if kw.get("all_hypotheses") else ()) + (
            kp.shape[0], 134, 3)
        if poses.shape != want_shape:
            raise AssertionError(f"{label}: shape {poses.shape} != {want_shape}")
        if not np.all(np.isfinite(poses)):
            raise AssertionError(f"{label}: non-finite poses")
        if launches != per_chunk * chunks(kp.shape[0]):
            raise AssertionError(f"{label}: {launches} launches, expected "
                                 f"{per_chunk * chunks(kp.shape[0])}")
        if kw.get("world") and poses[..., 2].min() < 0.0:
            raise AssertionError(f"{label}: pose below the rebased floor")
        outputs[label] = poses
        emit({"phase": "serve", "request": label, "frames": kp.shape[0],
              "chunks": chunks(kp.shape[0]), "launches": launches,
              "latency_ms": res["latency_ms"],
              "frames_per_s": kp.shape[0] / (res["latency_ms"] / 1e3),
              "pose_abs_mean": float(np.abs(poses).mean())})
    if not np.array_equal(outputs["27 frames"], outputs["27 frames again"]):
        raise AssertionError("same (request, seed) gave different poses")

    # the same service with every block on the plain version, on the card
    nets = [m for m in model.modules() if isinstance(m, MixSTE2)]
    for m in nets:
        m.block_fn = block_reference
    try:
        ref = svc.lift(first_kp, seed=seed)["poses"]
    finally:
        for m in nets:
            m.block_fn = fused_block
    err = float(np.abs(ref - outputs["27 frames"]).max())
    emit({"phase": "serve_vs_plain", "max_abs_err": err, "tol": SERVE_TOL})
    if not err <= SERVE_TOL:
        raise AssertionError(f"kernel path vs plain path: {err} > {SERVE_TOL}")
    emit({"phase": "serve_health", **svc.health()})
    return main_path_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and requests")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.time()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": sorted(libs)})

    cases = kernel_phase(args.seed, windows=16, P=10, frames=27)
    launches = serve_phase(args.seed)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"fused_block disagrees with block_reference: {bad}")

    f32 = [c for c in cases if c["dtype"] == "float32"]
    bf16 = [c for c in cases if c["dtype"] == "bfloat16"]
    bound_by = max(("operations", "bytes"), key=lambda b: sum(
        c["bound_ms"] for c in f32 if c["bound_by"] == b))
    emit({"kernels": [{
        "name": "fused_block", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        # float32 (the served dtype): summed over the six main-path shapes
        # (one spatial + one temporal block of each part at bucket 16)
        "max_abs_err": max(c["max_abs_err"] for c in f32),
        "ms": sum(c["ms"] for c in f32),
        "plain_ms": sum(c["plain_ms"] for c in f32),
        "bound_ms": sum(c["bound_ms"] for c in f32),
        "bound_by": bound_by,
        "library_ms": sum(c["library_ms"] for c in f32),
        "max_abs_err_bf16": max(c["max_abs_err"] for c in bf16),
        "ms_bf16": sum(c["ms"] for c in bf16),
        "plain_ms_bf16": sum(c["plain_ms"] for c in bf16),
        "bound_ms_bf16": sum(c["bound_ms"] for c in bf16),
        "library_ms_bf16": sum(c["library_ms"] for c in bf16),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
