"""Time the LayerNorm-backward designs of variants.cu side by side on the
card (float32), at H3WB's and MixSTE's shapes in the three forms, each
design's outputs against ops.block_train.ln_backward_reference (1e-5 x
max|plain|), in turns (each design, then in reverse), 3 warm and 20 timed
launches a turn through ctypes (device-bound: no wrapper), and the sums a
step launches (16 blocks a part).  Run from the repo root on the card:

    python3 experiments/ln_backward/run.py

It builds variants.cu into build/ln_backward_variants/ (gitignored)."""
import ctypes, json, os, subprocess, sys, time
sys.path.insert(0, os.getcwd())
import torch
from pafuse_tpu_torch.ops import _build
from pafuse_tpu_torch.ops.block_train import ln_backward_reference
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
here = os.path.dirname(os.path.abspath(__file__))
out_dir = os.path.join(os.getcwd(), "build", "ln_backward_variants")
os.makedirs(out_dir, exist_ok=True)
so = os.path.join(out_dir, "libvariants.so")
flags = _build.NVCC_FLAGS
r = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-o", so, os.path.join(here, "variants.cu")],
                   capture_output=True, text=True)
print("\n".join(l for l in r.stdout.splitlines() + r.stderr.splitlines()
                if "registers" in l or "spill" in l or "error" in l.lower() or "Compiling entry" in l)[-6000:], flush=True)
assert r.returncode == 0, r.stderr[-3000:]
lib = ctypes.CDLL(so)
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
lib.ln_variant.argtypes = [I] + [P] * 7 + [I] + [P] * 4 + [LL, I, P]
lib.ln_variant.restype = I
dev = torch.device("cuda")
VARIANTS = {0: "reg1", 1: "reg2rows", 3: "reg1_2ctas", 2: "ring", 4: "copy_rows", 5: "copy_flat"}
SHAPES = [(999 * 24, 384, 27), (999 * 68, 224, 27), (999 * 42, 256, 27), (4 * 243 * 134, 512, 243)]
out = {}
for M, C, L in SHAPES:
    g0 = torch.Generator(device=dev).manual_seed(M)
    x, g, res = (torch.randn(M, C, generator=g0, device=dev) for _ in range(3))
    mean, rstd = x.mean(1), torch.rsqrt(x.var(1, unbiased=False) + 1e-6)
    sc = 1 + 0.1 * torch.randn(C, generator=g0, device=dev)
    mask = (torch.rand(M // L, generator=g0, device=dev) < 0.9).float() / 0.9
    dx = torch.empty_like(x); dxm = torch.empty_like(x)
    part = torch.empty(132 * 3 * 2 * C, device=dev); dsdb = torch.empty(2 * C, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    for form, (R, m, D) in {"outer": (None, mask, dxm), "ln2": (res, mask, dxm), "ln1": (res, None, None)}.items():
        want = ln_backward_reference(g, x, mean, rstd, sc, R, m, L)
        def call(v):
            e = lib.ln_variant(v, g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), sc.data_ptr(),
                               None if R is None else R.data_ptr(), None if m is None else m.data_ptr(), L,
                               dx.data_ptr(), None if D is None else D.data_ptr(), part.data_ptr(), dsdb.data_ptr(), M, C, st)
            assert e == 0, e
        for v in VARIANTS:
            call(v); torch.cuda.synchronize()
            if v >= 4:
                continue
            got = [dx, D, dsdb[:C], dsdb[C:]]
            err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want) if b is not None)
            assert err < 1e-5, (VARIANTS[v], form, C, err)
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        ms = {v: [] for v in VARIANTS}
        for v in order:
            for _ in range(3): call(v)
            a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20): call(v)
            b.record(); torch.cuda.synchronize()
            ms[v].append(a.elapsed_time(b) / 20)
        out[f"{form}_{C}"] = {VARIANTS[v]: sum(t) / len(t) for v, t in ms.items()}
        print(f"{form}_{C}", json.dumps(out[f"{form}_{C}"]), flush=True)
tot = {VARIANTS[v]: sum(r[VARIANTS[v]] for k, r in out.items() if not k.endswith("512")) * 16 for v in VARIANTS}
print("h3wb_step_ms", json.dumps(tot), flush=True)
print("mixste_step_ms", json.dumps({VARIANTS[v]: sum(r[VARIANTS[v]] for k, r in out.items() if k.endswith("512")) * 16 for v in VARIANTS}), flush=True)
