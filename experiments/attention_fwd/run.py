"""The float32 resident attention forward (attention_sm90.cuh, built into
attention_core.cu) of several trees side by side in one process on the card.

Each tree's ``csrc/attention_core.cu`` is built alone (the package's nvcc
flags, all trees at once; a tree that fails to build is reported and left
out) into ``build/experiments/attention_fwd/<name>/`` with ptxas's report of
every float32 ``attention_tc_kernel`` instantiation (registers, spill
bytes).  Then each tree's ``pafuse_attention_core`` (what
``ops.attention_core.attention_core`` calls) runs on the same seeded float32
qkv at the main path's shapes (SHAPES, 8 heads, contiguous sequences; the
``framesfirst`` group reads #3's and #4's (B, F, N, 3C) layout in place):
device ms (CUDA events, 2 warm and 10 timed calls a turn, the trees in turns
A B C C B A, the median of the turns), the stage's bound
(``attention_bound_ms``), SDPA's ms on the same inputs, max|out - plain| on
the first 64 sequences against ``attention_core_reference``, and whether
every tree's output equals the first tree's bit for bit; the sums a group,
and for each tree ``BASE+PATCH`` whose ``BASE`` is also a tree, the share of
BASE's time the patch takes away.

A tree is ``NAME=DIR`` or ``NAME=DIR+PATCH[+PATCH...]``: DIR's sources with
PATCHES[PATCH] applied in turn (the comment above each says what it does).
The first six take one cost out of the resident float32 kernel of the
design before this one (``tile_f32`` re-splitting K and V in every warp,
the output through the q tiles and a second CTA barrier): their results
are wrong and their times say what the cost was.  The rest keep the bits:
``nodead``, ``lb1`` and ``chunkw4`` change one choice of this design,
``stream`` sends float32 past 144 keys at d <= 48 to the streamed kernel
(a tree of the design before this one).

    python3 experiments/attention_fwd/run.py parent=build/parent \\
        parent_nokv=build/parent+nokvsplit change=. [--groups=serve16,long] \\
        [--out=chiprun_out/attention_fwd.jsonl]

Every line is also appended to the ``--out`` file where one is named.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pafuse_tpu_torch.ops import _build  # noqa: E402
from pafuse_tpu_torch.ops.attention_core import attention_core_reference  # noqa: E402

CUH, CU = "attention_sm90.cuh", "attention_core.cu"
HEADS = 8
_NOSPLIT = """__device__ __forceinline__ void nosplit(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v);
  lo = hi ^ 0x1000u;
}

__device__ __forceinline__ uint32_t pack_bf16("""
#: (file, old, new, count) edits a tree may name after "+": old must occur
#: count times (0: at least once), every occurrence is replaced
PATCHES = {
    #: K and V reach the products unsplit (their bits as hi, hi ^ 1 << 12 as lo)
    "nokvsplit": [(CUH, "__device__ __forceinline__ uint32_t pack_bf16(", _NOSPLIT, 1),
                  (CUH, "split(kr[0], bh0, bl0);", "nosplit(kr[0], bh0, bl0);", 1),
                  (CUH, "split(kr[4], bh1, bl1);", "nosplit(kr[4], bh1, bl1);", 1),
                  (CUH, "split(vr[8 * nd], bh0, bl0);", "nosplit(vr[8 * nd], bh0, bl0);", 1),
                  (CUH, "split(vr[8 * nd + STRIDE], bh1, bl1);",
                   "nosplit(vr[8 * nd + STRIDE], bh1, bl1);", 1)],
    #: Q reaches the products unsplit
    "noqsplit": [(CUH, "__device__ __forceinline__ uint32_t pack_bf16(", _NOSPLIT, 1),
                 (CUH, "split(q[(g + 8 * (i & 1)) * STRIDE + 8 * kk + t + 4 * (i >> 1)], "
                       "qh[kk][i], ql[kk][i]);",
                  "nosplit(q[(g + 8 * (i & 1)) * STRIDE + 8 * kk + t + 4 * (i >> 1)], "
                  "qh[kk][i], ql[kk][i]);", 1)],
    #: nothing copied in (the tiles hold what shared memory held)
    "nocopyin": [(CUH, "  move_rows<true>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);",
                  "  if (scale == 1234.5f) move_rows<true>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);",
                  1)],
    #: no output pass (O stays in the q tiles)
    "nooutpass": [(CUH, "  move_rows<false>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);",
                   "  if (scale == 1234.5f) move_rows<false>(vb, u, qkv, out, sm, C, d, lpa, "
                   "STRIDE);", 1)],
    #: no exponential (e = s - max)
    "noexp": [(CUH, "expf(s[j][n][e] - mx[e >> 1])", "(s[j][n][e] - mx[e >> 1])", 0)],
    #: no tensor-core product (the operands stay live, the accumulators 0)
    "nomma": [(CUH, """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
               """  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "r"(b0), "r"(b1));""", 1)],
    # -- the persistent design (this tree's tile_f32, attention_tc_kernel's
    # float32 overload) --
    #: the dead n8 key tile computed and masked (the same bits)
    "nodead": [(CUH, "  if (NKT != CHUNK_TILES && (L + 7) / 8 < 2 * NKT)\n",
                "  if (false)\n", 1)],
    #: launch bounds with at least one CTA an SM (ptxas free to use 255 registers)
    "lb1": [(CUH, "__global__ void __launch_bounds__(32 * f32_warps(NKT))\n",
             "__global__ void __launch_bounds__(32 * f32_warps(NKT), 1)\n", 1)],
    #: 4 warps a CTA on the chunked path too
    "chunkw4": [(CUH, "return nkt == CHUNK_TILES ? 8 : 4;", "return 4;", 1)],
    #: float32 past 144 keys at d <= 48 streamed (the same bits)
    "stream": [(CUH, "if (key_tiles(L) == CHUNK_TILES && (size == 2 || d > 48)) return 2;",
                "if (key_tiles(L) == CHUNK_TILES) return 2;", 1)],
}


def block_cases(windows, P=10, frames=27):
    """(B, L, C) of each H3WB part's spatial and temporal block (chip_smoke's
    block_cases): body 24 joints at C = 384, face 68 at 224, hands 42 at 256."""
    seqs = windows * P * 2
    return tuple(c for N, C in ((24, 384), (68, 224), (42, 256))
                 for c in ((seqs * frames, N, C), (seqs * N, frames, C)))


#: group -> (B, L, C) shapes (framesfirst: (B, F, N, C), read in place)
SHAPES = {
    "serve16": block_cases(16),                # #1 at serve bucket 16
    "eval64": block_cases(64),                 # #2 at window batch 64
    "h3wb": ((999, 24, 384), (888, 27, 384), (999, 68, 224),
             (2516, 27, 224), (999, 42, 256), (1554, 27, 256)),   # #5's step
    "dhp3": ((999, 17, 288), (629, 27, 288)),  # 3DHP's step
    "long": ((64, 243, 384), (64, 243, 224), (64, 243, 256), (64, 243, 288)),
    "framesfirst": ((320, 27, 24, 384), (320, 27, 68, 224), (320, 27, 42, 256)),
    # head rows not a multiple of 16 bytes (4-byte copies), both layouts,
    # and a few units
    "odd": ((5, 27, 136), (3, 27, 4, 136), (7, 68, 120), (2, 9, 24), (3, 200, 120)),
}
TURNS = 3


def tree_source(name, spec):
    """DIR's csrc with the spec's patches, in the tree's build dir."""
    root, *patches = spec.split("+")
    dst = os.path.join(os.getcwd(), "build", "experiments", "attention_fwd", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "pafuse_tpu_torch", "ops", "csrc"), dst)
    for patch in patches:
        for fname, old, new, count in PATCHES[patch]:
            p = os.path.join(dst, fname)
            text = open(p).read()
            if old in new and new in text:        # inserted by an earlier patch
                continue
            n = text.count(old)
            assert n == count or (count == 0 and n > 0), f"{patch}: {old!r} found {n} times"
            open(p, "w").write(text.replace(old, new))
    return dst


def build(trees):
    """{name: (library, ptxas rows)} of each tree's attention_core.cu."""
    procs = {}
    for name, spec in trees.items():
        dst = tree_source(name, spec)
        so = os.path.join(dst, "libattention_core.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
             os.path.join(dst, CU)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:        # reported, and the other trees run
            emit({"tree": name, "nvcc_failed": log[-6000:]})
            continue
        rows, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
            if m:
                cur = m.group(1) if re.search(r"attention_tc_kernelIf", m.group(1)) else None
                if cur:
                    rows.setdefault(cur, {})
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rows[cur]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[cur]["registers"] = int(m.group(1))
        lib = ctypes.CDLL(so)
        P, I, LL, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.pafuse_attention_core.argtypes = [I, P, P, LL, I, I, I, I, F32, P]
        lib.pafuse_attention_core.restype = I
        libs[name] = (lib, rows)
    return libs


OUT = []
PROGRESS = [0.0]            # when the last line was emitted


def emit(obj):
    import time
    PROGRESS[0] = time.time()
    line = json.dumps(obj)
    print(line, flush=True)
    for path in OUT:
        with open(path, "a") as f:
            f.write(line + "\n")


def watchdog(limit_s=90.0):
    """Ends the process (exit code 3) once no line has been emitted for
    limit_s seconds: a kernel that never ends is reported, not waited out."""
    import threading
    import time
    PROGRESS[0] = time.time()

    def watch():
        while True:
            time.sleep(1.0)
            if time.time() - PROGRESS[0] > limit_s:
                emit({"watchdog": f"no progress for {limit_s} s"})
                os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def smoke(lib, name, dev, stream, wait_s=20.0):
    """One call of the tree's kernel at a few shapes, given wait_s seconds
    to finish (polled, so a kernel that never ends is reported instead of
    holding the process): None, after reporting, if one did not, False if
    one failed to launch."""
    import time
    for B, L, C in ((64, 27, 256), (3, 68, 224), (5, 24, 384)):
        x = torch.randn(B, L, 3 * C, device=dev)
        y = torch.empty(B, L, C, device=dev)
        err = lib.pafuse_attention_core(0, x.data_ptr(), y.data_ptr(), B, L, 1, C, HEADS,
                                        (C // HEADS) ** -0.5, stream)
        done = torch.cuda.Event()
        done.record()
        t0 = time.time()
        while not done.query():
            if time.time() - t0 > wait_s:
                emit({"tree": name, "hung_at": [B, L, C]})
                return None
            time.sleep(0.01)
        if err:
            emit({"tree": name, "launch_error": err, "shape": [B, L, C]})
            return False
    return True


def attention_bound_ms(B, L, C):
    """chip_ab.py's bound of one float32 forward stage: 4 B L^2 C operations
    at 165 TFLOP/s or 16 B L C bytes at 3.35 TB/s, the larger (H100 SXM,
    700 W data-sheet peaks)."""
    return max(4 * B * L * L * C / 165e12, 16 * B * L * C / 3.35e12) * 1e3


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    groups = list(SHAPES)
    for a in sys.argv[1:]:
        if a.startswith("--groups="):
            groups = a.split("=", 1)[1].split(",")
        if a.startswith("--out="):
            OUT.append(a.split("=", 1)[1])
            os.makedirs(os.path.dirname(OUT[-1]) or ".", exist_ok=True)
    trees = dict(a.split("=", 1) for a in args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"nvidia_smi": smi, "torch": torch.__version__})
    libs = build(trees)
    trees = {name: spec for name, spec in trees.items() if name in libs}
    for name, (_, rows) in libs.items():
        emit({"tree": name, "ptxas": rows})
    if not trees:
        return
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    watchdog()
    for name in list(trees):
        ok = smoke(libs[name][0], name, dev, stream)
        if ok is None:                  # a kernel still running: nothing else can
            os._exit(3)
        if not ok:
            del trees[name]
    first = next(iter(trees))
    totals = {g: {name: 0.0 for name in trees} for g in groups}
    bounds = dict.fromkeys(groups, 0.0)
    for group in groups:
        for i, shape in enumerate(SHAPES[group]):
            if len(shape) == 4:
                B, L, N, C = shape
                x = torch.randn(B, L, N, 3 * C, generator=torch.Generator(device=dev)
                                .manual_seed(1000 + i), device=dev)
                seqs, S = B * N, N
            else:
                B, L, C = shape
                x = torch.randn(B, L, 3 * C, generator=torch.Generator(device=dev)
                                .manual_seed(1000 + i), device=dev)
                seqs, S = B, 1
            d = C // HEADS
            outs = {name: torch.full(x.shape[:-1] + (C,), float("nan"), device=dev)
                    for name in trees}

            def call(name):
                err = libs[name][0].pafuse_attention_core(
                    0, x.data_ptr(), outs[name].data_ptr(), seqs, L, S, C, HEADS,
                    d ** -0.5, stream)
                assert err == 0, (name, shape, err)

            for name in trees:
                call(name)
            torch.cuda.synchronize()
            row = {"group": group, "shape": list(shape)}
            sub = x[:64] if S == 1 else x[:1]
            want = attention_core_reference(sub, HEADS)
            for name in trees:
                got = outs[name][:64] if S == 1 else outs[name][:1]
                row[f"{name}_max_abs_err"] = float((got - want).abs().max())
                row[f"{name}_same_bits_as_{first}"] = bool(torch.equal(outs[name], outs[first]))
            ms = {name: [] for name in trees}
            order = list(trees) + list(trees)[::-1]
            for _ in range(TURNS):
                for name in order:
                    for _ in range(2):
                        call(name)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(10):
                        call(name)
                    e1.record()
                    torch.cuda.synchronize()
                    ms[name].append(e0.elapsed_time(e1) / 10)
            bound = attention_bound_ms(seqs, L, C)
            row["bound_ms"] = bound
            bounds[group] += bound
            for name in trees:
                t = sorted(ms[name])[len(ms[name]) // 2]
                row[f"{name}_ms"] = t
                row[f"{name}_share_of_bound"] = bound / t
                totals[group][name] += t
            if S == 1:
                q, k, v = x.view(B, L, 3, HEADS, d).permute(2, 0, 3, 1, 4)
                F.scaled_dot_product_attention(q, k, v)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(10):
                    F.scaled_dot_product_attention(q, k, v)
                e1.record()
                torch.cuda.synchronize()
                row["sdpa_ms"] = e0.elapsed_time(e1) / 10
                del q, k, v
            emit(row)
            del x, outs
            torch.cuda.empty_cache()
    shares = {}
    for name, spec in trees.items():
        base_spec = spec.rsplit("+", 1)[0]
        base = next((b for b, s in trees.items() if s == base_spec and "+" in spec), None)
        if base:
            shares[name] = {g: 1 - totals[g][name] / totals[g][base] for g in groups}
    emit({"sum_ms": totals, "bound_ms": bounds, "share_taken_away": shares})


if __name__ == "__main__":
    main()
