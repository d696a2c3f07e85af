"""#6's weight- and bias-gradient stage (wgrad_sm90.cuh's wgrad_wgmma_kernel
and block_train.cu's ordered pass) of several trees side by side in one
process on the card.

Each tree's ``csrc/block_train.cu`` is built alone (the package's nvcc
flags, all trees at once; a tree that fails to build is reported and left
out) into ``build/experiments/wgrad/<name>/`` with
ptxas's report of every ``wgrad_wgmma_kernel`` instantiation and of
``reduce_partials_kernel`` (registers, spill bytes, C7517/C7518/C7520
notes).  Then each tree's ``pafuse_weight_grads`` (what
``ops.block_train.weight_grads`` calls: the partials and their ordered
pass) runs on the same seeded float32 d and x at the twelve products of
the H3WB step (37 sequences x 27 frames x the part's joints; fc2, fc1, proj,
qkv of each part) and the eight of MixSTE's (4 x 243 frames x 134 joints,
model.cs 512, two blocks): device ms (CUDA events, 2 warm and 10 timed calls
a turn, the trees in turns A B C C B A, the median of the turns), TFLOP/s
(2 M N K), max|dW - d^T x| / max|d^T x| and the same for db against float64,
and whether every tree's dW and db equal the first tree's bit for bit; the
sums a model, and for each tree ``BASE+PATCH`` whose ``BASE`` is also a
tree, the share of BASE's time the patch takes away.

A tree is ``NAME=DIR`` or ``NAME=DIR+PATCH[+PATCH...]``: DIR's sources with
PATCHES[PATCH] applied in turn (the comment above each says what it does).
Some take one cost out while keeping the wgmmas (``nosplitstore``,
``nodfrag``, ``nostore``, ``nopass``, ``nosplit``, ``nocvt``, ``twoprod``,
...): their results are wrong and their times say what the cost is.
Others swap in a variant of the kernel, ``experiments/wgrad/<name>.cuh``
(``step1``, ``step12``, ``dbuf``, ``wait3``, ``splitcopy``, ``copywg``,
``timers``, ...), or change one of its settings; these keep the bits.
``timers`` (the parent's design with clock64 timers) adds to each row
where the product and splitting warps spend their cycles.

    python3 experiments/wgrad/run.py parent=build/parent parent_nosplit=build/parent+nosplit \\
        change=.
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

from pafuse_tpu_torch.ops import _build  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CUH, CU = "wgrad_sm90.cuh", "block_train.cu"
SPLIT_STORES = (
    "          *reinterpret_cast<float4*>(hi + off) = *reinterpret_cast<const float4*>(h);\n"
    "          *reinterpret_cast<float4*>(hi + B_TILE + off) = "
    "*reinterpret_cast<const float4*>(l);\n")
SPLIT_STS = "          sts128(hi + off, h);\n          sts128(hi + B_TILE + off, l);\n"
#: (file, old, new) edits a tree may name after "+" (old and new may be
#: tuples of alternatives, for designs that word a line apart); new None
#: with old a file name under experiments/wgrad/: that file replaces the
#: source
PATCHES = {
    #: the splitting warpgroup writes no hi and lo tiles
    "nosplitstore": [(CUH, (SPLIT_STORES, SPLIT_STS),
                      ("          if (h[0] == 1.2345e38f && l[3] == -1.2345e38f) {\n"
                       + SPLIT_STORES + "          }\n",
                       "          if (h[0] == 1.2345e38f && l[3] == -1.2345e38f) {\n"
                       + SPLIT_STS + "          }\n"))],
    #: the product threads read no A fragments from the raw slice
    "nodfrag": [(CUH, ("pv[e] = *reinterpret_cast<const float*>(ds + (n >> 5) * BOX + swz(m, n & 31));",
                       "pv[e] = sm90::lds_f32(ds + frag[e] + 1024 * kk);"),
                 ("pv[e] = __int_as_float(n + 64 * m + 1);",
                  "pv[e] = __int_as_float(frag[e] + kk + 1);"))],
    #: step12: the product threads load no D from global memory
    "nodload": [(CUH, "      dv[4 * kk + e] = load_if(p + (e >> 1) * (long long)N + 8 * (e & 1),\n"
                      "                               live && m + (e >> 1) < M && n + 8 * (e & 1)"
                      " < N);",
                 "      dv[4 * kk + e] = __int_as_float(n + 8 * e + (int)m + live);")],
    #: no partial stored
    "nostore": [(CUH, "                  n < N && k < K);",
                 "                  n < N && k < K && acc[4 * j + 2 * h] == 1.2345e38f);")],
    #: no ordered pass
    "nopass": [(CU, "  return reduce_partials(part, wgrad::chunks(M, N, K), (long long)N * K + N, "
                    "dwdb, stream);", "  return cudaSuccess;")],
    #: the parent's per-slice barrier replaced by per-warpgroup refills (each
    #: product warpgroup copies its half of D, the first also X; the stage's
    #: barrier takes both arrivals): a correct design
    "nobar": [
        (CUH, "for (int s = 0; s < RAW_STAGES; ++s) sm90::mbar_init(&full[s], 1);",
         "for (int s = 0; s < RAW_STAGES; ++s) sm90::mbar_init(&full[s], 2);"),
        (CUH, '"r"(RAW_STAGE), "r"(p)', '"r"(p == 1 ? 6 * BOX : 2 * BOX), "r"(p)'),
        (CUH, '"l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), '
              '"r"(m), "r"(p)',
         '"l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), '
         '"r"(m), "r"((int)(p == 1 ? (b < 2 || b >= 4) : p == 2 && (b == 2 || b == 3)))'),
        (CUH, "(int)(lw.r0 + (long long)ROWS * lp_s), threadIdx.x == 0);",
         "(int)(lw.r0 + (long long)ROWS * lp_s),\n"
         "                 (threadIdx.x & 127) == 0 ? 1 + (threadIdx.x >> 7) : 0);"),
        (CUH, 'asm volatile("bar.sync 1, 256;" ::: "memory");', "")],
    #: no FADDs of a pair and no wait for it (ptxas then drops the dead
    #: wgmmas: a time that is no measurement)
    "nodrain": [(CUH, """        if (half) {
          sm90::wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < BN / 2; ++q) acc[q] += part[q];
        }
""", "")],
    #: the splitting warpgroup only waits and arrives
    "nosplit": [(CUH, """        for (int c = 0; c < 8; ++c) {
          float h[4], l[4];
""", """        for (int c = 0; c < 8; ++c) {
          if (c >= 0) continue;
          float h[4], l[4];
""")],
    #: no lo*hi product
    "twoprod": [(CUH, "          sm90::WgmmaRs<BN>::tf32(part, al[kk & 1], bh + 2 * kk, half || kk);"
                      "   // lo * hi\n", "")],
    #: no product at all
    "nowgmma": [(CUH, "          sm90::WgmmaRs<BN>::tf32(part, al[kk & 1], bh + 2 * kk, half || kk);"
                      "   // lo * hi\n", ""),
                (CUH, "          sm90::WgmmaRs<BN>::tf32(part, ah[kk & 1], bl + 2 * kk, 1);"
                      "           // hi * lo\n", ""),
                (CUH, "          sm90::WgmmaRs<BN>::tf32(part, ah[kk & 1], bh + 2 * kk, 1);"
                      "           // hi * hi\n", "")],
    #: three raw stages and four split slices
    "r3c4": [(CUH, "constexpr int RAW_STAGES = 4;", "constexpr int RAW_STAGES = 3;"),
             (CUH, "constexpr int CONV_BUFS = 3;", "constexpr int CONV_BUFS = 4;")],
    #: no FADDs of a pair (the wait stays; ptxas drops the dead wgmmas)
    "nofadd": [(CUH, "          for (int q = 0; q < BN / 2; ++q) acc[q] += part[q];\n", "")],
    #: the parent's design with clock64 timers, read by pafuse_wgrad_timers
    "timers": [(CUH, "timers.cuh", None),
               (CU, 'extern "C" long long pafuse_weight_grads_part_floats(',
                '// wgrad::timers (timers.cuh) into out (16 values), then zeroed when reset\n'
                'extern "C" int pafuse_wgrad_timers(unsigned long long* out, int reset) {\n'
                '  cudaError_t e = cudaMemcpyFromSymbol(out, wgrad::timers, 16 * sizeof(*out));\n'
                '  if (e == cudaSuccess && reset) {\n'
                '    const unsigned long long z[16] = {};\n'
                '    e = cudaMemcpyToSymbol(wgrad::timers, z, sizeof z);\n'
                '  }\n'
                '  return (int)e;\n'
                '}\n\n'
                'extern "C" long long pafuse_weight_grads_part_floats(')],
    #: three k-step groups in flight (four A fragment sets)
    "wait3": [(CUH, "wait3.cuh", None)],
    #: five raw stages and two split slices
    "r5c2": [(CUH, "constexpr int RAW_STAGES = 4;", "constexpr int RAW_STAGES = 5;"),
             (CUH, "constexpr int CONV_BUFS = 3;", "constexpr int CONV_BUFS = 2;")],
    #: thread 0 alone copies a pair's two slices after the pair's drain
    "pairload": [
        (CUH, "(int)(lw.r0 + (long long)ROWS * lp_s), threadIdx.x == 0);",
         "(int)(lw.r0 + (long long)ROWS * lp_s), 1);"),
        (CUH, "  for (int i = 0; i < RAW_STAGES; ++i) load_next();",
         "  if (threadIdx.x == 0)\n    for (int i = 0; i < RAW_STAGES; ++i) load_next();"),
        (CUH, '        asm volatile("bar.sync 1, 256;" ::: "memory");\n        load_next();\n',
         '        if (half) {\n          asm volatile("bar.sync 1, 256;" ::: "memory");\n'
         "          if (threadIdx.x == 0) {\n            load_next();\n            load_next();\n"
         "          }\n        }\n")],
    #: the copies issued by the splitting warpgroup
    "splitcopy": [(CUH, "splitcopy.cuh", None)],
    #: the product threads take D's bits as the TF32 halves, unsplit
    "nocvt": [(CUH, """            ah[kk & 1][e] = sm90::tf32_bits(v);
            al[kk & 1][e] = sm90::tf32_bits(v - __uint_as_float(ah[kk & 1][e]));""",
               """            ah[kk & 1][e] = __float_as_uint(v);
            al[kk & 1][e] = __float_as_uint(v) >> 13;""")],
    #: the second product warpgroup a slice behind the first, so the two
    #: drains of a pair do not meet
    "skew": [
        (CUH, "  float acc[BN / 2], part[BN / 2];\n  int it = 0;\n",
         "  float acc[BN / 2], part[BN / 2];\n  int it = 0;\n"
         '  if (wg) asm volatile("bar.sync 1, 256;" ::: "memory");\n'),
        (CUH, '        asm volatile("bar.sync 1, 256;" ::: "memory");\n        load_next();\n',
         '        asm volatile("bar.sync 1, 256;" ::: "memory");\n        if (it > 0) load_next();\n'),
        (CUH, """        store_if(out + (long long)N * K + n, v, t == 0 && n < N);
      }
    }
  }
}
""", """        store_if(out + (long long)N * K + n, v, t == 0 && n < N);
      }
    }
  }
  if (!wg) asm volatile("bar.sync 1, 256;" ::: "memory");
}
""")],
    #: two pair accumulators in turn, a pair's FADDs under the next pair's
    #: products
    "dbuf": [(CUH, "dbuf.cuh", None)],
    #: a copying warpgroup issues the copies (224 / 40 / 24 registers)
    "copywg": [(CUH, "copywg.cuh", None)],
    #: the same at 216 / 40 / 40 with a copy loop of 32-bit addresses
    "copywg_lean": [(CUH, "copywg_lean.cuh", None)],
    #: and the A fragments read at 32-bit shared addresses
    "frag32": [(CUH, "frag32.cuh", None)],
    #: the splitting warpgroup reads X's raw slice as 16-byte vectors
    "split128": [(CUH, "split128.cuh", None)],
    #: the copying-warpgroup design with two pair accumulators
    "final_dbuf": [(CUH, "final_dbuf.cuh", None)],
    #: X split from global memory by the splitting warpgroup, D by TMA
    "step1": [(CUH, "step1.cuh", None)],
    #: no TMA: X split and D's fragments loaded from global memory, no
    #: per-slice barrier
    "step12": [(CUH, "step12.cuh", None)],
}
#: (rows M, width C) of the training step's blocks, each block's four
#: products (N, K): fc2 (C, 2C), fc1 (2C, C), proj (C, C), qkv (3C, C)
MODELS = {"h3wb": (("body", 999 * 24, 384), ("face", 999 * 68, 224), ("hands", 999 * 42, 256)),
          "mixste": (("block0", 4 * 243 * 134, 512), ("block1", 4 * 243 * 134, 512))}
STAGES = (("fc2", 1, 2), ("fc1", 2, 1), ("proj", 1, 1), ("qkv", 3, 1))
TURNS = 3


def tree_source(name, spec):
    """Build DIR's csrc with the spec's patches into the tree's build dir."""
    root, *patches = spec.split("+")
    dst = os.path.join(os.getcwd(), "build", "experiments", "wgrad", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "pafuse_tpu_torch", "ops", "csrc"), dst)
    for patch in patches:
        for fname, old, new in PATCHES[patch]:
            p = os.path.join(dst, fname)
            if new is None:
                shutil.copy(os.path.join(HERE, old), p)
                continue
            text = open(p).read()
            # old and new may be tuples of alternatives: the first old found
            alts = zip(old, new) if isinstance(old, tuple) else [(old, new)]
            old, new = next(((o, n) for o, n in alts if o in text), (str(old), new))
            assert text.count(old) == 1, f"{patch}: {old!r} is not where expected"
            open(p, "w").write(text.replace(old, new))
    return dst


def build(trees):
    """{name: (library, ptxas rows)} of each tree's block_train.cu."""
    procs = {}
    for name, spec in trees.items():
        dst = tree_source(name, spec)
        so = os.path.join(dst, "libblock_train.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
             os.path.join(dst, CU)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    mine = ("wgrad_wgmma_kernel", "reduce_partials_kernel")
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:        # reported, and the other trees run
            print(json.dumps({"tree": name, "nvcc_failed": log[-4000:]}), flush=True)
            continue
        rows, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
            if m:
                cur = m.group(1) if any(k in m.group(1) for k in mine) else None
                if cur:
                    rows.setdefault(cur, {"notes": []})
            m = re.search(r"\((C75(17|18|20))\).*function '(_Z\w+)'", line)
            if m and any(k in m.group(3) for k in mine):
                rows.setdefault(m.group(3), {"notes": []})["notes"].append(m.group(1))
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rows[cur]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[cur]["registers"] = int(m.group(1))
        lib = ctypes.CDLL(so)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pafuse_weight_grads.argtypes = [P, P, P, P, LL, I, I, P]
        lib.pafuse_weight_grads.restype = I
        lib.pafuse_weight_grads_part_floats.argtypes = [LL, I, I]
        lib.pafuse_weight_grads_part_floats.restype = LL
        try:
            lib.pafuse_wgrad_timers.argtypes = [P, I]
            lib.pafuse_wgrad_timers.restype = I
        except AttributeError:          # a tree without the timers patch
            pass
        libs[name] = (lib, rows)
    return libs


TIMERS = ("product_all", "wait_full", "wait_split_full", "wgmma_wait1", "drain_and_fadd",
          "bar_sync", "load_next", "product_slices", "split_all", "split_wait_full",
          "split_wait_free", "split_slices")


def timers(lib, call):
    """One call of a tree with the timers patch: each product warp's share
    of its cycles by where it spent them, and the splitting warps' alike."""
    buf = (ctypes.c_ulonglong * 16)()
    assert lib.pafuse_wgrad_timers(buf, 1) == 0
    call()
    torch.cuda.synchronize()
    assert lib.pafuse_wgrad_timers(buf, 1) == 0
    v = dict(zip(TIMERS, buf))
    out = {k: v[k] / v["product_all"] for k in TIMERS[1:7]}
    out.update({k: v[k] / v["split_all"] for k in TIMERS[9:11]})
    out["cycles_a_slice"] = v["product_all"] / v["product_slices"]
    return out


def main():
    trees = dict(a.split("=", 1) for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    libs = build(trees)
    trees = {name: spec for name, spec in trees.items() if name in libs}
    for name, (_, rows) in libs.items():
        print(json.dumps({"tree": name, "ptxas": rows}), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    first = next(iter(trees))
    totals = {model: {name: 0.0 for name in trees} for model in MODELS}
    flops = dict.fromkeys(MODELS, 0)
    for model, blocks in MODELS.items():
        for i, (block, M, C) in enumerate(blocks):
            for j, (stage, n, k) in enumerate(STAGES):
                N, K = n * C, k * C
                g = torch.Generator(device=dev).manual_seed(900 + 10 * i + j)
                d = torch.randn(M, N, generator=g, device=dev)
                x = torch.randn(M, K, generator=g, device=dev)
                want_w = d.double().t() @ x.double()
                want_b = d.double().sum(0)
                outs, parts = {}, {}
                for name, (lib, _) in libs.items():
                    parts[name] = torch.empty(lib.pafuse_weight_grads_part_floats(M, N, K),
                                              device=dev)
                    outs[name] = torch.full((N * K + N,), float("nan"), device=dev)

                def call(name):
                    err = libs[name][0].pafuse_weight_grads(
                        d.data_ptr(), x.data_ptr(), parts[name].data_ptr(),
                        outs[name].data_ptr(), M, N, K, stream)
                    assert err == 0, (name, err)

                for name in trees:
                    call(name)
                torch.cuda.synchronize()
                row = {"model": model, "block": block, "stage": stage, "M": M, "N": N, "K": K}
                for name in trees:
                    o = outs[name].double()
                    row[f"{name}_dw_rel_err"] = float(
                        (o[:N * K].view(N, K) - want_w).abs().max() / want_w.abs().max())
                    row[f"{name}_db_rel_err"] = float(
                        (o[N * K:] - want_b).abs().max() / want_b.abs().max())
                    row[f"{name}_same_bits_as_{first}"] = bool(
                        torch.equal(outs[name], outs[first]))
                for name, (lib, _) in libs.items():
                    if hasattr(lib, "pafuse_wgrad_timers"):
                        row[f"{name}_timers"] = timers(lib, lambda: call(name))
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
                for name in trees:
                    t = sorted(ms[name])[len(ms[name]) // 2]
                    row[f"{name}_ms"] = t
                    row[f"{name}_tflops"] = 2 * M * N * K / t / 1e9
                    totals[model][name] += t
                flops[model] += 2 * M * N * K
                print(json.dumps(row), flush=True)
                del d, x, want_w, want_b, outs, parts
                torch.cuda.empty_cache()
    shares = {}
    for name, spec in trees.items():
        base_spec = spec.rsplit("+", 1)[0]
        base = next((b for b, s in trees.items() if s == base_spec and "+" in spec), None)
        if base:
            shares[name] = {model: 1 - totals[model][name] / totals[model][base]
                            for model in MODELS}
    print(json.dumps({"sum_ms": totals,
                      "tflops": {model: {name: flops[model] / v / 1e9 for name, v in t.items()}
                                 for model, t in totals.items()},
                      "share_taken_away": shares}), flush=True)


if __name__ == "__main__":
    main()
