"""The float32 wgmma GEMM (gemm_sm90.cuh's gemm_kernel) of several trees
side by side in one process on the card.

Each tree's ``csrc/gemm.cu`` is built alone (the package's nvcc flags, all
trees at once) into ``build/experiments/gemm_f32/<name>/`` with ptxas's
report of every ``gemm_kernel`` instantiation (registers, spill bytes,
C7517/C7518/C7520 notes).  Then each tree's ``pafuse_linear_sm90`` (what
``ops.gemm.fused_linear`` calls: the weight split, the row statistics and
the GEMM) runs on the same seeded float32 inputs at serve bucket 16's four
stages of each part (16 windows x P=10 x flip x 27 frames x the part's
joints; qkv with the LayerNorm, proj + residual, fc1 with the LayerNorm and
GELU, fc2 + residual): device ms (CUDA events, 2 warm and 10 timed calls a
turn, the trees in turns A B C C B A, the median of the turns), TFLOP/s
(2 M N K), the largest difference from ``ops.gemm.linear_reference`` and
whether every tree's output equals the first tree's bit for bit.

A tree given as ``NAME=DIR+PATCH`` is DIR's source with PATCHES[PATCH]
applied: ``nostore`` takes the epilogue's global stores of Y out of a tree
that stores from the accumulators (the products, the bias and the
activation stay, R is still read), so the difference from DIR is what the
stores cost; ``t288`` runs the kernel on 288 threads without setmaxnreg.

    python3 experiments/gemm_f32/run.py parent=build/parent change=.
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
from pafuse_tpu_torch.ops.gemm import linear_reference  # noqa: E402

#: text patches of gemm_sm90.cuh a tree may name after "+": "nostore"
#: keeps the epilogue's global stores of Y from running (a design that
#: stores from the accumulators), "t288" runs the consumers in a 288-thread
#: CTA (a producer warp, no setmaxnreg: 168 registers a thread), "r240"
#: gives the consumers 240 registers and the producer 24, "r224" 224 and 56
SETMAXNREG = [
    '    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" '
    '::"n"(PRODUCER_REGS));\n',
    '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" '
    '::"n"(CONSUMER_REGS));\n']
REGS = "constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;"
PATCHES = {
    "nostore": [("        store2<TY>(Y + m * N + n, y0, y1);",
                 "        if (y0 == 1.2345e38f && y1 == -1.2345e38f) "
                 "store2<TY>(Y + m * N + n, y0, y1);")],
    "t288": [("constexpr int F32_THREADS = 384;", "constexpr int F32_THREADS = 288;"),
             (SETMAXNREG[0], ""), (SETMAXNREG[1], "")],
    "r240": [(REGS, "constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;")],
    "r224": [(REGS, "constexpr int CONSUMER_REGS = 224, PRODUCER_REGS = 56;")],
}
PARTS = (("body", 24, 384), ("face", 68, 224), ("hands", 42, 256))
WINDOWS = 16 * 10 * 2 * 27
TURNS = 3


def build(trees):
    """{name: (library, ptxas rows)} of each tree's gemm.cu."""
    out = os.path.join(os.getcwd(), "build", "experiments", "gemm_f32")
    procs = {}
    for name, spec in trees.items():
        root, _, patch = spec.partition("+")
        dst = os.path.join(out, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, "pafuse_tpu_torch", "ops", "csrc"), dst)
        p = os.path.join(dst, "gemm_sm90.cuh")
        text = open(p).read()
        for old, new in PATCHES.get(patch, ()):
            assert text.count(old) == 1, f"{patch}: {old!r} is not where expected"
            text = text.replace(old, new)
        open(p, "w").write(text)
        so = os.path.join(dst, "libgemm.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
             os.path.join(dst, "gemm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        rows, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
            if m:
                cur = m.group(1) if "gemm_kernel" in m.group(1) else None
                if cur:
                    rows.setdefault(cur, {"notes": []})
            m = re.search(r"\((C75(17|18|20))\).*function '(_Z\w+)'", line)
            if m and "gemm_kernel" in m.group(3):
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
        lib.pafuse_linear_sm90.argtypes = [I, I, I] + [P] * 8 + [LL, LL, I, I, P]
        lib.pafuse_linear_sm90.restype = I
        libs[name] = (lib, rows)
    return libs


def main():
    trees = dict(a.split("=", 1) for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    libs = build(trees)
    for name, (_, rows) in libs.items():
        print(json.dumps({"tree": name, "ptxas": rows}), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    totals = {name: [0.0, 0.0] for name in trees}       # ms, FLOPs
    for i, (part, joints, C) in enumerate(PARTS):
        M = WINDOWS * joints
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        a = {K: torch.randn(M, K, generator=g, device=dev) for K in (C, 2 * C)}
        res = torch.randn(M, C, generator=g, device=dev)
        for stage, N, K, pro, epi in (("qkv", 3 * C, C, 1, 0), ("proj", C, C, 0, 2),
                                      ("fc1", 2 * C, C, 1, 1), ("fc2", C, 2 * C, 0, 2)):
            w = torch.randn(N, K, generator=g, device=dev) / K ** 0.5
            b = 0.1 * torch.randn(N, generator=g, device=dev)
            ln = (1 + 0.1 * torch.randn(K, generator=g, device=dev),
                  0.1 * torch.randn(K, generator=g, device=dev)) if pro else None
            r = res if epi == 2 else None
            ws = torch.empty(8 * N * K + 8 * M, dtype=torch.uint8, device=dev)
            want = linear_reference(a[K], w, b, ln, ("store", "gelu", "residual")[epi], r)
            ys = {}

            def call(name, y):
                err = libs[name][0].pafuse_linear_sm90(
                    0, pro, epi, a[K].data_ptr(), w.data_ptr(), b.data_ptr(),
                    ln[0].data_ptr() if ln else None, ln[1].data_ptr() if ln else None,
                    r.data_ptr() if r is not None else None, y.data_ptr(), ws.data_ptr(),
                    ws.numel(), M, N, K, stream)
                assert err == 0, (name, err)

            for name in trees:
                ys[name] = torch.full((M, N), float("nan"), device=dev)
                call(name, ys[name])
            torch.cuda.synchronize()
            first = next(iter(trees))
            row = {"part": part, "stage": stage, "M": M, "N": N, "K": K}
            for name in trees:
                row[f"{name}_max_abs_err"] = float((ys[name] - want).abs().max())
                row[f"{name}_same_bits_as_{first}"] = bool(torch.equal(ys[name], ys[first]))
            ms = {name: [] for name in trees}
            order = list(trees) + list(trees)[::-1]
            for _ in range(TURNS):
                for name in order:
                    y = ys[name]
                    for _ in range(2):
                        call(name, y)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(10):
                        call(name, y)
                    e1.record()
                    torch.cuda.synchronize()
                    ms[name].append(e0.elapsed_time(e1) / 10)
            for name in trees:
                t = sorted(ms[name])[len(ms[name]) // 2]
                row[f"{name}_ms"] = t
                row[f"{name}_tflops"] = 2 * M * N * K / t / 1e9
                totals[name][0] += t
                totals[name][1] += 2 * M * N * K
            print(json.dumps(row), flush=True)
            del ys, want, ws
        del a, res
        torch.cuda.empty_cache()
    print(json.dumps({"sum_ms": {n: v[0] for n, v in totals.items()},
                      "tflops": {n: v[1] / v[0] / 1e9 for n, v in totals.items()}}), flush=True)


if __name__ == "__main__":
    main()
