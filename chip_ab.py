"""Two investigations on the card, each in one call (see PERF.md §6):

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

    python3 chip_ab.py --parent build/parent --routing 50
    python3 chip_ab.py --suite --routing 50

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout of the port")
    ap.add_argument("--routing", type=int, default=0,
                    help="runs of the kernel #2 routing check")
    ap.add_argument("--suite", action="store_true",
                    help="run tests/test_torch_cuda.py in this process first")
    ap.add_argument("--worker", choices=("parent", "change"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.worker:
        sys.path.insert(0, os.getcwd())     # the tree under test comes first
        worker(args.worker)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi})
    results = []
    if args.parent:
        parent = os.path.abspath(args.parent)
        for mode, tree in (("parent", parent), ("change", HERE),
                           ("change", HERE), ("parent", parent)):
            env = dict(os.environ, PYTHONPATH=tree)
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--worker", mode], cwd=tree, env=env,
                               capture_output=True, text=True, timeout=900)
            sys.stderr.write(r.stderr[-3000:])
            if r.returncode != 0:
                raise RuntimeError(f"{mode} worker failed: {r.stderr[-2000:]}")
            for line in r.stdout.splitlines():
                if line.startswith("{"):
                    results.append(json.loads(line))
                    print(line, flush=True)
        summary = {}
        for res in results:
            key = f'{res["window"]}_{res["mode"]}'
            summary.setdefault(key, []).append(res["idle_share"])
        emit({"phase": "idle_shares", "runs": summary})
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
