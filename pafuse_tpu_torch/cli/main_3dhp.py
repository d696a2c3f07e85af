"""MPI-INF-3DHP (17-joint body) train/eval entry point, with the override
syntax of the JAX CLI:

    python -m pafuse_tpu_torch.cli.main_3dhp model.epochs=5 model.cs=288

Counterpart of ``pafuse_tpu/cli/main_3dhp.py``: the monolithic MixSTE2
denoiser (``model.cs`` channels) on 17 joints, in metres inside the model
and millimetres outside (``mm_scale``), evaluated with the per-frame
validity masks of the test set (``losses.mpjpe_diffusion_3dhp``).  Without
``general.evaluate`` it trains ``model.epochs`` epochs (AdamW, on the
training path of ``cli.main_h3wb.make_d3dp``), evaluating at P=1, T=1 after
each and saving ``epoch_N`` every ``general.checkpoint_frequency`` epochs;
then it evaluates at the
config's P and T and appends the report to
``{general.checkpoint}/3dhp_test_log_H{P}_K{T}.txt`` (default directory
``checkpoint_3dhp``).  ``general.resume`` / ``general.evaluate`` load a
port or JAX ``.npz`` or a reference ``.bin``.  It runs on ``gpu.device``
(CUDA by default; it raises without CUDA unless ``gpu.device=cpu``).
Launched by ``torchrun`` it is data parallel as ``cli.main_h3wb`` is: the
batch rounded to whole shards, each rank on its rows of every training
batch and sampler call, only rank 0 writing checkpoints and the report.
"""

from __future__ import annotations

import os
import sys
from time import time
from typing import Optional

import numpy as np

from pafuse_tpu_torch import config as cfg_mod


def build_model_3dhp(args, device):
    """The 3DHP D3DP: monolithic, 17 joints, ``model.cs`` channels,
    millimetre scale, the 3DHP flip table, stochastic depth 0.1 in
    training, under ``cli.main_h3wb.make_d3dp``'s ``gpu`` rules."""
    from pafuse_tpu_torch import skeleton as sk
    from pafuse_tpu_torch.cli.main_h3wb import make_d3dp
    from pafuse_tpu_torch.diffusion import D3DPConfig

    cfg = D3DPConfig(
        frames=args.model.number_of_frames,
        num_kps=sk.NUM_JOINTS_3DHP,
        timesteps=args.ft2d.timestep,
        sampling_timesteps=args.ft2d.sampling_timesteps,
        num_proposals=args.ft2d.num_proposals,
        scale=args.ft2d.scale,
        depth=args.model.dep,
        input_size=args.model.input_size,
        cs=args.model.cs,
        part_based=False,
        mm_scale=True,
        drop_path_rate=0.1,
        dropout=float(args.model.dropout),
        test_time_augmentation=args.model.test_time_augmentation,
    )
    return make_d3dp(args, cfg, device, sk.FLIP_PERMUTATION_3DHP)


def evaluate_3dhp(model, test_data, args, *, num_proposals: int = 1,
                  sampling_timesteps: int = 1, window_batch: int = 64,
                  generator=None, noise_table=None,
                  timings: Optional[dict] = None, world=None):
    """Masked multi-hypothesis evaluation (``mpjpe_diffusion_3dhp``): each
    test sequence is windowed with its flipped twin and sampled (flip-TTA
    DDIM) in calls of at most ``window_batch`` windows, unpadded; the
    sequence's metric is taken over all its windows and weighted by its
    valid frames.  Returns (P_Best, P_Agg), each (S,) in mm.

    ``noise_table`` = (init, step) of shapes (windows, H, F, 17, 3) and
    (windows, S, H, F, 17, 3), in sequence then window order, injects the
    DDIM noise; otherwise it is drawn from ``generator`` (a fresh one
    seeded 0 on the model's device when omitted).  ``timings`` receives
    the window count.  With ``ft2d.debug`` only the first sequence runs.
    ``world`` (``parallel.mesh``) with a process group splits each sampler
    call's windows over the ranks (``evaluate.sharded_eval_forward``);
    every rank gets the same metrics."""
    import torch
    from pafuse_tpu_torch import geometry, losses
    from pafuse_tpu_torch.data import windows as win
    from pafuse_tpu_torch.evaluate import sharded_eval_forward
    from pafuse_tpu_torch.parallel.mesh import World
    from pafuse_tpu_torch.utils.device import to_device, to_host

    if model.training:
        raise RuntimeError("evaluate_3dhp needs the model in eval mode "
                           "(call .eval() first)")
    rf = args.model.number_of_frames
    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(w2d, wflip, lo, hi, base):
        """Windows lo..hi of a sequence whose first window is window
        ``base`` of the noise table."""
        kw = {}
        if noise_table is not None:
            init, step = (np.asarray(a, np.float32)[base + lo:base + hi]
                          for a in noise_table)
            kw = dict(init_noise=to_device(init, dev),
                      step_noise=to_device(np.moveaxis(step, 1, 0), dev))
        return sharded_eval_forward(
            model, to_device(w2d[lo:hi], dev), to_device(wflip[lo:hi], dev),
            world or World(), num_proposals=num_proposals,
            sampling_timesteps=sampling_timesteps, generator=generator, **kw)

    # one-deep readback: a sequence's metrics are read while the next one's
    # windows run
    pending, sums, n, off = None, 0.0, 0, 0
    for arrs in test_data.values():
        p2, p3, valid = arrs["data_2d"], arrs["data_3d"], arrs["valid"]
        flip = geometry.flip_pose_np(p2, model.flip_permutation)
        w2d, w3d = win.eval_data_prepare(rf, p2, p3)
        wflip, _ = win.eval_data_prepare(rf, flip)
        wvalid = valid[win.window_indices(p2.shape[0], rf)]
        nw = w2d.shape[0]
        with torch.no_grad():
            preds = torch.cat([
                sample(w2d, wflip, lo, min(lo + window_batch, nw), off)
                for lo in range(0, nw, window_batch)])
            gt, mask = to_device(w3d, dev), to_device(wvalid, dev)
            errs = torch.stack([
                losses.mpjpe_diffusion_3dhp(preds, gt, mask),
                losses.mpjpe_diffusion_3dhp(preds, gt, mask, mean_pos=True)])
        if pending is not None:
            sums = sums + pending[0].numpy().astype(np.float64) * pending[1]
        weight = int(wvalid.sum())
        pending = (to_host(errs), weight)
        n += weight
        off += nw
        if args.ft2d.debug:
            break
    if pending is not None:
        sums = sums + pending[0].numpy().astype(np.float64) * pending[1]
    if timings is not None:
        timings["windows"] = timings.get("windows", 0) + off
    out = sums / max(n, 1)
    return out[0], out[1]


def format_report(err, err_agg) -> str:
    """The ``3dhp_test_log`` text: P_Best and P_Agg per DDIM step."""
    lines = []
    for ii, (e, ea) in enumerate(zip(np.atleast_1d(err),
                                     np.atleast_1d(err_agg))):
        lines.append(f"step {ii} : 3DHP MPJPE P_Best: {float(e):f} mm")
        lines.append(f"step {ii} : 3DHP MPJPE P_Agg: {float(ea):f} mm")
    return "\n".join(lines) + "\n"


def main(argv=None):
    """Parse the overrides and run.  Returns, of the final evaluation,
    {"P_Best": (S,) mm, "P_Agg": (S,) mm, "eval_seconds": s, "windows": n,
    "report": path}."""
    args = cfg_mod.parse_cli(argv if argv is not None else sys.argv[1:])
    from pafuse_tpu_torch.parallel import mesh
    world = mesh.make_mesh(tuple(args.gpu.mesh_shape),
                           tuple(args.gpu.mesh_axis_names), args.gpu.device)
    try:
        return _run(args, world)
    finally:
        mesh.close(world)


def _run(args, world):
    device = world.device
    if not args.general.checkpoint:
        args.general.checkpoint = "checkpoint_3dhp"
    os.makedirs(args.general.checkpoint, exist_ok=True)

    from pafuse_tpu_torch import checkpoints, train as tr
    from pafuse_tpu_torch.data import dhp3

    print("Loading 3DHP dataset...")
    train_data, test_data = dhp3.load_dataset(args.data.data_dir,
                                              args.data.synthetic)
    model = build_model_3dhp(args, device)
    state = tr.create_train_state(model, seed=int(args.gpu.seed),
                                  device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"INFO: Trainable parameter count: {n_params / 1e6} Million")

    lr = args.model.learning_rate
    epoch = 0
    resume_ckpt = None
    chk = args.general.resume or args.general.evaluate
    if chk:
        chk_path = os.path.join(args.general.checkpoint, chk)
        if not os.path.exists(chk_path):
            chk_path = chk
        if chk_path.endswith(".bin"):
            checkpoints.load_weights(model, chk_path)
            restored = {"epoch": 0}
        elif args.general.resume:
            restored = checkpoints.load_state(chk_path, model, state.optimizer,
                                              state.generator)
        else:
            restored = checkpoints.load_state(chk_path, model)
        if args.general.resume:
            epoch = restored.get("epoch", 0)
            lr = restored.get("lr", lr)
            resume_ckpt = restored

    if not args.general.evaluate:
        epoch, lr = _train(args, model, state, epoch, lr, resume_ckpt,
                           train_data, test_data, world)

    model.eval()
    timings = {}
    t0 = time()
    err, err_agg = evaluate_3dhp(
        model, test_data, args, num_proposals=args.ft2d.num_proposals,
        sampling_timesteps=args.ft2d.sampling_timesteps, timings=timings,
        world=world)
    eval_seconds = time() - t0
    report = format_report(err, err_agg)
    print(report, end="")
    log_path = os.path.join(
        args.general.checkpoint,
        f"3dhp_test_log_H{args.ft2d.num_proposals}"
        f"_K{args.ft2d.sampling_timesteps}.txt")
    if world.main:
        with open(log_path, "a") as f:
            f.write(report)
    return {"P_Best": np.atleast_1d(err), "P_Agg": np.atleast_1d(err_agg),
            "eval_seconds": eval_seconds, "windows": timings["windows"],
            "report": log_path}


def _train(args, model, state, epoch, lr, resume_ckpt, train_data, test_data,
           world):
    """Epochs of training, each followed by an evaluation at P=1, T=1 and
    its log line; returns (epoch, lr)."""
    from pafuse_tpu_torch import checkpoints, skeleton as sk, train as tr
    from pafuse_tpu_torch.cli.main_h3wb import training_path_line
    from pafuse_tpu_torch.data import dhp3
    from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.parallel.mesh import per_rank_batch

    print(training_path_line(args, model))
    p3, p2 = dhp3.train_arrays(train_data)
    # the global batch, rounded to whole shards as the JAX CLI rounds it
    seqs_per_batch = world.size * per_rank_batch(
        max(1, args.model.batch_size // args.model.number_of_frames), world)
    gen = ChunkedSampler(seqs_per_batch, None, p3, p2,
                         args.model.number_of_frames,
                         augment=args.model.data_augmentation,
                         flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    if resume_ckpt is not None and "random_state" in resume_ckpt:
        gen.set_random_state(resume_ckpt["random_state"])
    loader = PrefetchingLoader(gen, depth=2)
    step_fn = tr.build_train_step(model, state.optimizer, part_based=False,
                                  world=world)
    while epoch < args.model.epochs:
        t0 = time()
        model.train()
        # the loss compares the prediction (mm) with the mm ground truth
        tot, n = tr.run_epoch(step_fn, state, lr, loader.next_epoch(),
                              seqs_per_batch, quickdebug=args.ft2d.debug)
        model.eval()
        err, err_agg = evaluate_3dhp(model, test_data, args, world=world)
        print(f"[{epoch + 1}] time {(time() - t0) / 60:.2f} lr {lr:f} "
              f"train {tot / max(n, 1):.4f} "
              f"valid P_Best {float(np.atleast_1d(err)[0]):.2f}mm "
              f"P_Agg {float(np.atleast_1d(err_agg)[0]):.2f}mm")
        lr *= args.model.lr_decay
        epoch += 1
        if epoch % args.general.checkpoint_frequency == 0 and world.main:
            checkpoints.save_state(args.general.checkpoint, f"epoch_{epoch}",
                                   model=model, optimizer=state.optimizer,
                                   epoch=epoch, lr=lr,
                                   random_state=gen.random_state(),
                                   generator=state.generator)
        if args.ft2d.debug and epoch >= 1:
            break
    return epoch, lr


if __name__ == "__main__":
    main()
