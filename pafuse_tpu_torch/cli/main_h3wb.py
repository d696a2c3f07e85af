"""H3WB train/eval entry point, with the override syntax of the JAX CLI:

    python -m pafuse_tpu_torch.cli.main_h3wb ft2d.num_proposals=10 \\
        ft2d.sampling_timesteps=5 general.evaluate=best_epoch.npz

Counterpart of ``pafuse_tpu/cli/main_h3wb.py``.  Without
``general.evaluate`` it trains (AdamW, the training block kernels) for
``model.epochs`` epochs with an evaluation at P=1, T=1 after each, saves
``epoch_N`` and ``best_epoch`` checkpoints, then evaluates every test
action at the config's P and T and appends the reports to
``{general.checkpoint}/h36m_test_log_H{P}_K{T}.txt``.  With
``general.evaluate=<checkpoint>`` (a port or JAX ``.npz``, or a reference
``.bin``) it only evaluates.  It runs on ``gpu.device`` (CUDA by default;
it raises without CUDA unless ``gpu.device=cpu``); ``gpu.use_pallas``
selects the evaluation block (``block_t`` and ``layer`` only with
``gpu.experimental_kernels=true``).  It logs to ``logging.log``,
``training_log.txt`` and, without ``general.nolog``, a TensorBoard event
file in the log directory (the JAX CLI's tags); ``gpu.profile=true``
traces the first trained epoch into ``{general.checkpoint}/profile``.
MLflow is not ported.

Data parallel: launched by ``torchrun`` it trains and evaluates on every
rank of the launch (``gpu.mesh_shape``, ``parallel.mesh``), one card each:

    torchrun --standalone --nproc_per_node=8 \\
        -m pafuse_tpu_torch.cli.main_h3wb general.checkpoint=ckpt

The batch is rounded to whole shards as the JAX CLI rounds it, each rank
trains on its rows of every global batch and evaluates its rows of every
window batch; only rank 0 writes files (checkpoints, logs, reports, the
event file, the trace).
"""

from __future__ import annotations

import contextlib
import os
import sys
from datetime import datetime
from time import time
from typing import Dict, List

import numpy as np

from pafuse_tpu_torch import config as cfg_mod
from pafuse_tpu_torch.utils.misc import Logger, Timer


def build_model(args, device, flip_permutation=None):
    """The D3DP of the config: part-based unless
    ``general.part_based_model=false``, stochastic depth 0.1 in training,
    on :func:`make_d3dp`'s rules.
    One module serves training (``.train()``, the training kernels) and
    evaluation (``.eval()``)."""
    from pafuse_tpu_torch.diffusion import D3DPConfig

    if args.model.diff_model != "MixSTE2":
        raise ValueError(
            f"The model {args.model.diff_model!r} does not exist "
            "(model.diff_model supports only 'MixSTE2')")
    cfg = D3DPConfig(
        frames=args.model.number_of_frames,
        num_kps=args.data.num_kps,
        timesteps=args.ft2d.timestep,
        sampling_timesteps=args.ft2d.sampling_timesteps,
        num_proposals=args.ft2d.num_proposals,
        scale=args.ft2d.scale,
        depth=args.model.dep,
        input_size=args.model.input_size,
        cs=args.model.cs,
        part_based=args.general.part_based_model,
        merge_hands=args.data.merge_hands,
        drop_path_rate=0.1,
        dropout=float(args.model.dropout),
        test_time_augmentation=args.model.test_time_augmentation,
    )
    return make_d3dp(args, cfg, device, flip_permutation)


def make_d3dp(args, cfg, device, flip_permutation=None):
    """``D3DP(cfg)`` under the config's ``gpu`` keys: the evaluation
    functions of ``gpu.use_pallas`` behind the ``gpu.experimental_kernels``
    gate (read per build, as the JAX CLI does), the activations' dtype of
    ``gpu.compute_dtype``, the training path of ``gpu.train_kernel`` (and
    of ``model.dropout``) with ``gpu.remat``, weights from ``gpu.seed``."""
    import torch
    from pafuse_tpu_torch.diffusion import D3DP

    return D3DP(cfg, device=device,
                generator=torch.Generator().manual_seed(int(args.gpu.seed)),
                use_pallas=args.gpu.use_pallas,
                experimental_kernels=_on(args.gpu.experimental_kernels),
                flip_permutation=flip_permutation,
                compute_dtype=args.gpu.compute_dtype,
                train_kernel=args.gpu.train_kernel,
                remat=_on(args.gpu.remat))


def _on(value) -> bool:
    return str(value).lower() in ("true", "1", "on", "yes")


def training_path_line(args, model) -> str:
    """The log line that names the training path the model takes."""
    if model.train_path == "kernels":
        path, why = "kernels #5/#6", f"gpu.train_kernel={args.gpu.train_kernel}"
    else:
        path = "autodiff" + (", remat" if _on(args.gpu.remat) else "")
        why = (f"model.dropout={args.model.dropout}: the training kernels "
               "have no dropout" if float(args.model.dropout) > 0
               else f"gpu.train_kernel={args.gpu.train_kernel}")
    return (f"INFO: Training path: {path} ({why}); compute dtype "
            f"{args.gpu.compute_dtype}")


def collect_actions(dataset, subjects_test):
    """Test actions grouped by base name, overall and per subject."""
    all_actions: Dict[str, List] = {}
    by_subject: Dict[str, Dict[str, List]] = {}
    for subject in subjects_test:
        by_subject.setdefault(subject, {})
        for action in dataset[subject].keys():
            name = action.split(" ")[0]
            all_actions.setdefault(name, []).append((subject, action))
            by_subject[subject].setdefault(name, []).append((subject, action))
    return all_actions, by_subject


def main(argv=None):
    """Parse the overrides and run.  Returns, of the final evaluation,
    {"final": {tag: action-wise average (mm)}, "eval_seconds": s,
    "windows": n, "batches": n, "window_batch": rows, "tail_rows_saved": n}
    (tag "all", or each subject with ``general.by_subject``; a batch
    dispatches ``window_batch`` rows less those its tail bucket saved)."""
    args = cfg_mod.parse_cli(argv if argv is not None else sys.argv[1:])
    if args.mlflow.mlflow_on:
        raise NotImplementedError("mlflow.mlflow_on=true: MLflow logging is "
                                  "not ported (ROADMAP.md)")
    if int(args.experiment.warmup) != 1:
        # the reference's hydra entry point reads it nowhere
        raise ValueError("experiment.warmup is not implemented (the "
                         "reference's hydra entry point ignores it); remove "
                         "the override")
    from pafuse_tpu_torch.parallel import mesh
    from pafuse_tpu_torch.utils import observability as obs
    world = mesh.make_mesh(tuple(args.gpu.mesh_shape),
                           tuple(args.gpu.mesh_axis_names), args.gpu.device)
    stdout, logger, writer = sys.stdout, None, None
    try:
        timestamp = mesh.broadcast_object(
            datetime.now().strftime("%Y%m%dT%H-%M-%S"), world)
        description = "Evaluate!" if args.general.evaluate else "Train!"
        if not args.general.nolog and world.main:
            logdir = f"{args.general.log}_{timestamp}"
            logger = Logger(os.path.join(logdir, "logging.log"))
            writer = obs.make_summary_writer(logdir)
            if writer is not None:
                writer.add_text("description", description)
                writer.add_text("command", "python " + " ".join(sys.argv))
            sys.stdout = logger
        return _run(args, world, timestamp, writer)
    finally:
        if writer is not None:
            writer.close()
        if logger is not None:
            sys.stdout = stdout
            logger.close()
        mesh.close(world)


def _run(args, world, timestamp, writer=None):
    import torch
    from pafuse_tpu_torch import checkpoints, evaluate as ev, train as tr
    from pafuse_tpu_torch.data import h3wb

    print("Evaluate!" if args.general.evaluate else "Train!")
    print("==> Using settings:")
    print(cfg_mod.to_yaml(args))
    if not args.general.checkpoint:
        args.general.checkpoint = f"{args.general.log}_{timestamp}"
    os.makedirs(args.general.checkpoint, exist_ok=True)
    device = world.device
    print(f"Torch device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"INFO: data-parallel world: rank {world.rank} of {world.size} "
          + (f"({torch.distributed.get_backend()})" if world.distributed
             else "(no process group)"))

    # ---- data ------------------------------------------------------------
    print("Loading dataset...")
    dataset = h3wb.load_dataset(
        args.data.data_dir, args.data.synthetic,
        actions_per_subject=int(args.data.synthetic_actions),
        frames_per_action=int(args.data.synthetic_frames))
    keypoints = h3wb.prepare_data(dataset)
    subjects_train = args.data.subjects_train.split(",")
    subjects_test = ([args.viz.viz_subject] if args.general.render
                     else args.data.subjects_test.split(","))
    action_filter = (None if args.data.actions == "*"
                     else args.data.actions.split(","))
    receptive_field = args.model.number_of_frames
    print(f"INFO: Receptive field: {receptive_field} frames")

    # ---- model -------------------------------------------------------------
    model = build_model(args, device,
                        flip_permutation=dataset.flip_permutation)
    state = tr.create_train_state(model, seed=int(args.gpu.seed),
                                  device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"INFO: Trainable parameter count: {n_params / 1e6} Million")

    # ---- resume / evaluate checkpoint --------------------------------------
    epoch = 0
    lr = args.model.learning_rate
    resume_ckpt = None
    chk = args.general.resume or args.general.evaluate
    if chk == "auto":
        chk = checkpoints.latest_checkpoint(args.general.checkpoint) or ""
        if chk:
            print(f"Auto-resume from {chk}")
    if chk:
        chk_path = os.path.join(args.general.checkpoint, chk)
        if not os.path.exists(chk_path):
            chk_path = chk
        print("Loading checkpoint", chk_path)
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
            if not args.model.coverlr:
                lr = restored.get("lr", lr)
            resume_ckpt = restored
        print(f"This model was trained for {restored.get('epoch', 0)} epochs")

    # ---- validation data ---------------------------------------------------
    cams_valid, poses_valid, poses_valid_2d = h3wb.fetch(
        subjects_test, keypoints, dataset, stride=args.experiment.downsample,
        action_filter=action_filter)
    print(f"INFO: Testing on {sum(p.shape[0] for p in poses_valid_2d)} frames")
    # one window-batch size for every evaluation of this run
    pin_bs = ev.pinned_window_batch(poses_valid_2d, receptive_field)

    if not args.general.evaluate:
        _train(args, model, state, epoch, lr, resume_ckpt, dataset, keypoints,
               subjects_train, action_filter, pin_bs,
               (cams_valid, poses_valid, poses_valid_2d), world, writer)

    # ---- final evaluation --------------------------------------------------
    print("Evaluating...")
    model.eval()
    all_actions, by_subject = collect_actions(dataset, subjects_test)
    timings = {}

    def run_evaluation(actions):
        per_action, per_action_p2 = {}, {}
        for action_key in sorted(actions.keys()):
            if action_filter is not None and not any(
                    action_key.startswith(a) for a in action_filter):
                continue
            cams_act, poses_act, poses_2d_act = h3wb.fetch_actions(
                actions[action_key], keypoints, dataset,
                stride=args.experiment.downsample)
            acc, p2 = ev.evaluate_sequences(
                model, zip(cams_act, poses_act, poses_2d_act),
                receptive_field=receptive_field,
                num_proposals=args.ft2d.num_proposals,
                sampling_timesteps=args.ft2d.sampling_timesteps,
                window_batch=pin_bs, quickdebug=args.ft2d.debug,
                collect_p2=args.ft2d.p2, timings=timings, world=world)
            means = acc.means_mm()
            p2m = p2.means_mm() if (p2 is not None and p2.n > 0) else None
            report = ev.format_report(means, action_key, p2m)
            print(report)
            if world.main:
                ev.write_report(args.general.checkpoint,
                                args.ft2d.num_proposals,
                                args.ft2d.sampling_timesteps, report)
            per_action[action_key] = means
            if p2m is not None:
                per_action_p2[action_key] = p2m
        if not per_action:
            return None

        def avg_of(dicts):
            keys = next(iter(dicts.values())).keys()
            return {k: np.mean([m[k] for m in dicts.values()], axis=0)
                    for k in keys}
        avg = avg_of(per_action)
        text = ev.format_actionwise_average(
            avg, avg_of(per_action_p2) if per_action_p2 else None)
        print(text)
        if world.main:
            ev.write_report(args.general.checkpoint, args.ft2d.num_proposals,
                            args.ft2d.sampling_timesteps, text)
        return avg

    final = {}
    with Timer("Evaluation took") as timer:
        if not args.general.by_subject:
            final["all"] = run_evaluation(all_actions)
        else:
            for subject, actions in by_subject.items():
                print("Evaluating on subject", subject)
                final[subject] = run_evaluation(actions)
    return {"final": final, "eval_seconds": timer.elapsed,
            "windows": timings.get("windows", 0),
            "batches": timings.get("batches", 0), "window_batch": pin_bs,
            "tail_rows_saved": timings.get("tail_rows_saved", 0)}


def _train(args, model, state, epoch, lr, resume_ckpt, dataset, keypoints,
           subjects_train, action_filter, pin_bs, valid, world, writer=None):
    """Epochs of training, each followed by an evaluation at P=1, T=1 and
    (on rank 0) the checkpoints, the log line and the TensorBoard scalars;
    the model ends in train mode."""
    from pafuse_tpu_torch import checkpoints, evaluate as ev, train as tr
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.parallel.mesh import per_rank_batch
    from pafuse_tpu_torch.utils import observability as obs

    receptive_field = args.model.number_of_frames
    cams_train, poses_train, poses_train_2d = h3wb.fetch(
        subjects_train, keypoints, dataset, stride=args.experiment.downsample,
        action_filter=action_filter, subset=args.experiment.subset)
    # the global batch, rounded to whole shards as the JAX CLI rounds it
    seqs_per_batch = world.size * per_rank_batch(
        max(1, args.model.batch_size // receptive_field), world)
    train_gen = ChunkedSampler(
        seqs_per_batch, cams_train, poses_train, poses_train_2d,
        receptive_field, shuffle=True, augment=args.model.data_augmentation,
        flip_permutation=dataset.flip_permutation)
    # background-thread prefetch: batch assembly overlaps the device step
    train_loader = PrefetchingLoader(train_gen, depth=2)
    print(f"INFO: Training on {train_gen.num_frames() * receptive_field} "
          "frames")
    if resume_ckpt is not None and "random_state" in resume_ckpt:
        train_gen.set_random_state(resume_ckpt["random_state"])

    print(training_path_line(args, model))
    weights = (tr.mixste_weight_table(args.data.num_kps)
               if args.model.weighted_loss else None)
    step_fn = tr.build_train_step(
        model, state.optimizer, weights=weights, mse_loss=args.model.mse_loss,
        wb_loss=args.model.wb_loss, part_based=args.general.part_based_model,
        world=world)

    log_path = os.path.join(args.general.checkpoint, "training_log.txt")
    quickdebug = args.ft2d.debug
    min_loss = args.model.min_loss
    train_curve, valid_curve = [], []
    first_epoch = epoch
    while epoch < args.model.epochs:
        start_time = time()
        model.train()
        num_batches = train_gen.batch_num()
        # gpu.profile: a torch.profiler trace of the first trained epoch
        with (obs.profile_trace(os.path.join(args.general.checkpoint,
                                             "profile"), world.device)
              if _on(args.gpu.profile) and epoch == first_epoch
              and world.main else contextlib.nullcontext()):
            epoch_loss, n_seen = tr.run_epoch(
                step_fn, state, lr, train_loader.next_epoch(), seqs_per_batch,
                rows_weight=receptive_field, quickdebug=quickdebug,
                progress=lambda it: (print(f"{it}/{num_batches}")
                                     if it % 10 == 0 else None))
        epoch_loss_mm = epoch_loss / max(n_seen, 1) * 1000

        # per-epoch evaluation at P=1, T=1 with flip-TTA
        val_mm, val_pb_mm = float("nan"), float("nan")
        if not args.experiment.no_eval:
            model.eval()
            acc, _ = ev.evaluate_sequences(
                model, zip(*valid), receptive_field=receptive_field,
                num_proposals=1, sampling_timesteps=1, window_batch=pin_bs,
                quickdebug=quickdebug, world=world)
            model.train()
            means = acc.means_mm()
            val_mm = float(np.atleast_1d(means["P_Best"])[0])
            val_pb_mm = float(np.atleast_1d(means["P_Best_PB"])[0])

        elapsed = (time() - start_time) / 60
        log = (f"[{epoch + 1}] time {elapsed:.2f} lr {lr:f} "
               f"3d_train {epoch_loss_mm:f} 3d_pos_valid {val_mm:f} "
               f"3d_pb_pos_valid {val_pb_mm:f}")
        print(log)
        if world.main:
            with open(log_path, "a") as f:
                f.write(log + "\n")
        if writer is not None:
            writer.add_scalar("Loss/3d training loss", epoch_loss_mm,
                              epoch + 1)
            writer.add_scalar("Loss/3d validation loss", val_mm, epoch + 1)
            writer.add_scalar("Parameters/learing rate", lr, epoch + 1)
            writer.add_scalar("Parameters/training time per epoch", elapsed,
                              epoch + 1)

        lr *= args.model.lr_decay
        epoch += 1
        ckpt = dict(model=model, optimizer=state.optimizer, epoch=epoch, lr=lr,
                    random_state=train_gen.random_state(),
                    generator=state.generator)
        if epoch % args.general.checkpoint_frequency == 0 and world.main:
            checkpoints.save_state(args.general.checkpoint, f"epoch_{epoch}",
                                   **ckpt)
        if val_mm < min_loss:
            min_loss = val_mm
            if world.main:
                checkpoints.save_state(args.general.checkpoint, "best_epoch",
                                       **ckpt)
                with open(log_path, "a") as f:
                    f.write("best epoch\n")

        train_curve.append(epoch_loss_mm)
        valid_curve.append(val_mm)
        if args.general.export_training_curves and epoch > 3 and world.main:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.figure()
            epoch_x = np.arange(3, len(train_curve)) + 1
            plt.plot(epoch_x, train_curve[3:], "--", color="C0")
            plt.plot(epoch_x, valid_curve[3:], color="C1")
            plt.legend(["3d train", "3d valid (eval)"])
            plt.ylabel("MPJPE (mm)")
            plt.xlabel("Epoch")
            plt.xlim((3, epoch))
            plt.savefig(os.path.join(args.general.checkpoint, "loss_3d.png"))
            plt.close("all")
        if quickdebug and epoch >= 1:
            break


if __name__ == "__main__":
    main()
