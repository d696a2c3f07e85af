"""Dry run of the port: one denoiser step of the flagship model, then one
pass over every data-parallel path.

Counterpart of the repository's ``__graft_entry__.py`` (which stays the JAX
package's):

* :func:`entry` returns ``(fn, args)``: one flip-TTA ``_model_predictions``
  step of the flagship part-based model (the ``D3DPConfig`` defaults at
  P=4) on inputs drawn from ``np.random.RandomState(0)``;
* :func:`dryrun_multichip` runs, over the data-parallel world, one DDP
  training step, one sharded evaluation step, a two-tier
  ``LiftingService`` whose replicas sit on the ranks' devices, and a
  three-push ``StreamingSession``, and returns the loss, J_Best and the
  shapes.

Run it on one card with ``python -m pafuse_tpu_torch.dryrun``, or on N
ranks with ``torchrun --nproc_per_node=N -m pafuse_tpu_torch.dryrun``
(``parallel.mesh.make_mesh``: NCCL, one card a rank; gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pafuse_tpu_torch import geometry
from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
from pafuse_tpu_torch.parallel import mesh


def entry(device="cuda"):
    """(fn, args): ``fn(model, x_t, x2d_tiled, x2d_flip_tiled)`` is one DDIM
    ``_model_predictions`` step at t=500 with flip-TTA of the flagship
    model (seeded weights, ``use_pallas=auto``: kernel #1 on the card) at
    B=2, H=4, returning x_start (2, 4, 27, 134, 3)."""
    cfg = D3DPConfig(num_proposals=4, sampling_timesteps=2)
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(0))
    B, H, F, N = 2, 4, cfg.frames, cfg.num_kps
    rng = np.random.RandomState(0)

    def draw(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=model.device)

    x_t = draw(B, H, F, N, 3)
    x2d_tiled = draw(B * H, F, N, 2)
    x2d_flip_tiled = draw(B * H, F, N, 2)

    @torch.no_grad()
    def fn(model, x_t, x2d_tiled, x2d_flip_tiled):
        _, x_start = model._model_predictions(x_t, x2d_tiled, 500,
                                              x2d_flip_tiled)
        return x_start

    return fn, (model, x_t, x2d_tiled, x2d_flip_tiled)


def _gathered_devices(world: mesh.World) -> list:
    """Every rank's device, in rank order."""
    devices = [None] * world.size
    dist.all_gather_object(devices, str(world.device))
    return devices


def dryrun_multichip(n_devices: int, device="cuda",
                     world: Optional[mesh.World] = None) -> dict:
    """One pass over the data-parallel paths on a world of ``n_devices``
    ranks (``world``, or ``parallel.mesh.make_mesh(device=device)``, which
    is left after): a DDP training step (frames 9, timesteps 50, depth 2,
    drop-path 0.1, global batch 2n), a sharded evaluation step of the
    trained weights (P=2, T=2), a ``LiftingService`` (buckets (2,), tiers
    2x2 and 1x1; on rank 0, one replica on each rank's device) lifting 18
    frames and, at 1x1, 9, and a three-push ``StreamingSession`` at 1x1.
    Every rank returns {"loss", "J_Best" (metres), "poses" (the lift's
    shape), "poses_1x1", "num_hypotheses_1x1", "buckets", "op_points",
    "stream_emits"}; any non-finite value raises."""
    from pafuse_tpu_torch import evaluate as ev, train as tr
    from pafuse_tpu_torch import serve as srv
    own = world is None
    if own:
        world = mesh.make_mesh(device=device)
    try:
        if world.size != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                             f"{world.size}; launch {n_devices} ranks")
        dev = world.device
        cfg = D3DPConfig(frames=9, timesteps=50, depth=2, drop_path_rate=0.1)
        model = D3DP(cfg, device=dev,
                     generator=torch.Generator().manual_seed(0))
        state = tr.create_train_state(model, seed=0, device=dev)
        step = tr.build_train_step(model, state.optimizer, world=world)

        B = 2 * n_devices
        rng = np.random.RandomState(0)
        x2d = rng.randn(B, 9, 134, 2).astype(np.float32)
        x3d = (rng.randn(B, 9, 134, 3) * 0.1).astype(np.float32)
        loss = float(step(state, 1e-4, x2d, x3d))
        if not np.isfinite(loss):
            raise AssertionError(f"dryrun: training loss {loss}")
        print(f"dryrun_multichip({n_devices}): train step OK, "
              f"loss={loss:.4f}", flush=True)

        # sharded multi-hypothesis evaluation of the trained weights
        eval_model = D3DP(dataclasses.replace(cfg, drop_path_rate=0.0),
                          device=dev)
        eval_model.pose_estimator.load_state_dict(
            model.pose_estimator.state_dict())
        eval_step = ev.get_eval_step(eval_model, num_proposals=2,
                                     sampling_timesteps=2, world=world)
        x2d_t = torch.as_tensor(x2d, device=dev)
        x3d_t = torch.as_tensor(x3d, device=dev)
        cam = torch.as_tensor(np.tile(rng.rand(9).astype(np.float32),
                                      (B, 1)), device=dev)
        metrics = eval_step(x2d_t, x2d_t, geometry.center_pose_parts(x3d_t),
                            x3d_t[:, :, :1], cam,
                            torch.ones(B, device=dev),
                            generator=torch.Generator(dev).manual_seed(0))
        jb = float(metrics["J_Best"].reshape(-1)[0])
        if not np.isfinite(jb):
            raise AssertionError(f"dryrun: J_Best {jb}")
        print(f"dryrun_multichip({n_devices}): sharded eval step OK, "
              f"J_Best={jb * 1000:.2f} mm", flush=True)

        # serving: one two-tier service with a replica on each rank's device
        devices = _gathered_devices(world) if world.distributed else None
        served = None
        if world.main:
            svc = srv.LiftingService(eval_model, buckets=(2,),
                                     op_points=[(2, 2), (1, 1)], device=dev,
                                     devices=devices)
            try:
                out = svc.lift(rng.randn(18, 134, 2).astype(np.float32),
                               seed=3)
                out11 = svc.lift(rng.randn(9, 134, 2).astype(np.float32),
                                 seed=3, op_point="1x1")
                sess = srv.StreamingSession(svc, seed=5, op_point=(1, 1))
                emits = [sess.push(rng.randn(134, 2).astype(np.float32))
                         for _ in range(3)]
                if not all(np.all(np.isfinite(o["poses"]))
                           for o in [out, out11] + emits):
                    raise AssertionError("dryrun: non-finite served poses")
                served = {"poses": tuple(out["poses"].shape),
                          "poses_1x1": tuple(out11["poses"].shape),
                          "num_hypotheses_1x1": out11["num_hypotheses"],
                          "buckets": tuple(svc.buckets),
                          "op_points": tuple(svc.op_points),
                          "stream_emits": sess.frames_pushed}
            finally:
                svc.close()
            print(f"dryrun_multichip({n_devices}): serving OK on "
                  f"{devices or [str(dev)]}, buckets={served['buckets']}, "
                  f"tiers={served['op_points']}, stream emits "
                  f"{served['stream_emits']}", flush=True)
        served = mesh.broadcast_object(served, world)
        return {"loss": loss, "J_Best": jb, **served}
    finally:
        if own:
            mesh.close(world)


def main() -> int:
    """Like ``__graft_entry__``'s ``__main__``: the entry step, then the
    dry run over the launched world (one rank without a launcher)."""
    world = mesh.make_mesh()
    try:
        fn, args = entry(world.device)
        out = fn(*args)
        if world.main:
            print("entry OK:", tuple(out.shape), flush=True)
        dryrun_multichip(world.size, world=world)
    finally:
        mesh.close(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
