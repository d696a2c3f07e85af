"""Serve the lifting model over HTTP: load the weights onto the card once,
warm every bucket and tier, then answer 2D->3D requests until stopped.

Counterpart of ``pafuse_tpu/cli/serve.py``, with the same overrides; see
``pafuse_tpu_torch/serve.py`` for the design (resident weights, dynamic
batching, noise modes, readback, op-point tiers, streaming sessions).

Usage:
    python -m pafuse_tpu_torch.cli.serve general.evaluate=best_epoch.npz \\
        ft2d.num_proposals=10 ft2d.sampling_timesteps=5 serve.port=8012

    curl -s localhost:8012/healthz
    curl -s -X POST localhost:8012/lift -d \\
        '{"keypoints": [[[x, y], ...134 joints] ...frames],
          "width": 1000, "height": 1002, "world": true}'
    curl -s localhost:8012/metrics

It runs on ``gpu.device`` (CUDA by default; it raises without CUDA unless
``gpu.device=cpu``).  With ``serve.shard=auto`` and more than one visible
card it serves on all of them (``gpu.mesh_shape`` [-1], or the card count):
one replica each, the rows of every sampler call split over them.
"""

from __future__ import annotations

import os
import sys

from pafuse_tpu_torch import config as cfg_mod


def _mode(args, key: str) -> str:
    """``serve.<key>`` as auto|off (YAML parses a bare ``off`` as False)."""
    v = str(getattr(args.serve, key, "auto")).lower()
    if v in ("false", "none", "0"):
        v = "off"
    if v not in ("auto", "off"):
        raise ValueError(f"serve.{key} must be auto|off, got {v!r}")
    return v


def build_service(args, warmup: bool = True):
    """The model of the config with its checkpoint, as a LiftingService on
    ``gpu.device`` (warmed unless ``warmup=False``)."""
    import torch
    from pafuse_tpu_torch import checkpoints, serve
    from pafuse_tpu_torch.cli.main_h3wb import build_model
    from pafuse_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.gpu.device)
    shard = _mode(args, "shard")
    batching = _mode(args, "batching")
    devices = None
    if (shard == "auto" and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        n = torch.cuda.device_count()
        if int(args.gpu.mesh_shape[0]) not in (-1, n):
            raise ValueError(f"gpu.mesh_shape {list(args.gpu.mesh_shape)} "
                             f"does not match the {n} visible cards")
        devices = [f"cuda:{i}" for i in range(n)]
        print(f"[serve] one replica on each of {n} cards; window rows split "
              f"over them")

    model = build_model(args, device)
    state_dict = None
    chk = args.general.evaluate or args.general.resume
    if chk:
        chk_path = os.path.join(args.general.checkpoint, chk)
        if not os.path.exists(chk_path):
            chk_path = chk
        print(f"[serve] loading checkpoint {chk_path}")
        if chk_path.endswith(".bin"):
            state_dict = checkpoints.load_reference_bin(
                chk_path, [s.name for s in model.pose_estimator.specs])
        else:
            checkpoints.load_state(chk_path, model)
    else:
        print("[serve] WARNING: no checkpoint (general.evaluate unset) — "
              "serving untrained weights")

    buckets = args.serve.buckets
    if isinstance(buckets, str):
        buckets = [int(b) for b in buckets.split(",") if b.strip()]
    op_points = getattr(args.serve, "op_points", None)
    if isinstance(op_points, str):
        op_points = [t for t in op_points.split(",") if t.strip()]
    service = serve.LiftingService(
        model, state_dict, buckets=buckets,
        dynamic_batching=(batching == "auto"),
        max_frames=int(getattr(args.serve, "max_frames", 100_000)),
        noise_mode=str(getattr(args.serve, "noise", "host")).lower(),
        readback=str(getattr(args.serve, "readback", "all")).lower(),
        op_points=op_points or None, device=device, devices=devices)
    if warmup:
        secs = service.warmup()
        print(f"[serve] warm: buckets {service.buckets} x op points "
              f"{service.op_points} in {secs:.1f}s")
    return service


def main(argv=None):
    args = cfg_mod.parse_cli(argv if argv is not None else sys.argv[1:])
    from pafuse_tpu_torch import serve

    service = build_service(args)
    server = serve.make_http_server(service, host=args.serve.host,
                                    port=int(args.serve.port))
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port}  "
          f"(P={args.ft2d.num_proposals}, T={args.ft2d.sampling_timesteps}, "
          f"rf={service.receptive_field}, device={service.device})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
