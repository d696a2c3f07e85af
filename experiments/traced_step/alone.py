"""chip_smoke.py's profiled phases run alone, in a fresh process: the serve
phases (the 'all' service and the device-noise 'modes' service, as
chip_smoke.py builds them) with one 405-frame request of each profiled,
then the H3WB trainer at depth 2 with its profiled step
(chip_smoke.train_phase).  For each profiled request: the host's launch
calls, those without a kernel in the profile (paired by the kineto events'
correlation ids, with their thread and their start in ms from the
profile's first event) and what chip_smoke.traced reports dropped.  Run
from the root of a checkout on the card:

    python3 experiments/traced_step/alone.py
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from pafuse_tpu_torch.ops import _build  # noqa: E402
from pafuse_tpu_torch.utils.device import resolve_device  # noqa: E402


def unpaired(run, label):
    """The launch calls of one profiled ``run()`` without a kernel."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    t0 = min(e.start_ns() for e in events)
    calls, kernels = {}, set()
    for e in events:
        if "CPU" in str(e.device_type()) and e.name() in chip_smoke.LAUNCH_CALLS:
            calls[e.correlation_id()] = (e.name(), (e.start_ns() - t0) / 1e6,
                                         e.start_thread_id())
        elif "CUDA" in str(e.device_type()):
            kernels.add(e.correlation_id())
    missing = [v for k, v in calls.items() if k not in kernels]
    print(json.dumps({"request": label, "launch_calls": len(calls),
                      "without_kernel": missing[:30],
                      "traced_dropped": chip_smoke.traced(run)[1]}), flush=True)


def main():
    resolve_device("cuda")
    _build.build_all()
    _, svc, kp27, poses27 = chip_smoke.serve_phase(0)
    _, modes = chip_smoke.serve_modes_phase(svc, kp27, poses27, 0)
    kp = chip_smoke._kp(np.random.RandomState(5), 405)
    for label, service in (("host noise, readback all", svc),
                           ("device noise, readback mean", modes)):
        unpaired(lambda: service.lift(kp, seed=0), label)
    svc.close()
    modes.close()
    chip_smoke.train_phase(0, "cuda", depth=2)


if __name__ == "__main__":
    main()
