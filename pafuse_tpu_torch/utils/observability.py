"""Observability: the TensorBoard writer, a profiler trace and a throughput
harness.

Counterpart of ``pafuse_tpu/utils/observability.py``.  The writer is
``tensorboardX`` where it is installed (as in the JAX package), else
PyTorch's own ``torch.utils.tensorboard`` (which needs the ``tensorboard``
package); both are imported when a writer is made, never with this
module.  The trace is ``torch.profiler``'s, written as a Chrome trace
(viewable in Perfetto or ``chrome://tracing``).  MLflow is not ported
(``mlflow`` is not installed): ``mlflow.mlflow_on=true`` raises in the
CLIs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict


def make_summary_writer(logdir: str):
    """A TensorBoard ``SummaryWriter`` on ``logdir`` (tensorboardX, else
    ``torch.utils.tensorboard``), or None when neither is installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(logdir)


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """``torch.profiler`` over the block (the CPU, and the card when
    ``device`` is CUDA); on exit the trace is written to
    ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def measure_throughput(fn: Callable, *args, iters: int = 5, warmup: int = 1,
                       items_per_call: int = 1, device=None,
                       **kwargs) -> Dict[str, float]:
    """Wall-clock throughput of ``fn(*args, **kwargs)``; every iteration
    ends in a synchronisation of ``device`` (a no-op on the CPU), so the
    clock covers the device's work and not only its launch."""
    import torch
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device(device) if device is not None else torch.device("cpu")
    for _ in range(warmup):
        fn(*args, **kwargs)
        sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
        sync(dev)
    dt = time.perf_counter() - t0
    return {"seconds_per_call": dt / iters,
            "items_per_second": items_per_call * iters / dt}
