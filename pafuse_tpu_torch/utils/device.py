"""Device selection, synchronisation, transfers and chunked execution.

Counterpart of ``pafuse_tpu/utils/backend.py``.  Entry points default to
``"cuda"`` and take the CPU only when asked for it; asking for CUDA where
there is none raises instead of running on the CPU.

Transfers never wait for the device.  A ``.to("cuda")`` or ``.cpu()`` of a
tensor in pageable host memory synchronises the current stream, so the host
would wait for every kernel queued before it; :func:`to_device` and
:func:`to_host` instead stage through pinned memory and queue the copy on
the current stream behind the work that feeds it.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``) and pin
    float32 matmuls and convolutions to full float32 (TF32 off)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` (a NumPy array or a tensor) as a tensor on ``device``.  On CUDA a
    host array is copied into pinned memory and its copy to the card queued
    on the current stream, so the host does not wait for the device (the
    pinned block is not reused before the copy has run)."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
    t = torch.as_tensor(a, dtype=dtype)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A CUDA tensor's copy into pinned host memory, queued on the current
    stream right behind the work that makes the tensor, with an event
    recorded after it.  :meth:`numpy` waits on that event alone, so the
    copy of one chunk never waits for work queued after it."""

    def __init__(self, out: torch.Tensor):
        self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self._host.copy_(out, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(out.device))

    def ready(self) -> bool:
        """Whether the copy has completed (does not wait)."""
        return self.event.query()

    def numpy(self) -> np.ndarray:
        """Wait for the copy; the host array."""
        self.event.synchronize()
        return self._host.numpy()


class HostConcat:
    """The readbacks of consecutive row slices (on one device or several):
    :meth:`numpy` waits for each and concatenates them in order."""

    def __init__(self, handles):
        self.handles = handles

    def numpy(self) -> np.ndarray:
        return np.concatenate([h.numpy() for h in self.handles])


def to_host(out) -> Union[HostCopy, HostConcat, torch.Tensor]:
    """Start reading ``out`` back: a :class:`HostCopy` for a CUDA tensor, the
    tensor itself on the CPU, a :class:`HostConcat` for a list of row
    slices.  Each handle's ``numpy()`` gives the host array."""
    if isinstance(out, (list, tuple)):
        return HostConcat([to_host(o) for o in out])
    return HostCopy(out) if out.device.type == "cuda" else out


def run_chunked(fn: Callable[..., torch.Tensor], arrays: Sequence[np.ndarray],
                chunk: int) -> np.ndarray:
    """Apply ``fn`` to consecutive ``chunk``-row slices of ``arrays`` and
    concatenate the results on the host.

    Rows are independent, so the last chunk runs with however many rows it
    has.  Each chunk's readback is queued right after its work
    (:func:`to_host`); chunk i is read after chunk i+1 has been queued and
    waits for its own copy only, so the device runs chunk i+1 while the
    host takes chunk i and queues chunk i+2."""
    n = arrays[0].shape[0]
    if n == 0:
        raise ValueError("run_chunked: empty leading axis")
    outs, pending = [], None
    for start in range(0, n, chunk):
        out = to_host(fn(*[a[start:start + chunk] for a in arrays]))
        if pending is not None:
            outs.append(pending.numpy())
        pending = out
    outs.append(pending.numpy())
    return np.concatenate(outs, axis=0)
