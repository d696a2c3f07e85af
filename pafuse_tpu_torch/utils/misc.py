"""Small host-side utilities; own copies of ``pafuse_tpu/utils/misc.py``'s
``deterministic_random``, ``Logger`` and ``Timer``."""

from __future__ import annotations

import hashlib
import os
import sys
import time


def deterministic_random(min_value: int, max_value: int, data: str) -> int:
    """A draw in [min_value, max_value) keyed by the SHA-256 of ``data``."""
    digest = hashlib.sha256(data.encode()).digest()
    raw_value = int.from_bytes(digest[:4], byteorder="little", signed=False)
    return int(raw_value / (2 ** 32 - 1) * (max_value - min_value)) + min_value


class Logger:
    """A stdout tee: writes go to ``stream`` (sys.stdout by default) and are
    appended to ``filename``; :meth:`close` closes the file."""

    def __init__(self, filename: str, stream=None):
        self.terminal = stream or sys.stdout
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self.log = open(filename, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


class Timer:
    """Wall-clock context timer; ``elapsed`` holds the seconds, printed
    after ``message`` when ``show``."""

    def __init__(self, message: str = "", show: bool = True):
        self.message = message
        self.show = show
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self.show:
            print(f"{self.message} {self.elapsed:.3f}s")
        return False
