"""Small host-side utilities; own copy of ``pafuse_tpu/utils/misc.py``'s
``deterministic_random``."""

from __future__ import annotations

import hashlib


def deterministic_random(min_value: int, max_value: int, data: str) -> int:
    """A draw in [min_value, max_value) keyed by the SHA-256 of ``data``."""
    digest = hashlib.sha256(data.encode()).digest()
    raw_value = int.from_bytes(digest[:4], byteorder="little", signed=False)
    return int(raw_value / (2 ** 32 - 1) * (max_value - min_value)) + min_value
