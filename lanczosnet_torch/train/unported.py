"""Options of the JAX runners that the port does not run yet.

Both runners check a config against one table before they build
anything, so an option the port would ignore raises instead, naming the
ROADMAP item that ports it. ``train.prng_impl`` is accepted: it picks
JAX's random-bit generator and has no torch counterpart.
"""

from __future__ import annotations

from typing import Mapping

# (section, key, refused when, the ROADMAP item that ports it)
NOT_PORTED = (
    ("dataset", "buckets", bool, "A12 (data/buckets.py)"),
    ("train", "bucket_pair", bool, "A12 (data/buckets.py)"),
    ("train", "tp", lambda v: int(v) > 1, "A11"),
    ("train", "num_devices", lambda v: int(v) > 1, "A11"),
    ("train", "shard", bool, "A11"),
    ("train", "profile", bool, "A12"),
    ("train", "tensorboard", bool, "A12"),
)


def refuse_unported(config: Mapping) -> None:
    """Raise ``NotImplementedError`` for the first option of ``config``
    that ``NOT_PORTED`` refuses."""
    for section, key, refused, item in NOT_PORTED:
        value = (config.get(section) or {}).get(key)
        if value is not None and refused(value):
            raise NotImplementedError(
                f"{section}.{key}={value!r} is not ported yet (ROADMAP {item})"
            )
