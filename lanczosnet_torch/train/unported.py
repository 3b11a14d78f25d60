"""Options of the JAX runners that the port does not run yet.

The three runners check a config against one table before they build
anything, so an option the port would ignore raises instead, naming the
ROADMAP item that ports it. ``train.prng_impl`` is accepted: it picks
JAX's random-bit generator and has no torch counterpart. Sharding is
ported for ``SparseCitationRunner`` (``train.num_devices`` > 1,
``train.shard``; A11) and for ``QM8Runner`` (``train.num_devices`` > 1,
``train.tp`` > 1; the first half of A11b); the dense citation runner's
node-sharding is the rest of A11b.
"""

from __future__ import annotations

from typing import Mapping, Optional

# (section, key, refused when, the ROADMAP item that ports it, runners that run it)
NOT_PORTED = (
    ("dataset", "buckets", bool, "A12 (data/buckets.py)", ()),
    ("train", "bucket_pair", bool, "A12 (data/buckets.py)", ()),
    ("train", "tp", lambda v: int(v) > 1, "A11b", ("QM8Runner",)),
    ("train", "num_devices", lambda v: int(v) > 1, "A11b",
     ("SparseCitationRunner", "QM8Runner")),
    ("train", "shard", bool, "A11b", ("SparseCitationRunner",)),
    ("train", "profile", bool, "A12", ()),
    ("train", "tensorboard", bool, "A12", ()),
)


def refuse_unported(config: Mapping, runner: Optional[str] = None) -> None:
    """Raise ``NotImplementedError`` for the first option of ``config``
    that ``NOT_PORTED`` refuses for ``runner`` (the config's own
    ``runner``, QM8Runner by default, where not named)."""
    runner = runner or config.get("runner", "QM8Runner")
    for section, key, refused, item, runs in NOT_PORTED:
        value = (config.get(section) or {}).get(key)
        if value is not None and refused(value) and runner not in runs:
            raise NotImplementedError(
                f"{section}.{key}={value!r} is not ported yet for {runner} (ROADMAP {item})"
            )
