"""Options of the JAX runners that the port does not run, and options a
runner does not read.

The three runners check a config against two tables before they build
anything. ``NOT_PORTED``: an option the port would ignore raises
``NotImplementedError``, naming the ROADMAP item that ports it; every
option is ported now, so it is empty. ``NOT_READ``: an option the JAX
runner itself never reads raises ``ValueError``, since ignoring it would
run another experiment than the config says (the dense citation runner
shards node rows only, so ``train.tp`` and ``train.shard`` mean nothing
to it; neither citation runner buckets, pairs or profiles).
``train.prng_impl`` is accepted: it picks JAX's random-bit generator and
has no torch counterpart.
"""

from __future__ import annotations

from typing import Mapping, Optional

# (section, key, refused when, the ROADMAP item that ports it)
NOT_PORTED: tuple = ()

_NODES_ONLY = "the dense citation runner shards node rows only (train.num_devices)"
_QM8_ONLY = "only the QM8 runner reads it (size buckets, paired steps, profiling)"
# (section, key, refused when, runner, why): what that runner's JAX
# counterpart never reads
NOT_READ = (
    ("train", "tp", lambda v: int(v) > 1, "CitationRunner", _NODES_ONLY),
    ("train", "shard", bool, "CitationRunner", _NODES_ONLY),
    ("train", "tp", lambda v: int(v) > 1, "SparseCitationRunner",
     "the sparse citation runner shards the graph only (train.shard)"),
    ("train", "shard", bool, "QM8Runner",
     "the QM8 runner shards batches and layers (train.num_devices, train.tp)"),
    *((section, key, bool, runner, _QM8_ONLY)
      for runner in ("CitationRunner", "SparseCitationRunner")
      for section, key in (("dataset", "buckets"), ("train", "bucket_pair"),
                           ("train", "profile"))),
)


def refuse_unported(config: Mapping, runner: Optional[str] = None) -> None:
    """Raise ``NotImplementedError`` for the first option of ``config``
    that ``NOT_PORTED`` refuses, ``ValueError`` for one that ``NOT_READ``
    names for ``runner`` (the config's own ``runner``, QM8Runner by
    default, where not named)."""
    runner = runner or config.get("runner", "QM8Runner")
    for section, key, refused, item in NOT_PORTED:
        value = (config.get(section) or {}).get(key)
        if value is not None and refused(value):
            raise NotImplementedError(
                f"{section}.{key}={value!r} is not ported yet for {runner} (ROADMAP {item})"
            )
    for section, key, refused, name, why in NOT_READ:
        value = (config.get(section) or {}).get(key)
        if value is not None and refused(value) and runner == name:
            raise ValueError(f"{section}.{key}={value!r}: {why}")
