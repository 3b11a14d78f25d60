"""The bytes that an epoch or a pass needs (counts/<family>.py: each
operand of each product read once, each result written once) over its
time on the host clock in the traced run, against the HBM peak
(peaks.py)."""

from portbench.peaks import HBM_BYTES_PER_S

SOURCE = "host_clock"
LAYER = "model step"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}


def read(ctx, kind):
    if ctx.kind != kind:
        return None
    return 100.0 * ctx.counts["bytes"] / ctx.unit_s / HBM_BYTES_PER_S
