"""The FLOPs that an epoch or a pass needs (counts/<family>.py) over its
time on the host clock in the traced run, against the bfloat16 peak
(peaks.py)."""

from portbench.peaks import BF16_FLOPS_PER_S

SOURCE = "host_clock"
LAYER = "model step"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}


def read(ctx, kind):
    if ctx.kind != kind:
        return None
    return 100.0 * ctx.counts["flops"] / ctx.unit_s / BF16_FLOPS_PER_S
