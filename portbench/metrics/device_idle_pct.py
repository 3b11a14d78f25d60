"""Share of the traced window in which no kernel, copy or memset ran on
the card (traces.py:busy_seconds)."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}


def read(ctx, kind):
    busy = ctx.busy_s() if ctx.kind == kind else None
    if not busy:
        return None
    span = (ctx.t1 - ctx.t0) / 1e6
    return 100.0 * (span - busy) / span
