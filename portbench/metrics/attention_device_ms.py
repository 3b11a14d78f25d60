"""Device ms a unit (an epoch or a pass) charged to the program's span
``model.attention`` in the traced window (spans.py's rule): GAT's edge
softmax and its per-head weighted sums (``spmm_csr_kernel`` a head), with
their backward (the kernel over the transposed view and
``spmm_sddmm_kernel`` a head, the softmax's gradient). Nothing where the
window holds no such span."""

from portbench import spans

SOURCE = "program_span"
LAYER = "attention"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}
SPAN = "model.attention"


def charged_us(ctx) -> float:
    """µs of the window's device work charged to ``SPAN``, worked out once a
    run (``attention_span_roofline_pct`` reads the same)."""
    got = getattr(ctx, "_attention_us", None)
    if got is None:
        got = spans.device_us_by_span(ctx.events, (SPAN,), ctx.t0, ctx.t1)[SPAN]
        ctx._attention_us = got
    return got


def read(ctx, kind):
    if ctx.kind != kind or ctx.events is None:
        return None
    if spans.span_calls(ctx.events, SPAN, ctx.t0, ctx.t1) == 0:
        return None
    return charged_us(ctx) / 1e3 / ctx.units
