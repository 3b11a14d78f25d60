"""The sparse products' bytes (counts/<family>.py) over the device time
charged to the program's span ``sparse.spmv`` in the traced window
(spans.py: the kernels launched inside the span, those of the backward
of its ops, and those of remat's replay of it), against the HBM peak.

The span carries a product whatever kernel does the work, so the metric
holds while the gathers and segment sums move between kernels. It is
left out unless the window holds the units times the forward products
that ``counts/<family>.py`` expects of a unit (its
``sparse_calls["aten::index_add"]``: one a forward product, remat's
replay and the validation forward included; the backward products are
charged to their forward's span), the counts named on standard error.
A program without the span reports nothing here.
"""

import sys

from portbench import spans
from portbench.peaks import HBM_BYTES_PER_S

SOURCE = "program_span"
LAYER = "sparse products"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}
SPAN = "sparse.spmv"


def read(ctx, kind):
    if ctx.kind != kind or ctx.events is None:
        return None
    calls = spans.span_calls(ctx.events, SPAN, ctx.t0, ctx.t1)
    want = ctx.units * ctx.counts["sparse_calls"].get("aten::index_add", 0)
    if calls != want:
        print(f"sparse_span_roofline_pct.{kind}: left out, {calls} {SPAN} spans in the window, "
              f"expected {want} ({ctx.units} units)", file=sys.stderr)
        return None
    us = spans.window_charges(ctx)[SPAN]
    if us <= 0.0:
        return None
    return 100.0 * ctx.counts["sparse_bytes"] * ctx.units / (us / 1e6) / HBM_BYTES_PER_S
