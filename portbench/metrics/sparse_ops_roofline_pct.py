"""The sparse products' bytes (counts/<family>.py) over the device time of
the kernels that these ATen ops launched in the traced window, against
the HBM peak: the gathers and segment sums of ``ops/sparse.py``
(``edge_gather``, ``_segsum``, ``spmv`` and their backward).

Only while these ops carry every sparse product and nothing else: the
window's outermost calls of each must be the units times the calls that
``counts/<family>.py`` expects of a unit (``sparse_calls``). Where a
product has left them (a scatter moved to another op or kernel) or other
work has entered them, the time no longer matches the bytes, and the
metric is left out, the counts named on standard error.
"""

import sys

from portbench import traces
from portbench.peaks import HBM_BYTES_PER_S

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}
OPS = ("aten::index_select", "aten::index_add_", "aten::index_add")


def read(ctx, kind):
    if ctx.kind != kind or ctx.events is None:
        return None
    calls = traces.outermost_calls(ctx.events, OPS, ctx.t0, ctx.t1)
    want = {op: ctx.units * ctx.counts["sparse_calls"].get(op, 0) for op in OPS}
    if calls != want:
        print(f"sparse_ops_roofline_pct.{kind}: left out, calls in the window {calls}, "
              f"expected {want} ({ctx.units} units)", file=sys.stderr)
        return None
    us = traces.device_us_under_ops(ctx.events, OPS, ctx.t0, ctx.t1)
    if us <= 0.0:
        return None
    return 100.0 * ctx.counts["sparse_bytes"] * ctx.units / (us / 1e6) / HBM_BYTES_PER_S
