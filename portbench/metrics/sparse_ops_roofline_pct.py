"""The sparse products' bytes (counts/<family>.py) over the device time of
the port's CSR product kernels in the traced window, against the HBM
peak: ``spmm_csr_kernel`` (each product, forward or over the transposed
view in a backward) and ``spmm_sddmm_kernel`` (an edge-weight gradient),
launched by ``ops/sparse_cuda.py`` under ``ops/sparse.py:spmv``. The
ATen work around them (a backward's transposed view, the node gathers)
is not theirs and is not timed here; ``sparse_span_roofline_pct`` takes
it with the span.

Only while these kernels carry every sparse product and nothing else:
the window's launches of them must be the units times the launches that
``counts/<family>.py`` expects of a unit (``sparse_launches``). Where a
product has left them or other work has entered them, the time no longer
matches the bytes, and the metric is left out, the counts named on
standard error.
"""

import sys

from portbench import traces
from portbench.peaks import HBM_BYTES_PER_S

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}
KERNELS = ("spmm_csr_kernel", "spmm_sddmm_kernel")


def read(ctx, kind):
    if ctx.kind != kind or ctx.events is None:
        return None
    launches, us = traces.kernels_named(ctx.events, KERNELS, ctx.t0, ctx.t1)
    want = ctx.units * ctx.counts["sparse_launches"]
    if launches != want:
        print(f"sparse_ops_roofline_pct.{kind}: left out, {launches} launches of "
              f"{' or '.join(KERNELS)} in the window, expected {want} ({ctx.units} units)",
              file=sys.stderr)
        return None
    if us <= 0.0:
        return None
    return 100.0 * ctx.counts["sparse_bytes"] * ctx.units / (us / 1e6) / HBM_BYTES_PER_S
