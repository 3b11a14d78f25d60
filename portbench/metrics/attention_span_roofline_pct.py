"""The attention's bytes (``attention_bytes`` of counts/<family>.py: the
edge softmax and the per-head weighted sums, forward and backward) over
the device time charged to the program's span ``model.attention`` in the
traced window (spans.py), against the HBM peak.

Left out unless the window holds the units times the spans that the
counts expect of a unit (``attention_spans``: one a layer and forward,
the validation forward's too), the counts named on standard error; and
for a family without those counts.
"""

import sys

from pathlib import Path

from portbench import spans
from portbench.bench import load_file
from portbench.peaks import HBM_BYTES_PER_S

# the device time charged to the span, as attention_device_ms reads it
_device_ms = load_file(Path(__file__).with_name("attention_device_ms.py"),
                       "portbench_metric_attention_device_ms")

SOURCE = "program_span"
LAYER = "attention"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}
SPAN = "model.attention"


def read(ctx, kind):
    if ctx.kind != kind or ctx.events is None or "attention_spans" not in ctx.counts:
        return None
    calls = spans.span_calls(ctx.events, SPAN, ctx.t0, ctx.t1)
    want = ctx.units * ctx.counts["attention_spans"]
    if calls != want:
        print(f"attention_span_roofline_pct.{kind}: left out, {calls} {SPAN} spans in the "
              f"window, expected {want} ({ctx.units} units)", file=sys.stderr)
        return None
    us = _device_ms.charged_us(ctx)
    if us <= 0.0:
        return None
    return 100.0 * ctx.counts["attention_bytes"] * ctx.units / (us / 1e6) / HBM_BYTES_PER_S
