"""Device ms a unit (an epoch or a pass) charged to the program's span
``model.spectral`` in the traced window (spans.py): LanczosNet's long
scales, the filter MLPs, ``Vᵀh``, the reconstruction ``V (f ⊙ Vᵀh)``
and its cast back, with their backward and remat's replay. Nothing
where the window holds no such span."""

from portbench import spans

SOURCE = "program_span"
LAYER = "spectral layers"
MOVES = {"train": "train_epoch_ms", "infer": "infer_pass_ms"}
SPAN = "model.spectral"


def read(ctx, kind):
    if ctx.kind != kind or ctx.events is None:
        return None
    if spans.span_calls(ctx.events, SPAN, ctx.t0, ctx.t1) == 0:
        return None
    return spans.window_charges(ctx)[SPAN] / 1e3 / ctx.units
