"""Seconds the runner's set-up takes to build the operator: the host sort
of ``ops/sparse.py:coo_arrays`` and the copy to the card
(``sparse_op_from_arrays``), as the runner's ``setup`` event times them
after a device sync."""

SOURCE = "program_span"
LAYER = "runner set-up"
MOVES = {"setup": "setup_s"}


def read(ctx, kind):
    return ctx.setup.get("operator_s")
