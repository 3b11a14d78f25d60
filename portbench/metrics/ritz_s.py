"""Seconds of the runner's Ritz pairs (``ops/sparse.py:sparse_lanczos_ritz``:
the recursion on the COO product and the eigensolve), the ``extras_s``
of its ``setup`` event; nothing for a model without them."""

SOURCE = "program_span"
LAYER = "spectral set-up"
MOVES = {"setup": "setup_s"}


def read(ctx, kind):
    return ctx.setup.get("extras_s") if ctx.spectral else None
