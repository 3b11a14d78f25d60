"""GiB of card memory at its peak over the runner's set-up (the operator,
the model, the Ritz pairs), as the runner's ``setup`` event reads
``max_memory_allocated`` after the sync that follows the Ritz pairs; the
counter was reset after the graph was drawn. Nothing where the event
lacks it."""

SOURCE = "program_span"
LAYER = "runner set-up"
MOVES = {"setup": "peak_mem_gib"}


def read(ctx, kind):
    mb = ctx.setup.get("peak_memory_mb")
    return None if mb is None else mb / 1024.0
