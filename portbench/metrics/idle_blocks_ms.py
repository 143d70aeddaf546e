"""Device-idle ms a forward while the host runs the blocks: the exact
overlap of the traced window's idle stretches (no device operation) with
``blocks_host_ms``'s host time (``portbench/spans.py``)."""
from portbench import spans


def read(ctx, spec):
    b = spans.blocks(ctx)
    if b is None:
        return None
    return spans.overlap_ns(b, spans.idle(ctx.trace)) / 1e6 / \
        ctx.trace.forwards
