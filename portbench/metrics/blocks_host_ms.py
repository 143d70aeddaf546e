"""Host ms a forward in the traced window's ``gnn.forward`` spans minus
the part their ``kernel.*`` spans cover: BN, BIN's sign, abs and mean, the
scales, the adds, cuBLAS and their Python (``portbench/spans.py``)."""
from portbench import spans


def read(ctx, spec):
    b = spans.blocks(ctx)
    if b is None:
        return None
    return spans.length_ns(b) / 1e6 / ctx.trace.forwards
