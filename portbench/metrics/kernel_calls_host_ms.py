"""Host ms a forward inside the calls into the port's own kernels: the
outermost ``kernel.*`` spans within the traced window's ``gnn.forward``
spans (the wrappers' checks, allocation and launch, or the plain
versions' work). Read from the port's spans (``portbench/spans.py``)."""
from portbench import spans


def read(ctx, spec):
    parts = spans.forward_parts(ctx)
    if parts is None:
        return None
    return spans.length_ns(parts[1]) / 1e6 / ctx.trace.forwards
