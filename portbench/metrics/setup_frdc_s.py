"""Seconds of set-up in the FRDC builds: the outermost ``frdc.from_coo``
spans that end before the traced window opens (``portbench/spans.py``).
Its share of ``setup_s`` is the share of set-up that building the
adjacencies on the host takes."""
from portbench import spans


def read(ctx, spec):
    recorded = spans.recorded(ctx)
    if recorded is None:
        return None
    builds = [s for s in spans.outermost(
        recorded, lambda s: s.name == spans.FRDC_BUILD)
        if s.end_ns <= ctx.trace.start_ns]
    if not builds:
        return None
    return sum(s.end_ns - s.start_ns for s in builds) / 1e9
