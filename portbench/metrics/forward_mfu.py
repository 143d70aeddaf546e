"""The whole forward's share of the card's peak, %: the forward's
operations from the cell's shapes (``counts/``), each kind at its own
peak rate (binary multiply-adds at the int8 rate, float work at float32),
over ``forward_ms`` of the untraced window."""
from portbench import counts


def read(ctx, spec):
    w = ctx.window
    return counts.peak_seconds(ctx.stages) / (w["window_s"] / w["count"]) * 100
