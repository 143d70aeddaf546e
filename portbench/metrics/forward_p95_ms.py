"""The 95th percentile (nearest rank) of every forward of the window, each
from its call to the end of its synchronise (host clock)."""
import math


def read(ctx, spec):
    lat = sorted(ctx.window["latencies_s"])
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
