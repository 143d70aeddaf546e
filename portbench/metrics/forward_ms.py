"""The window's length over the full-graph forwards it completed (host
clock, each forward ending in ``torch.cuda.synchronize()``)."""


def read(ctx, spec):
    w = ctx.window
    return w["window_s"] / w["count"] * 1e3
