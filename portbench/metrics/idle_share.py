"""One minus the union of the device operations' intervals over the
traced window, %."""


def read(ctx, spec):
    t = ctx.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100
