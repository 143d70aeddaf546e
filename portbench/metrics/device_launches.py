"""Device operations (kernels, memsets and copies) a forward in the traced
window."""


def read(ctx, spec):
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    return len(t.device_ops) / t.forwards
