"""The host's time from the call of a forward to its return, before the
synchronise, averaged over the untraced window of the traced run (host
clock; the profiler is off there, so it does not inflate the call)."""


def read(ctx, spec):
    e = ctx.window["enqueue_s"]
    return sum(e) / len(e) * 1e3
