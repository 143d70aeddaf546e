"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in MB of 10^6 bytes."""


def read(ctx, spec):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e6
