"""Device ms a forward of the operations that are neither the port's own
CUDA kernels nor cuBLAS: BN, the scales, abs and mean, the adds, as torch
ops. ``blocks_device_ms.json`` lists, under ``exclude``, the names of the
operations that are not counted."""
from portbench.metrics import matches


def read(ctx, spec):
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    total = sum(e - s for name, s, e in t.device_ops
                if not matches(name, spec["exclude"]))
    return total / 1e6 / t.forwards
