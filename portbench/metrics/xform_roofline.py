"""The transform stage's least time (``counts/``: the larger of its
operations over peak and its bytes over the memory bandwidth, op by op)
over the device time of the kernels that ``xform_roofline.json`` names for
that stage, %, a forward."""
from portbench import counts
from portbench.metrics import stage_device_s


def read(ctx, spec):
    if ctx.trace is None:
        return None
    spent = stage_device_s(ctx.trace, spec["kernels"])
    if spent <= 0:
        return None
    return counts.stage_least_seconds(ctx.stages[spec["stage"]]) / spent * 100
