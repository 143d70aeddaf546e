"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions,
device dispatch and launch counters (reference: ``repro/kernels``)."""
