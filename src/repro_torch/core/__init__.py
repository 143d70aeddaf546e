"""Core BitGNN building blocks in PyTorch: bit ops, FRDC, BIN/BMM/BSpMM and
the two-level abstraction (reference: ``repro/core``)."""

__all__ = ["straight_through_sign"]


def __getattr__(name):
    # resolved on first use: binarize imports the kernels package, which
    # imports core modules, so an eager import here would close a cycle
    if name == "straight_through_sign":
        from .binarize import straight_through_sign
        return straight_through_sign
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
