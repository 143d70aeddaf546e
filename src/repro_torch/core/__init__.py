"""Core BitGNN building blocks in PyTorch: bit ops, FRDC, BIN/BMM/BSpMM and
the two-level abstraction (reference: ``repro/core``)."""
