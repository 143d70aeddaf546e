"""BitGNN bit-packed linears for the LM models (reference:
``repro/quant``; ``grad_compress`` comes with training, Slice F)."""
from . import binary_linear
