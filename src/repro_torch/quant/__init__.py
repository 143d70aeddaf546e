"""BitGNN bit-packed linears for the LM models (reference:
``repro/quant``) and 1-bit gradient compression (``grad_compress``)."""
from . import binary_linear
