"""Model definitions: the paper's GNNs and the 10 assigned LM
architectures (reference: ``repro/models``)."""
from . import gnn, layers, moe, ssm, transformer
