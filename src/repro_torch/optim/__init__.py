"""Optimizers in PyTorch (reference: ``repro/optim``)."""
from .optimizer import AdamW, AdamWState, cosine_schedule, global_norm

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "global_norm"]
