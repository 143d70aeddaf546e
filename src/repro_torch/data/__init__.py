"""Token data pipeline (reference: ``repro/data``)."""
from .pipeline import PrefetchLoader, SyntheticLM

__all__ = ["PrefetchLoader", "SyntheticLM"]
