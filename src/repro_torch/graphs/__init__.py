"""Graph datasets (reference: ``repro/graphs``)."""
