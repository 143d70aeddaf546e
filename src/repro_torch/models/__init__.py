"""GNN models (reference: ``repro/models``)."""
