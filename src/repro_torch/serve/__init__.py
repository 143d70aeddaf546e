"""Single-host GNN serving (reference: ``repro/serve``): a
:class:`GraphStore` builds a :class:`CompiledGraphSession` per (graph,
model) under a :class:`SessionPlan`."""
from .gnn_session import CompiledGraphSession, GraphStore
from .session_core import SessionPlan

__all__ = ["CompiledGraphSession", "GraphStore", "SessionPlan"]
