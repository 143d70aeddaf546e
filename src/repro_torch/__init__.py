"""BitGNN binary GNN inference in PyTorch with hand-written CUDA kernels.

A port of the JAX package ``repro`` with the same module layout: each module
here has its reference at the same relative path under ``src/repro``. The
package imports neither JAX nor ``repro``. Entry points take a ``device``
that defaults to ``"cuda"``; pass ``device="cpu"`` to run the kernels' plain
PyTorch versions.
"""
