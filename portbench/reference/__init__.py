"""Plain references of the configurations, and the comparison that
decides ``correct``.

Plain PyTorch only: nothing here imports ``jax``, the JAX package or
anything of ``repro_torch``, and nothing takes what the program made. A
reference works out again, from the benchmark's own edges, features and
float32 weights, everything the program derives: the adjacency and its
normalization, the weights' signs and scales, and the BN statistics.
"""
