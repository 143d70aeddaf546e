"""Command-line launchers (reference: ``repro/launch``):
``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.serve``."""
