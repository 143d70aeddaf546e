"""Sharding rules and collective accounting for the dry run (reference:
``repro/distributed``), and the collectives of the sharded serving path
and the 1-bit all-reduce over ``torch.distributed`` (``collectives``)."""
