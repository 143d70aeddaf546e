"""Sharding rules and collective accounting for the dry run (reference:
``repro/distributed``)."""
