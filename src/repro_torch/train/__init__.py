"""LM training: the train step and the fault-tolerant trainer (reference:
``repro/train``)."""
