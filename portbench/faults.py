"""Faults planted under the timed path, each a wrapper of the program's
forward: the comparison has to read each as not correct. A full-graph
inference forward holds no state and runs on one chip, so of the faults a
run can have these two apply."""
from __future__ import annotations

import random


def altered_answer(seed: int):
    """One node's logits negated where the forward produces them, so its
    answer is the class it rates least likely (the node drawn from
    ``seed``)."""
    def wrap(forward):
        def broken():
            out = forward().clone()
            i = random.Random(seed).randrange(out.shape[0])
            out[i] = -out[i]
            return out
        return broken
    return wrap


def half_left_out(seed: int):
    """The logits of the second half of the nodes never computed (0)."""
    def wrap(forward):
        def broken():
            out = forward().clone()
            out[out.shape[0] // 2:] = 0
            return out
        return broken
    return wrap


FAULTS = {"altered_answer": altered_answer, "half_left_out": half_left_out}
