"""Every error path of the port's rank launcher, ``launch.mesh.run_ranks``.

A rank that fails takes the collectives of the others down with it, and
which of them exits first is a race. So the launcher waits, after the
first non-zero exit, until the world is down or ``GRACE_S`` has passed,
and names the rank whose error was stamped first. The tests drive that
choice (``_raise_first``) and the wait around it (``_gather``) with
stand-in processes on a clock and result files they write themselves, so
the race is pinned without depending on timing; one spawned gloo world
keeps the real path covered.
"""
import os
import pickle
import threading
import time

import pytest

from torch_lazy import lazy, require_torch

require_torch()

import torch_spmd_ranks as R  # noqa: E402

tmesh = lazy("repro_torch.launch.mesh")

SHORT_GRACE_S = 0.5     # the grace of the tests that wait it out
NEVER = None


class Rank:
    """A stand-in for a rank's process: alive until ``exit_at`` seconds
    from now (for ever when ``NEVER``), then exited with ``code``. Its
    result ``out`` (None: no file) lands in ``root``, written whole as a
    rank writes it, just before it exits, or at ``write_at`` seconds."""

    def __init__(self, root, r, exit_at, code, out=None, write_at=None):
        self.code = code
        self.exited = threading.Event()
        self.timers = []

        def exit_():
            if out is not None and write_at is None:
                write_rank(root, r, out)
            self.exited.set()
        if out is not None and write_at is not None:
            self._after(write_at, write_rank, root, r, out)
        if exit_at is not NEVER:
            self._after(exit_at, exit_)

    def _after(self, delay, fn, *args):
        if delay == 0.0:
            fn(*args)
        else:
            self.timers.append(threading.Timer(delay, fn, args))
            self.timers[-1].start()

    def is_alive(self):
        return not self.exited.is_set()

    @property
    def exitcode(self):
        return self.code if self.exited.is_set() else None


def write_rank(root, r, out):
    tmp = os.path.join(root, f"rank{r}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(root, f"rank{r}.pkl"))


def error(r, stamp):
    return ("error", f"Traceback: rank {r}'s own error\n", stamp)


@pytest.fixture(scope="module", autouse=True)
def launcher():
    """Import torch and the launcher (about a second) before any test
    starts its stand-in ranks' clocks."""
    assert callable(tmesh.run_ranks)


@pytest.fixture
def world(tmp_path):
    """``world(*specs)``: stand-in ranks over ``tmp_path``, each spec
    ``(exit_at, code, out[, write_at])``; their timers end with the
    test."""
    made = []

    def make(*specs):
        ranks = [Rank(str(tmp_path), r, *spec)
                 for r, spec in enumerate(specs)]
        made.extend(ranks)
        return ranks
    yield make
    for rank in made:
        for timer in rank.timers:
            timer.cancel()


def late_first_world(world):
    """Rank 0 is down first with the later stamp; rank 1 goes down 0.3 s
    later, within the grace, with the earlier one (rank 1 raised, and
    rank 0 failed in the collective that rank 1's exit broke)."""
    now = time.time()
    return world((0.0, 1, error(0, now)), (0.3, 1, error(1, now - 0.02)))


def test_raise_first_names_the_earliest_stamp_not_the_first_exit(
        world, tmp_path):
    """The choice waits for rank 1 to go down and names it by its stamp
    (the parent's choice, among the ranks already down, named rank 0)."""
    procs = late_first_world(world)
    with pytest.raises(RuntimeError) as err:
        tmesh._raise_first(procs, str(tmp_path))
    msg = str(err.value)
    assert msg.startswith("rank 1 of 2 failed (exit code 1); ranks [0] "
                          "failed after it:\n")
    assert "rank 1's own error" in msg and "rank 0's own" not in msg


def test_gather_waits_the_grace_for_the_first_failure(world, tmp_path):
    """The same world through the poll loop: it leaves at rank 0's exit,
    and the error still names rank 1, well inside the grace."""
    procs = late_first_world(world)
    t = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"^rank 1 of 2 failed \(exit code 1\); "
                             r"ranks \[0\] failed after it"):
        tmesh._gather(procs, str(tmp_path), timeout_s=60.0)
    assert time.monotonic() - t < tmesh.GRACE_S


def test_a_rank_that_wrote_its_error_but_runs_on_is_chosen_by_stamp(
        world, tmp_path, monkeypatch):
    """Rank 1 wrote the earliest error but has not exited when the grace
    ends: it is named all the same, as still running."""
    monkeypatch.setattr("repro_torch.launch.mesh.GRACE_S", SHORT_GRACE_S)
    now = time.time()
    procs = world((0.0, 1, error(0, now)),
                  (NEVER, None, error(1, now - 0.02), 0.0))
    with pytest.raises(RuntimeError) as err:
        tmesh._raise_first(procs, str(tmp_path))
    assert str(err.value).startswith(
        "rank 1 of 2 failed (still running); ranks [0] failed after it:\n")


@pytest.mark.parametrize("rank1", ["ok", "stamped"])
def test_a_rank_down_without_a_result_is_named_by_its_exit_code(
        world, tmp_path, rank1):
    """Rank 0 is killed (exit code -9) and writes nothing. It is named
    with its exit code and no traceback when no rank stamped an error;
    a stamped error of rank 1's comes before it."""
    spec = (0.1, 0, ("ok", 1)) if rank1 == "ok" \
        else (0.1, 1, error(1, time.time()))
    procs = world((0.0, -9, None), spec)
    with pytest.raises(RuntimeError) as err:
        tmesh._gather(procs, str(tmp_path), timeout_s=60.0)
    if rank1 == "ok":
        assert str(err.value) == "rank 0 of 2 failed (exit code -9)"
    else:
        assert str(err.value).startswith(
            "rank 1 of 2 failed (exit code 1); ranks [0] failed after it:\n")


def test_the_grace_is_bounded(world, tmp_path, monkeypatch):
    """A rank that never exits and writes nothing holds the choice no
    longer than the grace, and is not counted as failed."""
    monkeypatch.setattr("repro_torch.launch.mesh.GRACE_S", SHORT_GRACE_S)
    procs = world((0.0, 1, error(0, time.time())), (NEVER, None, None))
    t = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        tmesh._raise_first(procs, str(tmp_path))
    waited = time.monotonic() - t
    assert SHORT_GRACE_S <= waited < SHORT_GRACE_S + 1.0
    assert str(err.value).startswith("rank 0 of 2 failed (exit code 1):\n")


def test_success_returns_in_rank_order_without_a_grace_wait(world,
                                                            tmp_path):
    procs = world((0.2, 0, ("ok", "a")), (0.0, 0, ("ok", "b")),
                  (0.1, 0, ("ok", "c")))
    t = time.monotonic()
    assert tmesh._gather(procs, str(tmp_path), timeout_s=60.0) \
        == ["a", "b", "c"]
    assert time.monotonic() - t < 1.0 < tmesh.GRACE_S


def test_a_rank_past_the_timeout_raises_timeout_error(world, tmp_path):
    procs = world((0.0, 0, ("ok", 0)), (NEVER, None, None))
    with pytest.raises(TimeoutError,
                       match=r"^ranks \[1\] of 2 still running after 0.3 s$"):
        tmesh._gather(procs, str(tmp_path), timeout_s=0.3)


def test_a_rank_that_exits_0_without_a_result_is_refused(world, tmp_path):
    procs = world((0.0, 0, ("ok", 0)), (0.0, 0, None))
    with pytest.raises(RuntimeError,
                       match=r"^ranks \[1\] of 2 exited without a result$"):
        tmesh._gather(procs, str(tmp_path), timeout_s=60.0)


def test_spawned_world_names_rank_0_while_rank_1_runs_on():
    """Two gloo ranks: rank 0 raises, rank 1 sleeps outside any
    collective. The error names rank 0 once the grace has passed, and
    rank 1 is killed rather than waited for."""
    t = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        tmesh.run_ranks(R.fail_on_rank0, 2, backend="gloo", device="cpu",
                        timeout_s=240)
    msg = str(err.value)
    assert msg.startswith("rank 0 of 2 failed (exit code 1):\nTraceback")
    assert "rank 0 was told to fail" in msg
    assert time.monotonic() - t < 60.0
