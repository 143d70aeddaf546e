"""The SPMD layer executor and the halo ring of the port
(``repro_torch.serve.sharded``) in gloo worlds of 2 and 4 CPU processes.

Each module fixture starts one world with ``launch.mesh.run_ranks`` (one
process a shard, every rank running the same program); each rank runs the
contracts of ``tests/torch_spmd_ranks.py`` once and returns numpy results.
The tests hold them against the port's in-process host executor, which
``tests/test_torch_sharded.py`` holds against the reference, with the
reference's rules (``tests/test_spmd_executor.py``,
``tests/test_sharded_serve.py``):

* SPMD full logits bit-equal to the host executor's for GCN, SAGE and
  SAINT, unfused and fused, at P = 2 and 4, and on ragged shard cuts, on
  every rank, with one program a layer step and none new after a feature
  update;
* ``bn_mode="distributed"`` within 1e-5 of the host executor's, the same
  predictions;
* halo bytes from the static schedule, once per layer per pass;
* ``ShardedServeEngine(executor="spmd")`` answering like the host engine;
* ``mesh_exchange`` equal to the reference's ``gather_rows``, and a host
  executor session over the mesh equal to the loopback session;
* ``allreduce_1bit`` over two ranks equal to its plain version;
* ``run_ranks`` naming a failing rank with its traceback, and the SPMD
  executor refusing ranks that hold different plans.

P = 8 is left out: 8 processes on the 8 cores that 6 test workers share.
"""
import dataclasses

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

import torch_spmd_ranks as R  # noqa: E402
from repro.graphs.datasets import make_dataset as jmake  # noqa: E402
from repro.serve import sharded as jsh  # noqa: E402
tmesh = lazy("repro_torch.launch.mesh")

jax.config.update("jax_platform_name", "cpu")

TIMEOUT_S = 240


def _world(p):
    ranks = tmesh.run_ranks(R.contracts, p, p, backend="gloo",
                            device="cpu", timeout_s=TIMEOUT_S)
    assert [r["rank"] for r in ranks] == list(range(p))
    return ranks


@pytest.fixture(scope="module")
def world2():
    return _world(2)


@pytest.fixture(scope="module")
def world4():
    return _world(4)


@pytest.fixture
def worlds(world2, world4):
    return {2: world2, 4: world4}


@pytest.fixture(scope="module")
def data():
    return R.cora()


def _equal_bn(got, want):
    assert len(got) == len(want)
    for (gm, gs), (wm, ws) in zip(got, want):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("n_shards", (2, 4))
def test_spmd_bit_exact_vs_host(worlds, data, n_shards):
    """Every rank's SPMD full logits equal the host executor's bit for bit
    under the same single-host BN, unfused and on the fused plan, with one
    program a layer step."""
    ranks = worlds[n_shards]
    for fused in (False, True):
        st = R.make_store(data, use_pallas=fused, fused=fused)
        for fam in R.FAMILIES:
            key = f"{'fused' if fused else 'plain'}/{fam}"
            host = st.sharded_session("g", fam, n_shards)
            want = host.full_logits()
            for r in ranks:
                np.testing.assert_array_equal(r[f"logits/{key}"], want,
                                              err_msg=f"{key} rank "
                                                      f"{r['rank']}")
                _equal_bn(r[f"bn/{key}"], R._bn(host.bn))
                compiles, n_steps = r[f"compiles/{key}"]
                assert compiles == n_steps == len(host.program), key


@pytest.mark.parametrize("n_shards", (2, 4))
def test_spmd_bit_exact_ragged_rows(worlds, n_shards):
    """Shards of unequal row counts on a graph of 117 nodes: padded rows
    and columns never reach real ones."""
    st = R.make_store(R.ragged(), ("gcn", "sage"))
    for fam in ("gcn", "sage"):
        host = st.sharded_session("g", fam, n_shards)
        assert len({p.n_local for p in host.parts}) > 1, \
            "cuts should be ragged"
        for r in worlds[n_shards]:
            assert r[f"ragged_locals/{fam}"] == [p.n_local
                                                 for p in host.parts]
            np.testing.assert_array_equal(r[f"ragged/{fam}"],
                                          host.full_logits())


def test_spmd_zero_new_programs_after_update(world2, data):
    """A feature update re-runs the pass through the programs already
    counted, and answers as a host session built on the new features."""
    x2 = data.x.copy()
    x2[:10] = 0.5
    want = R.make_store(dataclasses.replace(data, x=x2), ("sage",)
                        ).sharded_session(
        "g", "sage", 2).full_logits()
    for r in world2:
        c0, c1, n_steps, inval = r["update/counts"]
        assert c0 == c1 == n_steps
        assert inval == 1
        np.testing.assert_array_equal(r["update/logits"], want)


def test_distributed_bn_spmd_matches_host(world2, data):
    """SPMD moments, all-gathered and added in shard order, agree with the
    host executor's summed partials within 1e-5 and serve the same
    predictions (the reference's rule), on every rank."""
    host = R.make_store(data, ("sage",)).sharded_session(
        "g", "sage", 2, bn_mode="distributed")
    want_bn, want = R._bn(host.bn), host.full_logits()
    for r in world2:
        for name in ("dbn/host", "dbn/spmd"):
            bn, logits = r[name]
            assert len(bn) == len(want_bn)
            for (gm, gs), (wm, ws) in zip(bn, want_bn):
                np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(np.argmax(logits, -1),
                                          np.argmax(want, -1))
        np.testing.assert_array_equal(r["dbn/host"][1], want)


def test_spmd_halo_bytes_static_schedule(world2):
    """Bytes of the static schedule once per layer per pass: a second pass
    doubles every tag and adds no program."""
    for r in world2:
        tags1, tags2, c1, c2, packed, fp = r["bytes"]
        assert tags1 == {"layer1/packed": packed, "layer2/fp": fp}
        assert packed > 0 and fp > 0
        assert tags2 == {t: 2 * b for t, b in tags1.items()}
        assert c1 == c2 == 2


def test_engine_spmd_executor(world2, data):
    """``ShardedServeEngine(executor="spmd")`` answers every query as the
    host-executor engine does on the same submissions, and its snapshot
    reports the executor and its programs."""
    eng = R.make_engine(R.make_store(data, ("gcn",)), 2)
    qs = eng.submit_many("g", "gcn", R.engine_nodes(data.n_nodes))
    eng.run_until_drained()
    want = np.stack([q.logits for q in qs])
    for r in world2:
        logits, executor, compiles, no_mesh = r["engine"]
        np.testing.assert_array_equal(logits, want)
        assert executor == "spmd" and compiles == 2 and no_mesh


def test_mesh_exchange_matches_reference_gather_rows(worlds):
    """The ring over gloo delivers exactly the rows the reference's host
    loopback assembles, fp and packed uint32 words, to every rank, at
    P = 2 and 4."""
    jdata = jmake("cora", seed=0, scale=0.1)
    for p, ranks in worlds.items():
        plan = jsh.ShardPlanner(p).plan(jdata, "gcn")
        for name, blocks in zip(("fp", "packed"), R.exchange_blocks(plan)):
            for r in ranks:
                got = r[f"exchange/{name}"]
                assert len(got) == p
                for part, g in zip(plan.parts, got):
                    want = jsh.gather_rows(blocks, plan.routing,
                                           part.halo_nodes)
                    assert g.dtype == want.dtype
                    np.testing.assert_array_equal(g, want)


def test_mesh_session_matches_host_session(worlds, data):
    """A host-executor session whose halo exchange runs over the mesh
    equals the loopback session bit for bit, full pass and routed serve."""
    for p, ranks in worlds.items():
        host = R.make_store(data, ("gcn",)).sharded_session("g", "gcn", p)
        want, served = host.full_logits(), host.serve_subgraph(
            np.arange(R.BATCH))
        for r in ranks:
            assert r["mesh/executor"] == ("HostLayerExecutor", True)
            np.testing.assert_array_equal(r["mesh/logits"], want)
            np.testing.assert_array_equal(r["mesh/serve"], served)


def test_allreduce_1bit_over_two_ranks(world2):
    """The mean of every rank's sign * mean|g|, equal on both ranks, equal
    to its plain version."""
    gs = [R.grad(r) for r in range(2)]
    want = np.mean(np.stack([np.where(g >= 0, 1.0, -1.0).astype(np.float32)
                             * np.abs(g).mean(dtype=np.float32)
                             for g in gs]), axis=0, dtype=np.float32)
    for r in world2:
        np.testing.assert_allclose(r["allreduce"], want, rtol=1e-5)
    np.testing.assert_array_equal(world2[0]["allreduce"],
                                  world2[1]["allreduce"])


def test_run_ranks_reports_the_failing_rank():
    """A rank that raises fails the world: the error names the rank and
    carries its traceback; no partial result comes back. Ranks that
    planned differently are refused when the SPMD executor is built."""
    with pytest.raises(RuntimeError, match="rank 1 of 2") as e:
        tmesh.run_ranks(R.fail_on_rank1, 2, backend="gloo", device="cpu",
                        timeout_s=TIMEOUT_S)
    assert "rank 1 was told to fail" in str(e.value)
    assert "Traceback" in str(e.value)
    with pytest.raises(RuntimeError, match="ranks \\[1\\] hold another "
                                           "SpmdPlan"):
        tmesh.run_ranks(R.mismatched_plans, 2, backend="gloo", device="cpu",
                        timeout_s=TIMEOUT_S)
