"""The LM mesh paths of the port in gloo worlds of 2 and 4 CPU processes:
the expert-parallel MoE (``models.moe._moe_shard_map``, ``moe_groups=-1``),
``Trainer(shardings=)`` with a world's checkpoint, and the global dispatch
that ``moe_groups=-1`` falls back to without a mesh.

Each module fixture starts one world with ``launch.mesh.run_ranks`` (one
process a rank, every rank running the same program); each rank runs the
contracts of ``tests/torch_mesh_ranks.py`` once and returns numpy. The
tests hold them against:

* the reference's ``moe_block`` with ``moe_groups`` = the data size (0
  where it is 1; the reference's ``_moe_shard_map`` agrees with that
  grouped form, the same per-data-shard routing and capacity with the
  expert sums split over ``model``), within 1e-5 in fp32, with tokens
  dropping (``capacity_factor=1.0``), at (1, 2), (2, 1), (2, 2) and at
  (1, 4) with 6 experts padded to 8; one all-reduce a layer;
* the port's one-process grouped form for the loss and the gradients,
  each rank's expert slice within 1e-5 of the leaf's max |g|;
* the port's one-process ``Trainer``, which
  ``tests/test_torch_lm_trainer.py`` holds against the reference's: the
  losses after an injected failure and a restore under FSDP placements
  over (2, 1), and under expert-parallel placements over (1, 2), within
  1e-5 relative, equal on every rank, each leaf's placements unchanged by
  every step;
* the reference's checkpoint layout: one writer, the reference's keys,
  and a world's checkpoint restored in one process by both packages.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro.checkpoint import checkpointer as jck  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jred  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
tmesh = lazy("repro_torch.launch.mesh")
tmoe = lazy("repro_torch.models.moe")
tck = lazy("repro_torch.checkpoint.checkpointer")
ttr = lazy("repro_torch.train.trainer")
tconf = lazy("repro_torch.configs")

jax.config.update("jax_platform_name", "cpu")

TIMEOUT_S = 300
TOL = 1e-5
# (world, mesh shape (data, model), expert count, padded)
EP_CASES = {"(1, 2)": (2, (1, 2), 0), "(2, 1)": (2, (2, 1), 0),
            "(2, 2)": (4, (2, 2), 0), "padded": (4, (1, 4), 6)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    ranks = tmesh.run_ranks(R.world2, 2, str(root), backend="gloo",
                            device="cpu", timeout_s=TIMEOUT_S)
    assert [r["rank"] for r in ranks] == [0, 1]
    return ranks, root


@pytest.fixture(scope="module")
def world4():
    ranks = tmesh.run_ranks(R.world4, 4, backend="gloo", device="cpu",
                            timeout_s=TIMEOUT_S)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    return ranks


@pytest.fixture
def worlds(world2, world4):
    return {2: world2[0], 4: world4}


def _case(name):
    world, (data, model), experts = EP_CASES[name]
    key = "ep/padded" if name == "padded" else f"ep/{(data, model)}"
    return world, data, model, experts, key


def _torch_cfgs():
    return tconf.get_config, tconf.reduced_config


def test_moe_groups_minus_one_without_mesh_is_global():
    """The repair: on plain tensors ``moe_groups=-1`` is the global
    dispatch (``moe_groups=0``) bit for bit in the port, as in the
    reference (no mesh with a ``model`` axis in context)."""
    for experts in (0, 6):
        cfg_j = R.moe_cfg((jget, jred), -1, experts=experts)
        cfg_t = R.moe_cfg(_torch_cfgs(), -1, experts=experts)
        p, x, _ = R.moe_inputs(cfg_t)
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        got = tmoe.moe_block(pt, torch.from_numpy(x), cfg_t)
        glob = tmoe.moe_block(pt, torch.from_numpy(x),
                              dataclasses.replace(cfg_t, moe_groups=0))
        assert torch.equal(got, glob)
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        want = jmoe.moe_block(pj, jnp.asarray(x), cfg_j)
        np.testing.assert_array_equal(
            np.asarray(want), np.asarray(jmoe.moe_block(
                pj, jnp.asarray(x), dataclasses.replace(cfg_j,
                                                        moe_groups=0))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_moe_matches_reference_grouped(name, worlds):
    """Every rank's gathered output equals the reference's grouped
    dispatch at ``moe_groups`` = data within 1e-5; the forward runs one
    all-reduce (the layer's sum over ``model``; none where ``model`` is
    one rank, which has nothing to add); each rank holds only its
    experts."""
    world, data, model, experts, key = _case(name)
    cfg_j = R.moe_cfg((jget, jred), data if data > 1 else 0, tp=model,
                      experts=experts)
    p, x, _ = R.moe_inputs(cfg_j)
    want = np.asarray(jmoe.moe_block({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x), cfg_j))
    e = cfg_j.moe_experts_padded or cfg_j.moe_experts
    for rank in worlds[world]:
        got = rank[key]
        np.testing.assert_allclose(got["out"], want, rtol=TOL, atol=TOL)
        assert got["all_reduces"] == (model > 1), (name,
                                                   got["all_reduces"])
        assert got["wi"].shape[0] == e // model
        assert got["param_placements"]["wi"][-1] == (
            "S(0)" if model > 1 else "R")


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_moe_gradients_match_one_process(name, worlds):
    """The loss ``sum(out * r)`` within 1e-5 relative of the port's
    one-process grouped form; each rank's local ``wi`` / ``wo`` gradient
    equal to its experts' slice of the one-process gradient, and the
    gathered router gradient equal to it, within 1e-5 of the leaf's max
    |g|; gradients come back in their parameters' placements."""
    world, data, model, experts, key = _case(name)
    cfg = R.moe_cfg(_torch_cfgs(), data if data > 1 else 0, tp=model,
                    experts=experts)
    p, x, r = R.moe_inputs(cfg)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    loss = (tmoe.moe_block(pt, torch.from_numpy(x), cfg)
            * torch.from_numpy(r)).sum()
    loss.backward()
    e_loc = (cfg.moe_experts_padded or cfg.moe_experts) // model
    for rank, got in enumerate(worlds[world]):
        got = got[key]
        assert got["loss"] == pytest.approx(float(loss.detach()), rel=TOL)
        m = rank % model
        for w in ("wi", "wo"):
            full = pt[w].grad.numpy()
            np.testing.assert_allclose(
                got[w], full[m * e_loc:(m + 1) * e_loc], rtol=0,
                atol=TOL * np.abs(full).max())
        g = pt["router"].grad.numpy()
        np.testing.assert_allclose(got["router"], g, rtol=0,
                                   atol=TOL * np.abs(g).max())
        assert got["grad_placements"] == got["param_placements"]


def _one_process(arch, tmp_path, total, every, fail_at, moe_groups=0):
    """The port's one-process Trainer run the world runs, restarted after
    the same failure."""
    failer = ttr.FailureInjector(fail_at)
    made = []

    def make():
        made.append(R.make_trainer(arch, str(tmp_path), failer, total, every,
                                   moe_groups=moe_groups))
        return made[-1]
    try:
        return ttr.run_with_restarts(make)
    finally:
        for t in made:
            t.loader.close()


@pytest.mark.parametrize("run", ["fsdp", "moe"])
def test_trainer_under_shardings_resumes_like_one_process(run, world2,
                                                          tmp_path):
    """``run_with_restarts`` in a world of 2: smollm-135m (reduced) with a
    failure at step 3 restored under FSDP placements over (2, 1), and
    qwen2-moe-a2.7b (reduced, ``moe_groups=-1``) with a failure at step
    2 restored expert-parallel over (1, 2). The losses after the restart
    within 1e-5 relative of the one-process Trainer's, equal on both
    ranks; one restart."""
    args = {"fsdp": ("smollm-135m", 6, 3, 3, 0),
            "moe": ("qwen2-moe-a2.7b", 4, 2, 2, -1)}[run]
    arch, total, every, fail_at, groups = args
    want = _one_process(arch, tmp_path, total, every, fail_at, groups)
    ranks = [r[f"train/{run}"] for r in world2[0]]
    for got in ranks:
        assert got["restarts"] == 1 == want["restarts"]
        assert got["steps"] == want["steps"] == total - fail_at
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert got["losses"] == ranks[0]["losses"]
        assert got["torch_threads"] == 1


@pytest.mark.parametrize("run", ["fsdp", "moe"])
def test_trainer_keeps_placements_every_step(run, world2):
    """Every step leaves each leaf of the parameters and the optimizer
    state in the placements it came in with: the fresh start's plain
    tensors, then, after the restore, the placements of ``shardings``
    (FSDP: the q projection sharded on its input dim over data)."""
    for got in (r[f"train/{run}"] for r in world2[0]):
        fail_at = {"fsdp": 3, "moe": 2}[run]
        total = {"fsdp": 6, "moe": 4}[run]
        kept = [ok for ok, _ in got["checks"]]
        meshed = [m for _, m in got["checks"]]
        assert all(kept) and len(kept) == total
        assert meshed == [False] * fail_at + [True] * (total - fail_at)
        assert got["wq_placements"] == (
            ["S(0)", "R"] if run == "fsdp" else ["R", "S(1)"])


def test_compressed_step_under_fsdp_matches_one_process(world2):
    """``compress_grads=True`` on FSDP placements over (2, 1): 1-bit
    compression runs on the gradients in their parameters' placements;
    two steps' losses within 1e-5 relative of the one-process compressed
    steps, every leaf (the error state too) in its placements after each
    step, and the error state within 1e-5 of its one-process value where
    the compressed sign agrees (a sign taken of a sum near 0 may flip)."""
    want = R.compressed_steps(0)
    for got in (r["compress/fsdp"] for r in world2[0]):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert got["kept"] and got["err_placements"] == ["S(0)", "R"]
        near = [np.isclose(a, b, rtol=TOL, atol=TOL).mean()
                for a, b in zip(got["err"], want["err"])]
        assert min(near) > 0.999, min(near)


def _like(arch):
    """The trainer's initial state: the structure a restore takes."""
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW
    cfg = tconf.reduced_config(tconf.get_config(arch)).resolve_for_mesh(tp=1)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    return params, AdamW(lr=3e-3).init(params), ()


def test_world_checkpoint_written_once_and_restores(world2):
    """Rank 0 alone writes each checkpoint (its npz files are every save
    of the run), with the reference's keys for the same state; the final
    checkpoint restores in one process, in the port and in the
    reference, to the arrays the ranks gathered for it, bit for bit."""
    ranks, root = world2
    got0, got1 = (r["train/fsdp"] for r in ranks)
    assert got1["writes"] == []
    # step 3's save, the failure at step 3, then step 6's save and the
    # final blocking one
    assert got0["writes"] == [f"step_{s:08d}/shard_0.npz"
                              for s in (3, 6, 6)]
    ckpt_dir = Path(root) / "fsdp"
    manifest = json.loads((ckpt_dir / "step_00000006" / "manifest.json")
                          .read_text())
    like = _like("smollm-135m")
    like_np = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                           (like[0], jopt.AdamWState(*like[1]), ()))
    assert manifest["keys"] == jck._flatten(like_np)[0]
    restored = tck._flatten(tck.Checkpointer(ckpt_dir).restore(6, like))[1]
    ref = jck._flatten(jck.Checkpointer(ckpt_dir).restore(6, like_np))[1]
    assert len(restored) == len(ref) == len(got0["final"])
    for a, b, c in zip(restored, ref, got0["final"]):
        np.testing.assert_array_equal(np.asarray(a), c)
        np.testing.assert_array_equal(np.asarray(b), c)
    for a, b in zip(got0["final"], got1["final"]):
        np.testing.assert_array_equal(a, b)


def test_loader_miss_on_one_rank_does_not_split_batches(world2):
    """Rank 1's loader serves a stand-in batch at one step and counts a
    miss; rank 0's batch and miss count are broadcast, so both ranks
    step on the same batches (equal losses, equal to the one-process
    run's in the test above) and report rank 0's count."""
    got0, got1 = (r["train/fsdp"] for r in world2[0])
    assert got0["losses"] == got1["losses"]
    assert got0["misses"] == got1["misses"] == 0


def test_rank_failure_inside_trainer_fails_the_world(tmp_path):
    """A rank that raises inside ``Trainer.run`` (not an injected
    failure) takes the world down, and the error names it."""
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed") as err:
        tmesh.run_ranks(R.fail_in_trainer, 2, str(tmp_path), backend="gloo",
                        device="cpu", timeout_s=TIMEOUT_S)
    assert "rank 1's data source is gone" in str(err.value)


def test_a3_dry_run_cell_traces(monkeypatch):
    """``run_cell(..., cfg_overrides={"moe_groups": -1})`` traces the
    expert-parallel body on a fake 2 x 2 mesh (reduced qwen2-moe-a2.7b,
    train_4k cut to 8 x 64): the body runs on local shards, so it needs no
    DTensor rule for the dispatch scatter; each MoE layer's all-reduce
    shows among the collectives, and no group stays open."""
    import contextlib
    import math
    tdry = lazy("repro_torch.launch.dryrun")
    dist = lazy("torch.distributed")

    @contextlib.contextmanager
    def production(*, multi_pod=False):
        with tmesh._world(4, "fake"):
            yield tmesh._mesh(tmesh._card_type(), (2, 2), ("data", "model"))
    monkeypatch.setattr("repro_torch.launch.mesh.make_production_mesh",
                        production)
    monkeypatch.setattr("repro_torch.configs.get_config",
                        lambda name: tconf.reduced_config(tconf.ARCHS[name]))
    monkeypatch.setitem(tconf.SHAPES, "train_4k", dataclasses.replace(
        tconf.SHAPES["train_4k"], seq_len=64, global_batch=8))
    cells = {g: tdry.run_cell("qwen2-moe-a2.7b", "train_4k", "single",
                              probe=False, cfg_overrides={"moe_groups": g})
             for g in (-1, 0)}
    assert not dist.is_initialized()
    a3, glob = (cells[g]["collectives_scanned_program"] for g in (-1, 0))
    n_layers = tconf.reduced_config(tconf.ARCHS["qwen2-moe-a2.7b"]).n_layers
    assert a3["all-reduce"][1] >= n_layers
    assert a3 != glob
    assert math.isfinite(cells[-1]["memory"]["per_device_hbm_bytes"])
