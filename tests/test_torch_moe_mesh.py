"""The global (``moe_groups=0``) and grouped (``moe_groups > 1``) MoE
dispatch of the port on DTensors, through its entry points.

Each test runs its contracts in a spawned process of its own
(``launch.mesh.run_ranks``: one rank, or a gloo world of two CPU ranks), so
no rule that an earlier dry run in the same worker registered can carry
it. The rank functions live in ``tests/torch_mesh_ranks.py``. The tests
hold:

* ``transformer.forward`` with the parameters placed by
  ``param_placements(fsdp=True)`` on a one-rank mesh, for both MoE
  configs at ``moe_groups`` 0 and 2, bit-equal to the plain forward, in a
  process that never loaded the dry run;
* the aten ops that reach DTensor in the MoE block: each must have a
  sharding rule in torch 2.11, the card's installation
  (``tests/dtensor_ops_torch2_11.json``, recorded there by
  ``tools/dtensor_rules.py``); the port registers none;
* the block on a (2, 1) mesh against the reference's ``moe_block`` (JAX
  on the CPU) on the same inputs, the output within 1e-5 and the token and
  parameter gradients within 1e-5 of each leaf's max |g| of
  ``jax.grad``; and against the port's one-process block on the whole
  batch: the global dispatch ranks all tokens (capacity over the batch),
  the grouped form each data shard's own groups. Bit-equal with the
  parameters replicated; with FSDP placements the experts' and the shared
  expert's products sum their contraction dim (sharded over data) in two
  parts, and the output is held within 1e-5. The gradients of weights
  used on sharded rows are sums of the two ranks' parts: within 1e-5 of
  each leaf's max |g|;
* ``Trainer(shardings=)`` on reduced qwen2-moe-a2.7b at ``moe_groups=0``,
  restored under FSDP placements over (2, 1) after a failure, against the
  one-process Trainer, within 1e-5 relative (as
  ``test_trainer_under_shardings_resumes_like_one_process``).
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
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jred  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
tmesh = lazy("repro_torch.launch.mesh")
tmoe = lazy("repro_torch.models.moe")
ttr = lazy("repro_torch.train.trainer")
tconf = lazy("repro_torch.configs")

jax.config.update("jax_platform_name", "cpu")

TIMEOUT_S = 300
TOL = 1e-5
MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
CARD_OPS = Path(__file__).with_name("dtensor_ops_torch2_11.json")


def _ranks(fn, n, *args):
    return tmesh.run_ranks(fn, n, *args, backend="gloo", device="cpu",
                           timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("groups", [0, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_with_placements_bit_equal_in_a_fresh_process(arch, groups):
    """The fault this pins: ``forward`` on a mesh raised
    ``NotImplementedError`` (no sharding strategy for
    ``aten.searchsorted.Tensor``) unless a dry run had registered one in
    the same process. Now the logits are a DTensor equal to the plain
    forward's bit for bit, and no dry run was loaded."""
    (got,) = _ranks(R.moe_forward_one_rank, 1, arch, groups)
    assert got["is_dtensor"] and not got["dryrun_loaded"]
    np.testing.assert_array_equal(got["got"], got["want"])


def test_moe_ops_have_rules_on_the_card():
    """Every aten op that reaches DTensor in the MoE block (forward and
    backward, ``moe_groups`` 0 and 2) has a rule in torch 2.11, and runs
    by a rule here too."""
    card = json.loads(CARD_OPS.read_text())
    assert card["torch"].startswith("2.11")
    ok = {op for op, how in card["ops"].items() if how != "none"}
    (got,) = _ranks(R.moe_op_audit, 1)
    here = {op: how for ops in got["ops"].values() for op, how in ops.items()}
    assert here
    assert set(here) <= ok, sorted(set(here) - ok)
    assert "none" not in here.values(), here


BLOCK_CASES = [(0, False), (0, True), (2, False), (2, True), (3, False)]


@pytest.mark.parametrize("groups,fsdp", BLOCK_CASES)
def test_block_on_two_ranks_matches_one_process(groups, fsdp):
    """``moe_block`` on a (2, 1) mesh of two gloo ranks, the tokens over
    data (4 x 12, ``capacity_factor=1.0``: tokens drop), against the
    reference's block on the same inputs (the output within 1e-5, the
    token and parameter gradients of ``sum(out * r)`` within 1e-5 of each
    leaf's max |g| of ``jax.grad``), and against the port's one-process
    block on the whole batch: the output bit-equal with the
    parameters replicated (within 1e-5 under FSDP), the same on both
    ranks, in the tokens' placements; the loss within 1e-5 relative; every
    gradient within 1e-5 of its leaf's max |g|, in its parameter's
    placements. At 3 groups a data shard holds no whole group, and the
    grouped form gathers the tokens as the global one does."""
    cfg = R.moe_cfg((tconf.get_config, tconf.reduced_config), groups)
    p, x, r = R.moe_inputs(cfg)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmoe.moe_block(pt, xt, cfg)
    loss = (out * torch.from_numpy(r)).sum()
    loss.backward()
    want = out.detach().numpy()
    cfg_j = R.moe_cfg((jget, jred), groups)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    want_j = np.asarray(jmoe.moe_block(pj, jnp.asarray(x), cfg_j))
    g_pj, g_xj = jax.grad(
        lambda pj, xj: (jmoe.moe_block(pj, xj, cfg_j) * r).sum(),
        argnums=(0, 1))(pj, jnp.asarray(x))
    ref_grads = {"x": np.asarray(g_xj),
                 **{k: np.asarray(v) for k, v in g_pj.items()}}
    ranks = _ranks(R.moe_block_world, 2, groups, fsdp)
    for got in ranks:
        np.testing.assert_allclose(got["out"], want_j, rtol=TOL, atol=TOL)
        for name, g in ref_grads.items():
            have = got["x_grad"] if name == "x" else got["grads"][name]
            np.testing.assert_allclose(have, g, rtol=0,
                                       atol=TOL * np.abs(g).max(),
                                       err_msg=f"{name} vs the reference")
        if fsdp:
            np.testing.assert_allclose(got["out"], want, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(got["out"], want)
        np.testing.assert_array_equal(got["out"], ranks[0]["out"])
        assert got["placements"] == ["S(0)", "R"]
        assert got["loss"] == pytest.approx(float(loss.detach()), rel=TOL)
        for name, g in [("x", xt.grad)] + [(k, v.grad)
                                            for k, v in pt.items()]:
            g = g.numpy()
            have = got["x_grad"] if name == "x" else got["grads"][name]
            np.testing.assert_allclose(have, g, rtol=0,
                                       atol=TOL * np.abs(g).max(),
                                       err_msg=name)
        assert got["grad_placements"] == got["param_placements"]


def test_trainer_under_fsdp_global_moe_like_one_process(tmp_path):
    """``run_with_restarts`` in a world of 2 on reduced qwen2-moe-a2.7b
    with global dispatch: a failure at step 2, the restart restored under
    FSDP placements over (2, 1). The losses within 1e-5 relative of the
    one-process Trainer's, equal on both ranks, one restart, every leaf's
    placements kept by every step."""
    failer = ttr.FailureInjector(2)
    made = []

    def make():
        made.append(R.make_trainer("qwen2-moe-a2.7b", str(tmp_path / "one"),
                                   failer, 4, 2, moe_groups=0))
        return made[-1]
    try:
        want = ttr.run_with_restarts(make)
    finally:
        for t in made:
            t.loader.close()
    ranks = _ranks(R.moe_train_world, 2, str(tmp_path / "world"))
    for got in ranks:
        assert got["restarts"] == 1 == want["restarts"]
        assert got["steps"] == want["steps"] == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert got["losses"] == ranks[0]["losses"]
        assert [ok for ok, _ in got["checks"]] == [True] * 4
        assert [m for _, m in got["checks"]] == [False] * 2 + [True] * 2
        assert got["wq_placements"] == ["S(0)", "R"]
