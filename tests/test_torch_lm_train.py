"""The port's LM training pieces against the reference's, on the CPU:
``repro_torch.optim.optimizer.AdamW`` on bf16 and fp32 trees,
``repro_torch.data.pipeline``, ``repro_torch.quant.grad_compress`` and the
two launchers (``repro_torch.launch.{train, serve}``).

Tolerances:

* AdamW after 1 and 2 steps: every leaf of the parameters, ``mu`` and
  ``nu`` in the reference's dtype (JAX promotes a bf16 leaf against a
  strongly typed 0-d float32: the clip scale, the bias corrections, a
  scheduled ``lr``), values within rtol = 1e-6;
* ``SyntheticLM`` batches and the loader's stream: bit-equal;
* ``allreduce_1bit`` and ``Checkpointer.restore(shardings=)`` on a
  one-rank host mesh: the reference's ``tests/test_distribution.py``
  cases, the all-reduce within rtol = 1e-6 of the reference's;
* ``compress_leaf`` / ``compress_tree``: identical sign decisions, values
  within rtol = atol = 1e-6 over 50 steps of error feedback (the scale is
  a mean, summed in another order: a residual near 0 keeps the ulps of
  operands near 1); the reference's EF contracts
  (``tests/test_distribution.py``, ``tests/test_properties.py``) with
  their bounds and hypothesis settings.
"""
import json
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.quant import grad_compress as jgc  # noqa: E402
torch = lazy("torch")
topt = lazy("repro_torch.optim.optimizer")
tpipe = lazy("repro_torch.data.pipeline")
tgc = lazy("repro_torch.quant.grad_compress")
tt = lazy("repro_torch.models.transformer")
tlt = lazy("repro_torch.launch.train")
tls = lazy("repro_torch.launch.serve")
tmesh = lazy("repro_torch.launch.mesh")
tck = lazy("repro_torch.checkpoint.checkpointer")

jax.config.update("jax_platform_name", "cpu")

ADAM_RTOL = 1e-6
EF_TOL = 1e-6


def _port(a):
    return tt.params_from_numpy(np.asarray(a), "cpu")


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same_leaves(what, jtree, ttree, rtol):
    for k in sorted(jtree):
        assert _dtype(ttree[k]) == _dtype(jtree[k]), (what, k, ttree[k].dtype,
                                                      jtree[k].dtype)
        np.testing.assert_allclose(_np(ttree[k]), _np(jtree[k]), rtol=rtol,
                                   atol=0, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("lr", ["float", "cosine"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_leaf_dtypes_match_reference(dtype, clip, lr):
    """Two AdamW steps of both packages from the same tree and gradients
    (each step's gradients in the parameters' current dtype, as autograd
    gives them): the reference lifts bf16 parameters to float32 in step 1,
    and ``mu`` / ``nu`` too when clipping; the port must give the same
    dtypes and values. fp32 trees stay fp32."""
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,)}
    jp = {k: jnp.asarray(rng.standard_normal(s), dtype)
          for k, s in shapes.items()}
    sched = {"float": (1e-2, 1e-2),
             "cosine": (jopt.cosine_schedule(1e-2, 1, 10),
                        topt.cosine_schedule(1e-2, 1, 10))}[lr]
    jo = jopt.AdamW(lr=sched[0], clip_norm=clip, weight_decay=0.01)
    to = topt.AdamW(lr=sched[1], clip_norm=clip, weight_decay=0.01)
    tp = {k: _port(v) for k, v in jp.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in (1, 2):
        g = {k: rng.standard_normal(s) * 3.0 for k, s in shapes.items()}
        jg = {k: jnp.asarray(g[k], jp[k].dtype) for k in g}
        tg = {k: _port(v) for k, v in jg.items()}
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
        _same_leaves(f"params, step {step}", jp, tp, ADAM_RTOL)
        _same_leaves(f"mu, step {step}", js.mu, ts.mu, ADAM_RTOL)
        _same_leaves(f"nu, step {step}", js.nu, ts.nu, ADAM_RTOL)
        assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
        if step == 1:   # the reference's table (ROADMAP Queue 3)
            low = dtype == "bfloat16" and clip is None
            assert _dtype(tp["w"]) == "float32"
            assert _dtype(ts.mu["w"]) == ("bfloat16" if low else "float32")


def test_synthetic_lm_and_loader_match_reference():
    """``SyntheticLM.sample`` bit-equal from the same seeds; both loaders'
    streams bit-equal; the straggler substitution
    (``test_loader_straggler_substitution``'s contract), and a first fetch
    that misses serves the batch of ``default_rng(0)``, as the
    reference's."""
    for seed, n_states in ((0, 64), (3, 16)):
        js = jpipe.SyntheticLM(512, 16, seed=seed, n_states=n_states)
        ts = tpipe.SyntheticLM(512, 16, seed=seed, n_states=n_states)
        a = js.sample(np.random.default_rng(seed + 5), 4)
        b = ts.sample(np.random.default_rng(seed + 5), 4)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    jl = jpipe.PrefetchLoader(jpipe.SyntheticLM(512, 16), batch=4, seed=7)
    tl = tpipe.PrefetchLoader(tpipe.SyntheticLM(512, 16), batch=4, seed=7)
    try:
        for _ in range(3):
            a, b = jl.next_batch(), tl.next_batch()
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
    finally:
        jl.close()
        tl.close()

    class SlowLM(tpipe.SyntheticLM):
        """Its worker thread's samples stall after ``worker_samples``."""

        def __init__(self, worker_samples):
            super().__init__(vocab=64, seq_len=8)
            self.left = worker_samples

        def sample(self, rng, batch):
            if threading.current_thread() is not threading.main_thread():
                if self.left == 0:
                    time.sleep(3600)  # simulated dead input shard
                self.left -= 1
            return super().sample(rng, batch)

    loader = tpipe.PrefetchLoader(SlowLM(1), batch=2, timeout_s=0.3)
    b1 = loader.next_batch()
    b2 = loader.next_batch()   # worker is stuck -> backup batch
    assert loader.straggler_misses >= 1
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    loader._stop.set()

    loader = tpipe.PrefetchLoader(SlowLM(0), batch=2, timeout_s=0.3)
    first = loader.next_batch()
    assert loader.straggler_misses == 1
    want = jpipe.SyntheticLM(64, 8).sample(np.random.default_rng(0), 2)
    np.testing.assert_array_equal(first["tokens"], want["tokens"])
    loader._stop.set()


def test_grad_compress_matches_reference():
    """50 steps of error feedback on one leaf and on a tree of bf16 and
    fp32 leaves: each ``g_hat`` in the gradient's dtype with the
    reference's signs, residuals float32, within EF_TOL; then the
    reference's ``test_grad_compress_error_feedback_converges`` on the
    port."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 4), "b": (5,)}
    dtypes = {"a": jnp.bfloat16, "b": jnp.float32}
    j_err = jgc.init_error_state({k: jnp.zeros(s, dtypes[k])
                                  for k, s in shapes.items()})
    t_err = tgc.init_error_state({k: _port(jnp.zeros(s, dtypes[k]))
                                  for k, s in shapes.items()})
    for k in shapes:
        assert t_err[k].dtype == torch.float32
    for _ in range(50):
        jg = {k: jnp.asarray(rng.standard_normal(s), dtypes[k])
              for k, s in shapes.items()}
        j_hat, j_err = jgc.compress_tree(jg, j_err)
        t_hat, t_err = tgc.compress_tree({k: _port(v) for k, v in jg.items()},
                                         t_err)
        for k in shapes:
            assert _dtype(t_hat[k]) == _dtype(j_hat[k])
            assert t_err[k].dtype == torch.float32
            np.testing.assert_array_equal(_np(t_hat[k]) >= 0,
                                          _np(j_hat[k]) >= 0)
            np.testing.assert_allclose(_np(t_hat[k]), _np(j_hat[k]),
                                       rtol=EF_TOL, atol=EF_TOL)
            np.testing.assert_allclose(_np(t_err[k]), _np(j_err[k]),
                                       rtol=EF_TOL, atol=EF_TOL)

    g_true = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
              for _ in range(50)]
    err = torch.zeros(64)
    acc_c = torch.zeros(64)
    acc_t = torch.zeros(64)
    for g in g_true:
        gh, err = tgc.compress_leaf(g, err)
        acc_c += gh
        acc_t += g
    resid = float(torch.max(torch.abs(acc_c - acc_t)))
    assert resid < 3.0, resid
    with pytest.raises(ValueError, match="mesh"):
        tgc.allreduce_1bit(g_true[0], mesh=None)


def test_allreduce_1bit_one_rank_mesh():
    """The reference's ``test_allreduce_1bit_shard_map`` on the port: over
    a one-rank host mesh the mean of one replica is its own sign * mean
    |g|, equal to the reference's on the same gradient."""
    g = np.random.default_rng(1).standard_normal(128).astype(np.float32)
    with tmesh.make_host_mesh(device="cpu") as mesh:
        out = tgc.allreduce_1bit(torch.from_numpy(g), mesh, axis="data")
    scale = float(np.abs(g).mean())
    np.testing.assert_allclose(out.numpy(), np.where(g >= 0, scale, -scale),
                               rtol=1e-5)
    from repro.launch.mesh import make_host_mesh as jmesh
    want = jgc.allreduce_1bit(jnp.asarray(g), jmesh(), axis="data")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6)


def test_elastic_restore_resharding(tmp_path):
    """The reference's ``test_elastic_restore_resharding`` on the port: a
    checkpoint restored under ``shardings`` of ``(mesh, placements)``
    comes back as DTensors with those placements and the saved values,
    and a reference-written checkpoint restores the same way."""
    from torch.distributed.tensor import Replicate, Shard
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    tck.Checkpointer(tmp_path / "t").save(1, {"w": torch.from_numpy(w)},
                                          blocking=True)
    JCheckpointer(tmp_path / "j").save(1, {"w": jnp.asarray(w)},
                                       blocking=True)
    with tmesh.make_host_mesh(device="cpu") as mesh:
        sh = {"w": (mesh, [Shard(0), Replicate()])}
        for d in ("t", "j"):
            got = tck.Checkpointer(tmp_path / d).restore(
                None, {"w": torch.from_numpy(w)}, shardings=sh)["w"]
            assert tuple(got.placements) == (Shard(0), Replicate())
            assert got.device_mesh is mesh
            np.testing.assert_array_equal(got.full_tensor().numpy(), w)
            np.testing.assert_array_equal(got.to_local().numpy(), w)
        with pytest.raises(ValueError, match="shardings"):
            tck.Checkpointer(tmp_path / "t").restore(
                None, {"w": torch.from_numpy(w)}, shardings={"w": (mesh,)})


@given(st.integers(0, 2**31), st.integers(10, 60))
@settings(max_examples=10, deadline=None)
def test_ef_residual_bounded(seed, steps):
    """The reference's property (``tests/test_properties.py``) on the
    port: the EF residual stays bounded."""
    rng = np.random.default_rng(seed)
    err = torch.zeros(32)
    for _ in range(steps):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        _, err = tgc.compress_leaf(g, err)
    assert float(torch.max(torch.abs(err))) < 10.0


def test_launchers_on_the_cpu(tmp_path, capsys, monkeypatch):
    """Both launchers' ``main()`` with ``--device cpu`` and tiny arguments
    print the reference's summary lines; ``--mesh single|multi`` hands the
    reference's cell (``train_4k`` / ``decode_32k``, the mesh, ``--quant``)
    to the dry run's ``run_cell`` and prints its JSON; ``--quant bitgnn``
    training fails with the step's ``TypeError``, as the reference's
    does."""
    tlt.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
              "16", "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert out.startswith("arch=smollm-135m steps=3 final_loss="), out
    assert (tmp_path / "a" / "step_00000003" / "manifest.json").exists()
    tls.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 12 tokens in "), out
    calls = []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return {"cell": len(calls)}
    monkeypatch.setattr("repro_torch.launch.dryrun.run_cell", recorder)
    for main, shape in ((tlt.main, "train_4k"), (tls.main, "decode_32k")):
        for mesh in ("single", "multi"):
            for quant in ("none", "bitgnn"):
                assert main(["--arch", "rwkv6-3b", "--mesh", mesh,
                             "--quant", quant]) == {"cell": len(calls)}
                assert calls[-1] == (("rwkv6-3b", shape, mesh),
                                     {"quant": quant})
                assert json.loads(capsys.readouterr().out) == \
                    {"cell": len(calls)}
    with pytest.raises(TypeError, match="real- or complex-valued"):
        tlt.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                  "16", "--quant", "bitgnn", "--ckpt-dir",
                  str(tmp_path / "b")])
