"""The port's LM train step and trainer (``repro_torch.train.{train_step,
trainer}``, ``models.transformer.forward(block_remat=True)``,
``checkpoint.Checkpointer`` on bf16 leaves) against the reference's
(``repro.train``), on the CPU, on ``reduced_config`` sizes.

The reference's parameters are carried across (``params_from_numpy``: bf16
bits kept), so both packages start from the same weights and batches.
Tolerances:

* one loss and gradient step, fp32 replicas of the configs
  (``dataclasses.replace(cfg, dtype="float32")``): the loss and every
  gradient leaf within rtol = atol = 1e-4 of ``jax.value_and_grad``;
* the same in bf16: the reference's contract (finite loss, finite
  gradient norm > 0, ``tests/test_arch_smoke.py``), gradients in bf16,
  and the loss within BF16_LOSS_TOL of the reference's;
* ``make_train_step`` over 3 steps (plain, and compressed with its
  ``err_state``): every leaf's dtype equal to the reference's after each
  step, losses within STEP_LOSS_TOL (step 1 runs in bf16; the optimizer
  lifts the parameters to float32, so later steps run mostly in float32);
* ``block_remat=True`` against ``False`` in the port: loss and gradients
  bit-equal (the CPU recomputes each block with the same ops);
* a reference-written Trainer checkpoint resumed by both packages: losses
  within RESUME_LOSS_TOL.
"""
import dataclasses
import shutil

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.quant import grad_compress as jgc  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
torch = lazy("torch")
tconf = lazy("repro_torch.configs")
tt = lazy("repro_torch.models.transformer")
topt = lazy("repro_torch.optim.optimizer")
tgc = lazy("repro_torch.quant.grad_compress")
tts = lazy("repro_torch.train.train_step")
ttr = lazy("repro_torch.train.trainer")
tpipe = lazy("repro_torch.data.pipeline")
tck = lazy("repro_torch.checkpoint.checkpointer")

jax.config.update("jax_platform_name", "cpu")

FP32_TOL = 1e-4
BF16_LOSS_TOL = 0.02
STEP_LOSS_TOL = 0.02
RESUME_LOSS_TOL = 1e-4
B, T = 2, 32
GRAD_ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-3b",
              "seamless-m4t-medium"]


def _cfgs(arch, dtype="bfloat16"):
    """(reference config, port config) of ``arch``, reduced."""
    j = reduced_config(get_config(arch)).resolve_for_mesh(tp=1)
    t = tconf.reduced_config(tconf.get_config(arch)).resolve_for_mesh(tp=1)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _port(tree):
    return tt.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree):
    """Leaves in flatten order (dict keys sorted), either package's tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _dtypes(tree):
    return [str(x.dtype).replace("torch.", "") for x in _leaves(tree)]


def _batch(cfg, seed=1):
    """The reference's ``test_train_grad_step`` inputs: tokens, next-token
    labels (rolled), frames for the enc-dec arch; numpy, shared."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    batch["labels"] = np.concatenate([batch["tokens"][:, 1:],
                                      batch["tokens"][:, :1]], axis=1)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_train_grad_step_matches_reference(arch):
    """One loss and gradient step, every block family: fp32 replicas
    against ``jax.value_and_grad`` leaf by leaf; bf16 by the reference's
    contract and the loss."""
    for dtype in ("float32", "bfloat16"):
        cfg, tcfg = _cfgs(arch, dtype)
        params = jt.init_params(jax.random.PRNGKey(0), cfg)
        batch = _batch(cfg)
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            jts.make_loss_fn(cfg, unroll=True, q_chunk=0)))(params,
                                                            _jb(batch))
        t_loss, t_grads = tts.value_and_grad(
            tts.make_loss_fn(tcfg, unroll=True, q_chunk=0))(_port(params),
                                                            _tb(batch))
        jl, tl = _leaves(j_grads), _leaves(t_grads)
        assert len(jl) == len(tl) and _dtypes(t_grads) == _dtypes(j_grads)
        if dtype == "float32":
            np.testing.assert_allclose(float(t_loss), float(j_loss),
                                       rtol=FP32_TOL, atol=FP32_TOL)
            for i, (g, w) in enumerate(zip(tl, jl)):
                np.testing.assert_allclose(_np(g), _np(w), rtol=FP32_TOL,
                                           atol=FP32_TOL,
                                           err_msg=f"{arch} leaf {i}")
        else:
            assert np.isfinite(float(t_loss))
            gnorm = sum(float(torch.sum(torch.square(g.float()))) for g in tl)
            assert np.isfinite(gnorm) and gnorm > 0
            assert abs(float(t_loss) - float(j_loss)) < BF16_LOSS_TOL, (
                float(t_loss), float(j_loss))


def test_train_step_plain_and_compressed_match_reference():
    """``make_train_step`` of both packages, 3 steps from the same weights
    and batches: plain with AdamW(lr=3e-3) (``mu`` / ``nu`` stay bf16 in
    step 1), compressed with the launcher's recipe (cosine schedule, clip
    1.0, ``err_state`` carried): the leaf dtypes of every returned tree
    equal the reference's after each step, losses within STEP_LOSS_TOL."""
    cfg, tcfg = _cfgs("smollm-135m")
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    batches = [_batch(cfg, seed) for seed in (1, 2, 3)]
    for compress in (False, True):
        if compress:
            jo = jopt.AdamW(lr=jopt.cosine_schedule(3e-3, 1, 3),
                            clip_norm=1.0)
            to = topt.AdamW(lr=topt.cosine_schedule(3e-3, 1, 3),
                            clip_norm=1.0)
        else:
            jo, to = jopt.AdamW(lr=3e-3), topt.AdamW(lr=3e-3)
        j_step = jax.jit(jts.make_train_step(cfg, jo, unroll=True,
                                             compress_grads=compress))
        t_step = tts.make_train_step(tcfg, to, unroll=True,
                                     compress_grads=compress)
        j_state = [params, jo.init(params)]
        t_state = [_port(params), to.init(_port(params))]
        if compress:
            j_state.append(jgc.init_error_state(params))
            t_state.append(tgc.init_error_state(t_state[0]))
        for i, b in enumerate(batches):
            *j_state, j_m = j_step(*j_state, _jb(b))
            *t_state, t_m = t_step(*t_state, _tb(b))
            for what, jtree, ttree in zip(("params", "opt", "err"), j_state,
                                          t_state):
                assert _dtypes(ttree) == _dtypes(jtree), (compress, i, what)
            assert abs(float(t_m["loss"]) - float(j_m["loss"])) \
                < STEP_LOSS_TOL, (compress, i, float(t_m["loss"]),
                                  float(j_m["loss"]))


def test_block_remat_matches_plain_forward():
    """``forward(block_remat=True)`` in the port: loss and every gradient
    bit-equal to the plain forward, each block family (zamba2's shared
    block runs inside the checkpointed blocks; seamless's encoder is not
    wrapped, as in the reference)."""
    for arch in GRAD_ARCHS:
        cfg, tcfg = _cfgs(arch)
        params = _port(jt.init_params(jax.random.PRNGKey(0), cfg))
        batch = _tb(_batch(cfg))
        out = [tts.value_and_grad(tts.make_loss_fn(
            tcfg, unroll=True, q_chunk=0, block_remat=remat))(params, batch)
            for remat in (False, True)]
        assert torch.equal(out[0][0], out[1][0]), arch
        for a, b in zip(_leaves(out[0][1]), _leaves(out[1][1])):
            assert torch.equal(a, b), arch
    # the sharding arguments leave plain tensors as they are
    from torch.distributed.tensor import Replicate, Shard
    kw = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
    assert torch.equal(
        tt.forward(params, tcfg, batch["tokens"],
                   boundary_sharding=[Shard(0)],
                   logits_sharding=[Replicate()], **kw),
        tt.forward(params, tcfg, batch["tokens"], **kw))


def test_quantized_params_refused_by_both():
    """Training on ``quantize_params`` output: ``jax.value_and_grad``
    raises TypeError on the uint32 words, and so does the port's step on
    their int32 bit-views."""
    from repro.quant.binary_linear import quantize_params as jq
    from repro_torch.quant.binary_linear import quantize_params as tq
    cfg, tcfg = _cfgs("smollm-135m")
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg)
    jo, to = jopt.AdamW(lr=3e-3), topt.AdamW(lr=3e-3)
    qj = jq(params)
    with pytest.raises(TypeError, match="real- or complex-valued"):
        jts.make_train_step(cfg, jo, unroll=True)(qj, jo.init(qj), _jb(batch))
    qt = tq(_port(params))
    with pytest.raises(TypeError, match="real- or complex-valued"):
        tts.make_train_step(tcfg, to, unroll=True)(qt, to.init(qt),
                                                    _tb(batch))


def _port_trainer(tmp_path, fail_at=-1, total=12):
    """The reference's ``_tiny_trainer`` (``tests/test_distribution.py``)
    on the port, from the reference's initial weights."""
    cfg, tcfg = _cfgs("smollm-135m")
    opt = topt.AdamW(lr=3e-3)
    step = tts.make_train_step(tcfg, opt, unroll=True)
    loader = tpipe.PrefetchLoader(tpipe.SyntheticLM(tcfg.vocab, 16), batch=4,
                                  seed=0)

    def init_state():
        params = _port(jt.init_params(jax.random.PRNGKey(0), cfg))
        return params, opt.init(params), ()

    return ttr.Trainer(tcfg, step, init_state, loader, str(tmp_path),
                       ttr.TrainerConfig(total_steps=total, ckpt_every=4,
                                         log_every=4),
                       failer=ttr.FailureInjector(fail_at)
                       if fail_at >= 0 else None, device="cpu")


def test_trainer_loss_decreases(tmp_path):
    tr = _port_trainer(tmp_path, total=40)
    out = tr.run()
    tr.loader.close()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 0.1
    assert [h["step"] for h in tr.history] == list(range(4, 41, 4))


def test_trainer_failure_injection_and_restart(tmp_path, monkeypatch):
    """The reference's contract, and the state the second trainer
    restores at step 8 is the one the first saved, bit for bit, in the
    stored dtypes (float32 parameters and moments, int32 step)."""
    calls = {"n": 0}
    made = []

    def make():
        calls["n"] += 1
        made.append(_port_trainer(tmp_path, fail_at=9 if calls["n"] == 1
                                  else -1, total=12))
        return made[-1]

    saved = {}
    real_save = tck.Checkpointer.save

    def recording_save(self, step, state, blocking=False):
        saved.setdefault(step, [x.clone() for x in _leaves(state)])
        return real_save(self, step, state, blocking)

    monkeypatch.setattr(tck.Checkpointer, "save", recording_save)
    restored = None

    def make_and_peek():
        nonlocal restored
        tr = make()
        if calls["n"] == 2:
            restored = tr._fresh_or_restored()
        return tr

    try:
        out = ttr.run_with_restarts(make_and_peek, max_failures=2)
    finally:
        for tr in made:
            tr.loader.close()
    assert out["restarts"] == 1
    # restarted from step 8 checkpoint -> ran only steps 8..12 the 2nd time
    assert out["steps"] <= 6 and out["steps"] == 4
    *state, start = restored
    assert start == 8
    got = _leaves(state)
    assert len(got) == len(saved[8])
    for a, b in zip(got, saved[8]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {str(x.dtype) for x in got} == {"torch.float32", "torch.int32"}


def test_checkpoint_save_restore_roundtrip(tmp_path):
    """The reference's contract on the port's Checkpointer; then bf16
    leaves both ways: the port writes the reference's bytes (a 2-byte
    void per element) and restores a reference-written bf16 leaf as bf16,
    bit for bit; a 2-byte void under a non-bf16 leaf is refused."""
    from repro.checkpoint.checkpointer import Checkpointer as JCk
    ck = tck.Checkpointer(tmp_path / "c", keep=2)
    state = {"w": torch.arange(8.0), "opt": {"mu": torch.ones((3, 3))}}
    ck.save(10, state, blocking=True)
    ck.save(20, {"w": state["w"] * 2, "opt": {"mu": state["opt"]["mu"] * 2}},
            blocking=True)
    assert ck.latest_step() == 20
    restored = ck.restore(None, state)
    np.testing.assert_allclose(np.asarray(restored["w"]), np.arange(8.0) * 2)
    ck.save(30, state, blocking=True)
    ck.save(40, state, blocking=True)
    steps = sorted(p.name for p in (tmp_path / "c").glob("step_*"))
    assert len(steps) == 2 and steps[-1] == "step_00000040"

    vals = np.random.default_rng(0).standard_normal((5, 3))
    j_state = {"b": jnp.asarray(vals, jnp.bfloat16),
               "s": jnp.zeros((), jnp.int32)}
    t_state = {"b": _port(j_state["b"]), "s": torch.zeros((), dtype=torch.int32)}
    JCk(tmp_path / "j").save(1, j_state, blocking=True)
    tck.Checkpointer(tmp_path / "t").save(1, t_state, blocking=True)
    files = [np.load(tmp_path / d / "step_00000001" / "shard_0.npz")
             for d in ("j", "t")]
    for key in ("a0", "a1"):
        assert files[0][key].dtype == files[1][key].dtype
        assert files[0][key].tobytes() == files[1][key].tobytes()
    assert files[1]["a0"].dtype == np.dtype("V2")
    for d in ("j", "t"):
        back = tck.Checkpointer(tmp_path / d).restore(1, t_state)
        assert back["b"].dtype == torch.bfloat16
        assert torch.equal(back["b"], t_state["b"])
        assert back["s"].dtype == np.int32
    with pytest.raises(ValueError, match="bfloat16"):
        tck.Checkpointer(tmp_path / "j").restore(
            1, {"b": torch.zeros((5, 3)), "s": t_state["s"]})


def test_reference_checkpoint_resumed_by_port(tmp_path):
    """The reference's Trainer trains 8 steps (checkpoints at 4 and 8); a
    copy of its directory is resumed by the port's Trainer and the
    original by the reference's, both to step 12 on the same replayed
    stream: the same 4 steps ran, losses within RESUME_LOSS_TOL."""
    from repro.data.pipeline import PrefetchLoader, SyntheticLM
    from repro.train.trainer import Trainer, TrainerConfig
    cfg, _ = _cfgs("smollm-135m")
    opt = jopt.AdamW(lr=3e-3)
    step = jts.make_train_step(cfg, opt, unroll=True)

    def ref_trainer(total):
        loader = PrefetchLoader(SyntheticLM(cfg.vocab, 16), batch=4, seed=0)

        def init_state():
            params = jt.init_params(jax.random.PRNGKey(0), cfg)
            return params, opt.init(params), ()

        return Trainer(cfg, step, init_state, loader, str(tmp_path / "j"),
                       TrainerConfig(total_steps=total, ckpt_every=4,
                                     log_every=4))

    first = ref_trainer(8)
    first.run()
    first.loader.close()
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    ref = ref_trainer(12)
    want = ref.run()
    ref.loader.close()
    port = _port_trainer(tmp_path / "t", total=12)
    got = port.run()
    port.loader.close()
    assert got["steps"] == want["steps"] == 4
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=0, atol=RESUME_LOSS_TOL)
