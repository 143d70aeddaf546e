"""Card-only tests of LM training (``repro_torch.train``,
``repro_torch.checkpoint``, ``models.transformer.forward(block_remat=
True)``, the launchers) on ``reduced_config`` sizes, and a checkpoint of
the full ``smollm-135m`` state. They need a CUDA device and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_lm_train.py

* ``chip_smoke.py`` phase 16's checks at reduced depth: the loss falls by
  ``tests/test_distribution.py``'s rule; an injected failure restarts
  from the newest checkpoint with the saved state restored bit for bit;
  the parameters float32 after step 1, the moments bf16 (the reference's
  promotion, AdamW without clipping);
* the full ``smollm-135m`` training state (bf16 parameters as built, and
  the float32 state after one AdamW step) saved and restored bit-equal;
* one compressed step (an fp32 replica): the loss equal to the plain
  step's on the same state, each ``g_hat`` leaf +-its scale, and
  ``g_hat + residual`` equal to the gradient within 1e-6 of its largest
  magnitude;
* every block family's loss and gradients on the card against the CPU's
  on fp32 replicas: rtol = atol = 1e-3 (cuBLAS against MKL sums, TF32
  off);
* ``block_remat`` on the card: the loss bit-equal, gradients within 1e-2
  of each leaf's max |g| (the backward may accumulate in another order);
* both launchers run on the card by default.
"""
import dataclasses

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
pytestmark = pytest.mark.gpu
torch = lazy("torch")

tconf = lazy("repro_torch.configs")
tt = lazy("repro_torch.models.transformer")
topt = lazy("repro_torch.optim.optimizer")
tgc = lazy("repro_torch.quant.grad_compress")
tts = lazy("repro_torch.train.train_step")
ttr = lazy("repro_torch.train.trainer")
tpipe = lazy("repro_torch.data.pipeline")
tck = lazy("repro_torch.checkpoint.checkpointer")
tlt = lazy("repro_torch.launch.train")
tls = lazy("repro_torch.launch.serve")

CARD_VS_CPU_TOL = 1e-3
REMAT_TOL = 1e-2
GRAD_ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-3b",
              "seamless-m4t-medium"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(name, **kw):
    cfg = tconf.reduced_config(tconf.get_config(name)).resolve_for_mesh(tp=1)
    return dataclasses.replace(cfg, **kw)


def _params(cfg, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tt.init_params(cfg, gen, device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _batch(cfg, device, seed=1, b=2, t=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _trainer(tmp_path, device, fail_at=-1, total=12):
    cfg = _cfg("smollm-135m")
    opt = topt.AdamW(lr=3e-3)
    step = tts.make_train_step(cfg, opt, unroll=True)
    loader = tpipe.PrefetchLoader(tpipe.SyntheticLM(cfg.vocab, 16), batch=4,
                                  seed=0)

    def init_state():
        params = _params(cfg, device)
        return params, opt.init(params), ()

    return ttr.Trainer(cfg, step, init_state, loader, str(tmp_path),
                       ttr.TrainerConfig(total_steps=total, ckpt_every=4,
                                         log_every=4),
                       failer=ttr.FailureInjector(fail_at)
                       if fail_at >= 0 else None, device=device)


def test_trainer_loss_decreases_on_card(cuda, tmp_path):
    tr = _trainer(tmp_path, cuda, total=40)
    seen = []
    step = tr.train_step

    def watch(params, opt_state, batch):
        params, opt_state, m = step(params, opt_state, batch)
        if not seen:
            seen.extend([{str(x.dtype) for x in _leaves(params)},
                         {str(x.dtype) for x in _leaves(opt_state.mu)},
                         params["embed"]["table"].device.type])
        return params, opt_state, m

    tr.train_step = watch
    out = tr.run()
    tr.loader.close()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 0.1
    # AdamW without clipping: float32 parameters, bf16 moments after step 1
    assert seen == [{"torch.float32"}, {"torch.bfloat16"}, "cuda"]


def test_trainer_restart_restores_bit_equal_on_card(cuda, tmp_path):
    made, saved, restored = [], {}, {}

    def make():
        tr = _trainer(tmp_path, cuda, fail_at=9 if not made else -1)
        made.append(tr)
        save = tr.ckpt.save

        def recording_save(n, state, blocking=False):
            saved.setdefault(n, [x.clone() for x in _leaves(state)])
            save(n, state, blocking)

        tr.ckpt.save = recording_save
        if len(made) == 2:
            *state, start = tr._fresh_or_restored()
            restored.update(start=start, leaves=_leaves(state))
        return tr

    try:
        out = ttr.run_with_restarts(make, max_failures=2)
    finally:
        for tr in made:
            tr.loader.close()
    assert out["restarts"] == 1 and out["steps"] == 4
    assert restored["start"] == 8
    for a, b in zip(restored["leaves"], saved[8], strict=True):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_full_smollm_checkpoint_bit_equal(cuda, tmp_path):
    """The full-width state: bf16 parameters as built (written as 2-byte
    voids) and the float32 state after one AdamW step."""
    cfg = tconf.get_config("smollm-135m").resolve_for_mesh(tp=1)
    params = _params(cfg, cuda)
    opt = topt.AdamW(lr=1e-3, clip_norm=1.0)
    state = (params, opt.init(params), ())
    ck = tck.Checkpointer(tmp_path)
    ck.save(0, state, blocking=True)
    grads = topt.tree_map(torch.ones_like, params)
    new = opt.update(grads, state[1], params)
    ck.save(1, (*new, ()), blocking=True)
    for n, want in ((0, state), (1, (*new, ()))):
        back = ttr._to_device(ck.restore(n, state), cuda)
        got, ref = _leaves(back), _leaves(want)
        assert len(got) == len(ref) > 200
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert {str(x.dtype) for x in _leaves(new[0])} == {"torch.float32"}


def test_compressed_step_on_card(cuda):
    """On an fp32 replica, so ``g_hat`` keeps the scale unrounded."""
    cfg = _cfg("smollm-135m", dtype="float32")
    params = _params(cfg, cuda)
    opt = topt.AdamW(lr=3e-3, clip_norm=1.0)
    batch = _batch(cfg, cuda)
    err = tgc.init_error_state(params)
    plain = tts.make_train_step(cfg, opt)(params, opt.init(params), batch)
    comp = tts.make_train_step(cfg, opt, compress_grads=True)(
        params, opt.init(params), err, batch)
    assert torch.equal(plain[2]["loss"], comp[3]["loss"])
    assert {str(x.dtype) for x in _leaves(comp[:3])} == {"torch.float32",
                                                        "torch.int32"}
    _, grads = tts.value_and_grad(tts.make_loss_fn(cfg, False, 0))(params,
                                                                   batch)
    g_hat, new_err = tgc.compress_tree(grads, err)
    for g, gh, e in zip(_leaves(grads), _leaves(g_hat), _leaves(new_err),
                        strict=True):
        assert gh.device.type == e.device.type == "cuda"
        scale = float(gh.abs().max())
        assert torch.equal(gh.abs(), torch.full_like(gh, scale))
        assert float((gh + e - g).abs().max()) \
            <= 1e-6 * max(scale, float(g.abs().max()))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grad_step_card_vs_cpu(cuda, arch):
    cfg = _cfg(arch, dtype="float32")
    params = _params(cfg, "cpu")
    batch = _batch(cfg, "cpu")
    fn = tts.value_and_grad(tts.make_loss_fn(cfg, True, 0))
    c_loss, c_grads = fn(params, batch)
    g_loss, g_grads = fn(_to(params, cuda), _to(batch, cuda))
    assert np.isfinite(float(g_loss))
    np.testing.assert_allclose(float(g_loss), float(c_loss),
                               rtol=CARD_VS_CPU_TOL, atol=CARD_VS_CPU_TOL)
    for a, b in zip(_leaves(g_grads), _leaves(c_grads), strict=True):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   rtol=CARD_VS_CPU_TOL,
                                   atol=CARD_VS_CPU_TOL)


def test_block_remat_on_card(cuda):
    cfg = _cfg("smollm-135m")
    params = _params(cfg, cuda)
    batch = _batch(cfg, cuda, b=8, t=128)
    out = [tts.value_and_grad(tts.make_loss_fn(
        cfg, False, 0, block_remat=remat))(params, batch)
        for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(_leaves(out[1][1]), _leaves(out[0][1]), strict=True):
        d = float((a.float() - b.float()).abs().max())
        assert d <= REMAT_TOL * float(b.float().abs().max())


def test_launchers_default_to_the_card(cuda, tmp_path, capsys):
    tlt.main(["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
              str(tmp_path)])
    assert capsys.readouterr().out.startswith("arch=smollm-135m steps=3 ")
    tls.main(["--requests", "2", "--max-new", "4"])
    assert "on cuda" in capsys.readouterr().out
