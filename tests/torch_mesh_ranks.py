"""Rank functions of ``tests/test_torch_mesh_train.py``.

``launch.mesh.run_ranks`` starts each rank with ``spawn``, which pickles
the function by reference: the functions live at module level here, in a
module that imports neither pytest nor the reference package, so a rank
loads only torch and the port. Each rank runs the contracts of one world
once and returns numpy results; the test file holds them against the
reference's and the port's one-process forms, computed in the test
process from the same numpy inputs (:func:`moe_inputs`, the seeded
loader and ``torch.Generator`` weights of :func:`make_trainer`).
"""
import dataclasses
import os

import numpy as np

B, T = 4, 12                    # the expert-parallel MoE inputs
TRAIN_BATCH, TRAIN_SEQ = 4, 16  # the trainer's loader
MISS_AT = 1                     # rank 1's loader misses its 2nd batch


def moe_cfg(config_fns, groups: int, tp: int = 1, experts: int = 0):
    """``reduced_config("qwen2-moe-a2.7b")`` in fp32 with
    ``capacity_factor=1.0`` (tokens drop), ``moe_groups`` set, padded for
    ``tp``; ``experts`` replaces the expert count. ``config_fns`` is
    ``(get_config, reduced_config)`` of either package."""
    get_config, reduced_config = config_fns
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-moe-a2.7b")),
                              capacity_factor=1.0, dtype="float32",
                              moe_groups=groups)
    if experts:
        cfg = dataclasses.replace(cfg, moe_experts=experts)
    return cfg.resolve_for_mesh(tp=tp)


def moe_inputs(cfg):
    """The MoE block's parameters, tokens and output cotangent, numpy."""
    rng = np.random.default_rng(cfg.moe_experts_padded or cfg.moe_experts)
    d, ff, sf = cfg.d_model, cfg.d_ff, cfg.moe_shared_ff
    e = cfg.moe_experts_padded or cfg.moe_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(d, e), "wi": w(e, d, 2 * ff), "wo": w(e, ff, d),
         "shared_wi": w(d, 2 * sf), "shared_wo": w(sf, d),
         "shared_gate": w(d, 1)}
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    r = rng.standard_normal((B, T, d)).astype(np.float32)
    return p, x, r


def _torch_cfgs():
    from repro_torch.configs import get_config, reduced_config
    return get_config, reduced_config


def ep_moe(mesh, cfg):
    """``moe_block`` with ``moe_groups=-1`` on ``mesh``: the output, the
    loss ``sum(out * r)``, the all-reduces of the forward, each rank's
    local expert gradients in the experts' placements, and the router's
    gradient gathered."""
    import torch
    from repro_torch.checkpoint.checkpointer import _place
    from repro_torch.distributed import sharding
    from repro_torch.distributed.hlo_analysis import CollectiveRecorder
    from repro_torch.models.moe import moe_block

    p, x, r = moe_inputs(cfg)
    pl = sharding.param_placements({"moe": p}, mesh)["moe"]
    pd = {k: _place(v, mesh, pl[k]).requires_grad_(True)
          for k, v in p.items()}
    xd = _place(x, mesh, sharding.placements(("data", None, None), mesh))
    with CollectiveRecorder() as rec:
        y = moe_block(pd, xd, cfg)
    out = y.full_tensor()
    loss = (out * torch.from_numpy(r)).sum()
    loss.backward()
    grads = sharding.match_placements({k: v.grad for k, v in pd.items()},
                                      pd)
    return {"out": out.detach().numpy(), "loss": float(loss),
            "all_reduces": rec.stats().count_by_op.get("all-reduce", 0),
            "wi": grads["wi"].to_local().numpy(),
            "wo": grads["wo"].to_local().numpy(),
            "router": grads["router"].full_tensor().numpy(),
            "grad_placements": {k: [str(q) for q in v.placements]
                                for k, v in grads.items()},
            "param_placements": {k: [str(q) for q in v.placements]
                                 for k, v in pd.items()}}


def make_trainer(arch, ckpt_dir, failer, total, ckpt_every, shardings_fn=None,
                 moe_groups=0):
    """The port's Trainer on ``reduced_config(arch)`` from seeded
    ``torch.Generator`` weights, a seeded loader, AdamW; ``shardings_fn``
    maps the initial state to the ``shardings`` tree."""
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import PrefetchLoader, SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer as tr

    cfg = dataclasses.replace(
        reduced_config(get_config(arch)).resolve_for_mesh(tp=1),
        moe_groups=moe_groups)
    opt = AdamW(lr=3e-3)
    step = ts.make_train_step(cfg, opt, unroll=True)
    loader = PrefetchLoader(SyntheticLM(cfg.vocab, TRAIN_SEQ),
                            batch=TRAIN_BATCH, seed=0)

    def init_state():
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu")
        return params, opt.init(params), ()

    shardings = shardings_fn(init_state()) if shardings_fn else None
    return tr.Trainer(cfg, step, init_state, loader, ckpt_dir,
                      tr.TrainerConfig(total_steps=total,
                                       ckpt_every=ckpt_every,
                                       log_every=ckpt_every),
                      failer=failer, shardings=shardings, device="cpu")


def _state_np(state):
    """The leaves of a training state in flatten order, numpy (a DTensor
    gathered first)."""
    from repro_torch.checkpoint.checkpointer import _flatten, _host
    out = []
    for leaf in _flatten(state)[1]:
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        out.append(_host(leaf))
    return out


def train_world(rank, arch, ckpt_dir, model, fsdp, total, ckpt_every,
                fail_at, moe_groups=0, miss=False):
    """``run_with_restarts`` in this world under the placements of
    ``param_placements(fsdp=...)`` over a (world / model, model) mesh;
    an injected failure at ``fail_at``; with ``miss``, rank 1's loader
    serves a stand-in batch at its ``MISS_AT``-th call and counts a
    miss. Returns the losses, each step's placements check (equal before
    and after, and whether the state held DTensors), the final state
    gathered, its placements, and the files this rank wrote."""
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.train import trainer as tr

    writes, checks, last, trainers = [], [], [], []
    real_savez = checkpointer.np.savez

    def savez(path, **arrays):
        writes.append(os.path.relpath(str(path), ckpt_dir))
        return real_savez(path, **arrays)
    checkpointer.np.savez = savez
    try:
        with make_host_mesh(model=model, device="cpu") as mesh:
            def shardings_fn(state):
                p_sh = sharding.param_shardings(state[0], mesh, fsdp=fsdp)
                return p_sh, sharding.opt_shardings(p_sh, mesh), ()

            failer = tr.FailureInjector(fail_at)

            def make():
                t = make_trainer(arch, ckpt_dir, failer, total, ckpt_every,
                                 shardings_fn, moe_groups)
                step = t.train_step

                def recorded(params, opt_state, batch):
                    out = step(params, opt_state, batch)
                    before = sharding.placements_of((params, opt_state))
                    after = sharding.placements_of(out[:2])
                    checks.append((before == after, "DTensor" in str(
                        type(tree_leaves(params)[0]))))
                    last[:] = [out[:2]]
                    return out
                t.train_step = recorded
                if miss and rank == 1:
                    _miss_once(t.loader)
                trainers.append(t)
                return t
            out = tr.run_with_restarts(make)
            final = _state_np((*last[0], ()))
            placements = [str(p) for p in sharding.placements_of(
                last[0][0])["blocks"][0]["attn"]["wq"]]
    finally:
        checkpointer.np.savez = real_savez
        for t in trainers:
            t.loader.close()
    return {"rank": rank, "losses": out["losses"],
            "restarts": out["restarts"], "steps": out["steps"],
            "misses": out["straggler_misses"], "checks": checks,
            "final": final, "writes": writes, "wq_placements": placements,
            "torch_threads": torch.get_num_threads()}


def _miss_once(loader):
    """Rank 1's loader serves a stand-in batch (its last batch again, or
    zeros) at its ``MISS_AT``-th call and counts a straggler miss."""
    real = loader.next_batch
    calls = {"n": 0}

    def next_batch():
        b = real()
        calls["n"] += 1
        if calls["n"] == MISS_AT + 1:
            loader.straggler_misses += 1
            return {k: np.zeros_like(v) for k, v in b.items()}
        return b
    loader.next_batch = next_batch


def compressed_steps(rank, mesh=None, steps=2):
    """Two ``make_train_step(compress_grads=True)`` steps on reduced
    smollm-135m in fp32: on ``mesh`` the parameters, AdamW's moments and the
    error state under FSDP placements and the batch over data, else plain
    tensors. Returns the losses, the final error state gathered and
    whether every leaf kept its placements."""
    import contextlib

    import torch
    from repro_torch.checkpoint.checkpointer import _place
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.quant.grad_compress import init_error_state
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(reduced_config(get_config(
        "smollm-135m")).resolve_for_mesh(tp=1), dtype="float32")
    opt = AdamW(lr=3e-3)
    step = ts.make_train_step(cfg, opt, unroll=True, compress_grads=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    state = (params, opt.init(params), init_error_state(params))
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab, TRAIN_SEQ).sample(rng, TRAIN_BATCH).items()}
        for _ in range(steps)]
    ctx = contextlib.nullcontext()
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        p_sh = sharding.param_shardings(params, mesh, fsdp=True)
        from repro_torch.checkpoint.checkpointer import (_flatten,
                                                         _sharding_leaves,
                                                         _unflatten)
        shardings = (p_sh, sharding.opt_shardings(p_sh, mesh), p_sh)
        state = _unflatten(state, [_place(v, *pl) for v, pl in zip(
            _flatten(state)[1], _sharding_leaves(shardings))])
        batches = [sharding.zip_map(lambda v, pl: _place(v, mesh, pl), b,
                                    sharding.data_shardings(b, mesh))
                   for b in batches]
        ctx = implicit_replication()
    layout = sharding.placements_of(state)
    losses, kept = [], True
    with ctx:
        for b in batches:
            *state, metrics = step(*state, b)
            kept = kept and sharding.placements_of(tuple(state)) == layout
            loss = metrics["loss"]
            losses.append(float(loss.full_tensor() if hasattr(
                loss, "full_tensor") else loss))
    return {"losses": losses, "err": _state_np(state[2]), "kept": kept,
            "err_placements": [str(p) for p in sharding.placements_of(
                state[2])["blocks"][0]["attn"]["wq"] or []]}


def world2(rank, ckpt_root):
    """The contracts of the world of 2 ranks."""
    os.nice(10)
    from repro_torch.launch.mesh import make_host_mesh

    out = {"rank": rank}
    for shape in ((1, 2), (2, 1)):
        with make_host_mesh(model=shape[1], device="cpu") as mesh:
            out[f"ep/{shape}"] = ep_moe(mesh, moe_cfg(_torch_cfgs(), -1,
                                                      tp=shape[1]))
    with make_host_mesh(model=1, device="cpu") as mesh:
        out["compress/fsdp"] = compressed_steps(rank, mesh)
    out["train/fsdp"] = train_world(
        rank, "smollm-135m", os.path.join(ckpt_root, "fsdp"), model=1,
        fsdp=True, total=6, ckpt_every=3, fail_at=3, miss=True)
    out["train/moe"] = train_world(
        rank, "qwen2-moe-a2.7b", os.path.join(ckpt_root, "moe"), model=2,
        fsdp=False, total=4, ckpt_every=2, fail_at=2, moe_groups=-1)
    return out


def world4(rank):
    """The contracts of the world of 4 ranks: (2, 2), and (1, 4) with 6
    experts padded to 8."""
    os.nice(10)
    from repro_torch.launch.mesh import make_host_mesh

    out = {"rank": rank}
    with make_host_mesh(model=2, device="cpu") as mesh:
        out["ep/(2, 2)"] = ep_moe(mesh, moe_cfg(_torch_cfgs(), -1, tp=2))
    with make_host_mesh(model=4, device="cpu") as mesh:
        out["ep/padded"] = ep_moe(mesh, moe_cfg(_torch_cfgs(), -1, tp=4,
                                                experts=6))
    return out


def fail_in_trainer(rank, ckpt_dir):
    """Rank 1 raises inside ``Trainer.run`` (its loader fails at the
    second batch); rank 0 would wait in the next collective."""
    from repro_torch.train import trainer as tr
    t = make_trainer("smollm-135m", ckpt_dir, None, 4, 2)
    if rank == 1:
        real = t.loader.next_batch
        calls = {"n": 0}

        def next_batch():
            calls["n"] += 1
            if calls["n"] == 2:
                raise OSError("rank 1's data source is gone")
            return real()
        t.loader.next_batch = next_batch
    try:
        return tr.run_with_restarts(lambda: t)
    finally:
        t.loader.close()


def moe_forward_one_rank(rank, arch, groups):
    """``transformer.forward`` of ``reduced_config(arch)`` at ``groups``
    on plain tensors, then with the parameters placed by
    ``param_placements(fsdp=True)`` and the tokens by ``data_shardings`` on
    a one-rank gloo mesh, through the entry points alone (no dry run in
    this fresh process): both logits, and whether a dry run was loaded."""
    os.nice(10)
    import sys

    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.checkpointer import _place
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              moe_groups=groups).resolve_for_mesh(tp=1)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    want = transformer.forward(params, cfg, torch.from_numpy(tokens))
    with make_host_mesh(device="cpu") as mesh:
        pl = sharding.param_placements(params, mesh, fsdp=True)
        dparams = sharding.zip_map(lambda v, p: _place(v, mesh, p), params,
                                   pl)
        dtok = _place(tokens, mesh, sharding.data_shardings(tokens, mesh))
        with implicit_replication():
            got = transformer.forward(
                dparams, cfg, dtok,
                boundary_sharding=sharding.placements(
                    ("data", "model", None), mesh),
                logits_sharding=sharding.logits_sharding(mesh, 2))
        is_dtensor = "DTensor" in type(got).__name__
        got = got.full_tensor()
    return {"want": want.detach().float().numpy(),
            "got": got.detach().float().numpy(),
            "is_dtensor": is_dtensor,
            "dryrun_loaded": "repro_torch.launch.dryrun" in sys.modules}


def moe_op_audit(rank):
    """``tools/dtensor_rules.py``'s audit of the MoE block here: the aten
    ops that reach DTensor at each ``moe_groups`` and how they ran."""
    os.nice(10)
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "dtensor_rules.py"
    spec = importlib.util.spec_from_file_location("dtensor_rules", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return {"ops": {g: tool.audit("cpu", g) for g in tool.GROUPS}}


def moe_block_world(rank, groups, fsdp):
    """The MoE block of :func:`moe_cfg` at ``groups`` on a (2, 1) mesh:
    the parameters placed by ``param_placements(fsdp=...)``, the tokens
    over data. The output and the loss ``sum(out * r)`` gathered, and the
    token and parameter gradients gathered, each in its placements."""
    os.nice(10)
    import torch
    from repro_torch.checkpoint.checkpointer import _place
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import moe_block

    cfg = moe_cfg(_torch_cfgs(), groups)
    p, x, r = moe_inputs(cfg)
    with make_host_mesh(device="cpu") as mesh:
        pl = sharding.param_placements({"moe": p}, mesh, fsdp=fsdp)["moe"]
        pd = {k: _place(v, mesh, pl[k]).requires_grad_(True)
              for k, v in p.items()}
        xd = _place(x, mesh, sharding.placements(("data", None, None), mesh)
                    ).requires_grad_(True)
        y = moe_block(pd, xd, cfg)
        out = y.full_tensor()
        loss = (out * torch.from_numpy(r)).sum()
        loss.backward()
        grads = sharding.match_placements({k: v.grad for k, v in pd.items()},
                                          pd)
        return {"out": out.detach().numpy(), "loss": float(loss),
                "x_grad": xd.grad.full_tensor().numpy(),
                "grads": {k: g.full_tensor().numpy()
                          for k, g in grads.items()},
                "placements": [str(q) for q in y.placements],
                "grad_placements": {k: [str(q) for q in v.placements]
                                    for k, v in grads.items()},
                "param_placements": {k: [str(q) for q in v.placements]
                                     for k, v in pd.items()}}


def moe_train_world(rank, ckpt_dir):
    """:func:`train_world` on reduced qwen2-moe-a2.7b with global dispatch
    (``moe_groups=0``), restored under FSDP placements over (2, 1)."""
    os.nice(10)
    return train_world(rank, "qwen2-moe-a2.7b", ckpt_dir, model=1, fsdp=True,
                       total=4, ckpt_every=2, fail_at=2, moe_groups=0)
