#!/usr/bin/env python3
"""Which aten ops of the MoE block reach DTensor, and which of them this
torch's DTensor has a sharding rule for.

``models.moe.moe_block`` runs on a reduced qwen2-moe-a2.7b at
``moe_groups`` 0 and 2, forward and backward, with its parameters placed by
``sharding.param_placements(fsdp=True)`` and the tokens by
``data_shardings``, on a one-rank host mesh (``make_host_mesh()``: one
rank, so no collective runs, and a gloo all-gather of device tensors,
which fails on some torch builds, never comes up). A dispatch mode sees
every aten op that has a DTensor among its arguments and records how
DTensor runs it:

* ``rule``: a sharding strategy or rule of the propagator;
* ``handler``: one of the dispatcher's own handlers;
* ``decomposed``: no rule, but a CompositeImplicitAutograd kernel that
  DTensor decomposes into other ops;
* ``none``: DTensor raises. The op then runs on the local tensors (on one
  rank each is the whole tensor), so the block goes on and every op that
  lacks a rule shows in one run.

Prints one JSON line: the torch version, the device, the ops of each case
with how they ran, and the ops with no rule. ``--save FILE`` writes the
ops and how they ran, over both cases, as JSON (``--merge`` adds them to
what FILE holds). ``--tree DIR`` runs the block of another tree (an
earlier commit unpacked with ``git archive``).

    python3 tools/dtensor_rules.py [--device cpu] [--tree DIR]
        [--save FILE [--merge]]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() \
    if "--tree" in sys.argv else HERE
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen2-moe-a2.7b"
GROUPS = (0, 2)
B, T = 2, 8


def how(func) -> str:
    """How DTensor runs the aten op ``func`` in this torch."""
    import torch
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    for table in ("op_strategy_funcs", "op_single_dim_strategy_funcs",
                  "op_to_rules"):
        if func in getattr(prop, table, {}):
            return "rule"
    if func in getattr(dispatcher, "_custom_op_handlers", {}):
        return "handler"
    if torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
        return "decomposed"
    return "none"


def _audit_mode(mesh, ops: dict):
    """A dispatch mode recording in ``ops`` each aten op with a DTensor
    argument and how it ran; an op with no rule runs on the local
    tensors."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map_only

    class Audit(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not any(issubclass(t, DTensor) for t in types):
                return func(*args, **kwargs)
            name = str(func)
            if name not in ops:
                ops[name] = how(func)
            if ops[name] != "none":
                return func(*args, **kwargs)
            local_args, local_kwargs = tree_map_only(
                DTensor, lambda t: t.to_local(), (args, kwargs))
            out = func(*local_args, **local_kwargs)
            if func._schema.is_mutable:      # in place on the first operand
                return args[0]
            return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
                t, mesh, [Replicate()] * mesh.ndim, run_check=False), out)
    return Audit()


def audit(device: str, groups: int) -> dict:
    """The aten ops that reach DTensor in one forward and backward of the
    MoE block at ``groups``, each with how it ran."""
    import dataclasses

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import init_moe, moe_block

    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              moe_groups=groups).resolve_for_mesh(tp=1)
    rng = np.random.default_rng(groups)
    gen = torch.Generator(device=device).manual_seed(groups)
    p = init_moe(gen, cfg, cfg.compute_dtype, device)
    x = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)).to(device,
                                                     cfg.compute_dtype)
    r = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)).to(device)
    ops: dict = {}
    with make_host_mesh(device=torch.device(device).type) as mesh:
        pl = sharding.param_placements({"moe": p}, mesh, fsdp=True)["moe"]
        pd = {k: DTensor.from_local(v, mesh, pl[k]).requires_grad_(True)
              for k, v in p.items()}
        xd = DTensor.from_local(x, mesh, sharding.data_shardings(x, mesh))
        with implicit_replication(), _audit_mode(mesh, ops):
            y = moe_block(pd, xd, cfg)
            (y.to_local().float() * r).sum().backward()
        if not all(v.grad is not None for v in pd.values()):
            raise AssertionError("a parameter got no gradient")
    return ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tree", default=None,
                    help="run the MoE block of this tree")
    ap.add_argument("--save", default=None)
    ap.add_argument("--merge", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")
    cases = {f"moe_groups={g}": audit(args.device, g) for g in GROUPS}
    ops = {op: h for case in cases.values() for op, h in case.items()}
    out = {"torch": torch.__version__, "device": args.device,
           "tree": str(ROOT), "cases": cases,
           "lacking": sorted(op for op, h in ops.items() if h == "none")}
    print(json.dumps(out))
    if args.save:
        path = Path(args.save)
        saved = json.loads(path.read_text()) if args.merge and \
            path.exists() else {"torch": torch.__version__, "ops": {}}
        if saved["torch"] != torch.__version__:
            raise SystemExit(f"{path} holds torch {saved['torch']}'s ops")
        saved["ops"] = dict(sorted({**saved["ops"], **ops}.items()))
        path.write_text(json.dumps(saved, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
