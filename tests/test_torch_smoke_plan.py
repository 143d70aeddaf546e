"""What ``chip_smoke.py`` runs, pinned on the CPU without a card.

The card harness cuts the depth of its token and LM phases to stay inside
its time limit; a cut must never narrow a model: every configuration it
builds keeps the registry's width (``configs.ARCHS``). The two parity
phases (2 and 5) must hold every launch the kernel modules count against
its plain version. And the ``walls:`` record splits each phase's seconds
into reference work, timing loops and the worlds' start-up.
"""
import ast
import importlib.util
from pathlib import Path

import pytest

from torch_lazy import lazy, require_torch

require_torch()

ROOT = Path(__file__).resolve().parents[1]
configs = lazy("repro_torch.configs")
bmm_kernel = lazy("repro_torch.kernels.bmm_kernel")
bspmm_kernel = lazy("repro_torch.kernels.bspmm_kernel")
pack_kernel = lazy("repro_torch.kernels.pack_kernel")
fused_layer = lazy("repro_torch.kernels.fused_layer")

WIDTH = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim",
         "moe_experts", "moe_top_k", "moe_shared_ff", "ssm_state",
         "ssm_head_dim", "frontend_dim", "frontend_len")
DEPTH = ("n_layers", "enc_layers", "dec_layers")


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_plan",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source_tree():
    return ast.parse((ROOT / "chip_smoke.py").read_text())


def _same_width(cfg, name):
    full = configs.ARCHS[name]
    return {f: (getattr(cfg, f), getattr(full, f)) for f in WIDTH
            if getattr(cfg, f) != getattr(full, f)}


def test_every_depth_cut_keeps_the_full_width(cs):
    """``depth_cut`` (phases 15 (a)-(c), 16 (b)) changes depth fields
    only, never deepens, and keeps the registry's width for every arch."""
    assert set(cs.GRAD_ARCHS) <= set(configs.ARCHS)
    for name in sorted(configs.ARCHS):
        cut, said = cs.depth_cut(name)
        full = cs.token_config(name)
        assert not _same_width(cut, name), name
        changed = {f for f in full.__dataclass_fields__
                   if getattr(cut, f) != getattr(full, f)}
        assert changed <= set(DEPTH), (name, changed)
        assert all(getattr(cut, f) <= getattr(full, f) for f in DEPTH), name
        assert set(said) == set(cs.TOKEN_DEPTH.get(name, {"n_layers": 2}))


def test_phase_models_are_cut_in_depth_at_full_width(cs):
    """Phases 15 (a), 15 (b), 19 (a) and 19 (b) run their models shallower
    than the registry's, at its width; no ``dataclasses.replace`` in the
    script sets a width field."""
    for name in ("stablelm-1.6b", "rwkv6-3b"):
        cut, _ = cs.depth_cut(name)
        assert cut.n_layers < configs.ARCHS[name].n_layers, name
    for cfg, name in ((cs.ep_config("cuda:0"), cs.EP_ARCH),
                      (cs.mesh_train_config("cuda:0"), cs.LM_ARCH)):
        assert not _same_width(cfg, name), name
        assert cfg.n_layers < configs.ARCHS[name].n_layers, name
    calls = {}
    for node in ast.walk(_source_tree()):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "replace" \
                and getattr(node.func.value, "id", None) == "dataclasses":
            calls[node.lineno] = {k.arg for k in node.keywords}
    assert calls
    for line, keys in calls.items():
        assert not keys & set(WIDTH), (line, keys)
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ('depth_cut("stablelm-1.6b")', 'depth_cut("rwkv6-3b")'):
        assert text.count(phase) == 1, phase


def test_parity_phases_cover_every_counted_launch(cs):
    """Phase 2 holds its cases under the keys of ``REPLACES``, phase 5
    under ``SERVE_KERNELS``: together they name every launch the kernel
    modules count. ``fused_layer/transform`` is the first launch of each
    ``+halo`` form's step, held with it."""
    tree = _source_tree()
    seen = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("run",
                                                           "run_serve"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and getattr(node.targets[0], "id", None) == "err" \
                        and isinstance(node.value, ast.DictComp):
                    seen[fn.name] = node.value.generators[0].iter.id
    assert seen == {"run": "REPLACES", "run_serve": "SERVE_KERNELS"}
    keys = set(cs.REPLACES) | set(cs.SERVE_KERNELS)
    assert set(cs.SERVE_KERNELS) <= set(cs.REPLACES)
    for mod in (pack_kernel, bmm_kernel, bspmm_kernel, fused_layer):
        for entry in mod.LAUNCHES:
            kernel, _, form = entry.partition("/")
            covered = entry in keys or (form == "transform" and any(
                k.startswith(f"{kernel}/") and k.endswith("+halo")
                for k in keys))
            assert kernel in keys and covered, entry


def test_walls_split_a_phase(cs, monkeypatch):
    """``begin`` times phases; ``part`` adds its block once (nested parts
    count in the outer one); ``world`` charges a world's wall less its
    ranks' work to start-up, a failed world whole; the line adds the
    rest. The script's clock is a fake one that ``sleep`` advances."""
    from repro_torch.launch import mesh

    class Clock:
        now = 100.0

        def perf_counter(self):
            return self.now

        def time(self):
            return self.now

        def sleep(self, s):
            self.now += s

    clock = Clock()

    def fake_run_ranks(fn, n, *args, **kw):
        clock.sleep(0.05)                     # start-up
        outs = [fn(r, *args) for r in range(n)]
        clock.sleep(0.05)                     # tear-down
        return outs

    def rank_fn(rank, x):
        clock.sleep(0.1)
        return rank + x

    def broken(fn, n, *args, **kw):
        clock.sleep(0.02)
        raise RuntimeError("rank 0 of 2 failed (exit code -11)")

    monkeypatch.setattr(cs, "time", clock)
    monkeypatch.setattr(cs, "WALLS", {})
    monkeypatch.setattr(mesh, "run_ranks", fake_run_ranks)
    cs.begin("p")
    with cs.part("reference"):
        with cs.part("timing"):
            clock.sleep(0.02)
    assert cs.world(rank_fn, 2, 5) == [5, 6]
    monkeypatch.setattr(mesh, "run_ranks", broken)
    with pytest.raises(RuntimeError):
        cs.world(rank_fn, 2, 5)
    cs.begin(None)
    row = cs.WALLS["p"]
    assert set(row) == {"s", "reference_s", "startup_s"}
    assert row["reference_s"] == pytest.approx(0.02)
    assert row["startup_s"] == pytest.approx(0.05 + 0.05 + 0.02)
    assert row["s"] == pytest.approx(0.02 + 0.3 + 0.02)
    line = cs.walls_line(1.5, "card, 700.00 W")
    assert line.startswith("walls: ")
    import json
    rec = json.loads(line[len("walls: "):])
    assert rec["total_s"] == 1.5 and rec["card"] == "card, 700.00 W"
    p = rec["phases"]["p"]
    assert p["rest_s"] == pytest.approx(
        p["s"] - p["reference_s"] - p["startup_s"])
    assert p["rest_s"] == pytest.approx(0.2)      # the ranks' work
