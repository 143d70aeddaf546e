"""The port stands alone: nothing under src/repro_torch/, in chip_smoke.py
or in the port's GPU tools (tools/*.py) imports JAX or the reference
package, the port's entry points default to the card, and chip_smoke.py
refuses to run without a CUDA device or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    assert (ROOT / "src" / "repro_torch" / "optim" / "optimizer.py").is_file()
    assert (ROOT / "src" / "repro_torch" / "serve" / "token_engine.py").is_file()
    for rel in ("data/pipeline.py", "quant/grad_compress.py",
                "train/train_step.py", "train/trainer.py", "launch/train.py",
                "launch/serve.py", "env.py", "distributed/sharding.py",
                "distributed/hlo_analysis.py", "launch/dryrun.py",
                "launch/mesh.py", "distributed/collectives.py"):
        assert (ROOT / "src" / "repro_torch" / rel).is_file(), rel
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 10
    bad = {str(p.relative_to(ROOT)): m for p in files for m in _imported(p)
           if m.split(".")[0] in FORBIDDEN}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    pytest.importorskip("torch")
    code = ("import sys, repro_torch.models.gnn, repro_torch.kernels.ops, "
            "repro_torch.serve.sharded, repro_torch.graphs.partition, "
            "repro_torch.optim, repro_torch.graphs.sampling, "
            "repro_torch.serve.replica, repro_torch.configs, "
            "repro_torch.models.transformer, repro_torch.quant, "
            "repro_torch.serve.token_engine, repro_torch.serve.engine, "
            "repro_torch.data.pipeline, repro_torch.quant.grad_compress, "
            "repro_torch.train.train_step, repro_torch.train.trainer, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.env, repro_torch.distributed.sharding, "
            "repro_torch.distributed.hlo_analysis, "
            "repro_torch.launch.dryrun, repro_torch.launch.mesh, "
            "repro_torch.distributed.collectives; "
            "from repro_torch.serve.sharded import SpmdLayerExecutor, "
            "mesh_exchange, ring_scatter; "
            "from repro_torch.launch.mesh import run_ranks; "
            "from repro_torch.serve.sharded.planner import validate_reshard; "
            "from repro_torch.models.moe import _moe_shard_map; "
            "from repro_torch.distributed.sharding import param_shardings, "
            "opt_shardings, match_placements, redistribute_tree; "
            "from repro_torch.core.bitops import and_dot, trinary_dot, "
            "trinary_dot_s1, spmm_trinary_words, TRINARY_MODES; "
            "from repro_torch.core.bmm import bmm_reference_fp; "
            "from repro_torch.core.bspmm import spmm_reference_fp; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_the_card():
    """The port's entry points that place tensors run on ``cuda`` unless
    the caller asks for the CPU (the tests do)."""
    pytest.importorskip("torch")
    import inspect
    import importlib
    sys.path.insert(0, str(ROOT / "src"))
    try:
        mods = {m: importlib.import_module(f"repro_torch.{m}") for m in (
            "serve.gnn_session", "serve.sharded.session",
            "serve.sharded.executor", "graphs.partition",
            "serve.replica.router", "serve.token_session",
            "serve.engine", "models.transformer", "train.trainer",
            "launch.mesh")}
    finally:
        sys.path.remove(str(ROOT / "src"))
    entries = [
        mods["serve.gnn_session"].GraphStore.__init__,
        mods["serve.gnn_session"].CompiledGraphSession.__init__,
        mods["serve.sharded.session"].ShardedGraphSession.__init__,
        mods["serve.sharded.session"].ShardedGraphSession.load,
        mods["serve.sharded.executor"].HostLayerExecutor.__init__,
        mods["serve.sharded.executor"].SpmdLayerExecutor.__init__,
        mods["launch.mesh"].run_ranks,
        mods["graphs.partition"].partition_rows,
        mods["serve.replica.router"].build_replica,
        mods["serve.token_session"].TokenSession.__init__,
        mods["serve.token_session"].TokenStore.__init__,
        mods["serve.engine"].ServeEngine.__init__,
        mods["models.transformer"].init_params,
        mods["models.transformer"].init_cache,
        mods["train.trainer"].Trainer.__init__,
    ]
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    # the launchers' --device flag
    for name in ("train", "serve"):
        path = ROOT / "src" / "repro_torch" / "launch" / f"{name}.py"
        defaults = [kw.value.value
                    for node in ast.walk(ast.parse(path.read_text()))
                    if isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == "--device"
                    for kw in node.keywords if kw.arg == "default"]
        assert defaults == ["cuda"], (name, defaults)


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """No CUDA device: exit non-zero and print no result. Alone in a
    directory: the same."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
