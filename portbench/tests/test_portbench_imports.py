"""Nothing under portbench/ imports JAX or the JAX package, comparing the
top-level name whole; the reference imports nothing of the program."""
import ast
import sys

from portbench import harness

FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        top = {n.split(".")[0] for n in imports(path)}
        assert not top & FOREIGN, (path, top & FOREIGN)


def test_reference_and_counts_take_nothing_from_the_program():
    for part in ("reference", "counts", "data"):
        for path in (harness.BENCH / part).rglob("*.py"):
            for n in imports(path):
                assert not n.startswith(("repro_torch", "portbench.programs")), \
                    (path, n)


def test_no_module_reads_the_jax_benchmarks_folder():
    for path in harness.BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert "benchmarks/" not in path.read_text(), path


def test_foreign_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    found = harness.foreign_modules()
    assert "repro" in found and "jax" in found
