"""Nothing the benchmark runs may load JAX or the JAX package, and the
yardstick (`reference/`, `counts/`) may not lean on the program. Walks
the imports of every module under `benchmark/` (their syntax, so imports
inside functions count too) and compares top-level names whole: the
port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu"}
YARDSTICK = ("reference", "counts")


def imports(path: Path):
    """(top-level name, full name) of every import in a module; relative
    imports resolve inside `benchmark`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package = path.relative_to(BENCH.parent).with_suffix("").parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                full = ".".join(base + ((node.module,) if node.module else ()))
            else:
                full = node.module
            yield full.split(".")[0], full


MODULES = sorted(BENCH.rglob("*.py"))


def test_walks_every_module():
    names = {p.relative_to(BENCH).as_posix() for p in MODULES}
    assert {"run.py", "harness/runner.py", "reference/transformer.py", "counts/model.py",
            "metrics/serve.mfu.py"} <= names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_anywhere(path):
    found = {top for top, _ in imports(path)} & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", [p for p in MODULES if p.relative_to(BENCH).parts[0] in YARDSTICK],
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_yardstick_imports_nothing_of_the_program(path):
    part = path.relative_to(BENCH).parts[0]
    for top, full in imports(path):
        assert top != "ray_tpu_torch", f"{path} imports {full}"
        if top == "benchmark":
            assert full.split(".")[1] == part, f"{path} imports {full} outside {part}/"


def test_the_walk_sees_relative_and_nested_imports(tmp_path):
    mod = BENCH / "reference" / "_probe_for_test.py"
    try:
        mod.write_text("def f():\n    import jax.numpy\n    from ..harness import runner\n")
        found = list(imports(mod))
        assert ("jax", "jax.numpy") in found and ("benchmark", "benchmark.harness") in found
    finally:
        mod.unlink()
