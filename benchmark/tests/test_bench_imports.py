"""Nothing the benchmark imports has the top-level name of JAX, its
libraries or the JAX package (`tngp`; `tngp_torch` is another name), and the
reference imports nothing of the program; the run's own check finds such a
module once it is loaded."""

import ast
import sys
import types

from benchmark import harness


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_anywhere():
    for path in harness.BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").rglob("*.py"):
        assert "tngp_torch" not in set(_imports(path)), path


def test_run_check_compares_whole_top_level_names():
    assert "tngp_torch" not in harness.forbidden_modules()
    sys.modules["tngp.fake_probe"] = types.ModuleType("tngp.fake_probe")
    try:
        assert harness.forbidden_modules() == ["tngp"]
    finally:
        del sys.modules["tngp.fake_probe"]
