"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys
import types

import pytest

from h100bench import bench, run
from helpers import REPO, tiny_root

PORT = "distributedfft_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    files = sorted((REPO / "h100bench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        names = set(_imports(path))
        assert not names & set(bench.FORBIDDEN), path


def test_references_import_nothing_of_the_port():
    for path in (REPO / "h100bench" / "references").glob("*.py"):
        names = set(_imports(path))
        assert PORT not in names and not names & set(bench.FORBIDDEN), path
        assert names <= {"__future__", "torch", "numpy", "math"}, path


@pytest.mark.parametrize("name,flagged", [
    ("distributedfft_tpu", True), ("distributedfft_tpu.api", True),
    ("jax", True), ("jaxlib.xla_client", True), ("flax", True),
    ("distributedfft_tpu_torch", False), ("distributedfft_tpu_torch.api", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_whole_top_level_names(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in bench.forbidden_loaded()) == flagged


def test_a_run_that_loaded_jax_prints_no_result(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "grid512_1card.c2c", "--seed", "5",
                   "--seconds", "0.2", "--cpu", "--root",
                   str(tiny_root(tmp_path))])
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "jax" in err


def test_a_run_loads_none(tmp_path):
    """A whole rehearsal in a fresh process, the port and the reference
    loaded, leaves none of the forbidden modules in it."""
    root = tiny_root(tmp_path)
    code = ("import sys; from h100bench import bench, run; "
            "rc = run.main(['--workload', 'grid512_1card.r2c', '--seed', "
            f"'3', '--seconds', '0.2', '--cpu', '--root', {str(root)!r}]); "
            "print('LOADED', bench.forbidden_loaded(), "
            "'distributedfft_tpu_torch' in sys.modules); sys.exit(rc)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "LOADED [] True" in p.stdout
