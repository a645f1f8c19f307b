"""Import hygiene and lock discipline of the port.

* Every module of ``repro_torch`` imports in a fresh interpreter without
  loading ``jax`` or any ``repro.*`` module (the reference package's
  ``repro/core/__init__.py`` loads jax; the port keeps its own copies),
  and no import statement of the port or of ``chip_smoke.py`` names them.
* The reference's AST lock lint is clean on ``src/repro_torch``.
* No ``torch.`` call sits lexically under ``self._qlock`` in the port's
  engine: the queue lock is never held across device work (the lint's
  dispatch tables know only jax roots).
"""
import ast
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})


def test_port_imports_no_jax_and_no_reference():
    mods = _modules()
    assert "repro_torch.core.cluster" in mods and len(mods) > 20
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_no_jax_or_reference_import_anywhere():
    """Every import statement of the port and of ``chip_smoke.py``,
    function-level ones included (the smoke imports the port inside
    ``main``), names neither jax nor the reference package."""
    bad = []
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno}: "
                               f"{name}")
    assert not bad, "\n".join(bad)


def test_lockcheck_clean_on_port():
    proc = subprocess.run(
        [sys.executable, "-m", "repro.analysis.lockcheck", "src/repro_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lockcheck: OK" in proc.stdout


def _qlock_bodies(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if ast.unparse(item.context_expr) == "self._qlock":
                    yield node


def test_no_torch_call_under_qlock():
    tree = ast.parse((PORT / "core" / "engine.py").read_text())
    blocks = list(_qlock_bodies(tree))
    assert blocks, "engine.py has no `with self._qlock` block to check"
    bad = []
    for block in blocks:
        for stmt in block.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                root = node.func
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id == "torch":
                    bad.append(f"engine.py:{node.lineno}: "
                               f"{ast.unparse(node.func)}()")
    assert not bad, "torch calls under engine.qlock:\n" + "\n".join(bad)
