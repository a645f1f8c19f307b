"""Import hygiene and lock discipline of the port.

* Every module of ``repro_torch`` imports in a fresh interpreter without
  loading ``jax``, any ``repro.*`` module (the reference package's
  ``repro/core/__init__.py`` loads jax; the port keeps its own copies) or
  ``msgpack`` (the checkpoint serializer carries its own codec, so the
  port runs where it is not installed), and no import statement of the
  port or of ``chip_smoke.py`` names jax or the reference.
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
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd_chunk.kernel",
            "repro_torch.kernels.ssd_chunk.ops",
            "repro_torch.kernels.ssd_chunk.ref",
            "repro_torch.models.xlstm",
            "repro_torch.kernels.mlstm_chunk.kernel",
            "repro_torch.kernels.mlstm_chunk.ops",
            "repro_torch.kernels.mlstm_chunk.ref",
            "repro_torch.checkpoint", "repro_torch.checkpoint.serializer",
            "repro_torch.checkpoint.manager", "repro_torch.runtime",
            "repro_torch.runtime.health", "repro_torch.runtime.straggler",
            "repro_torch.runtime.elastic",
            "repro_torch.runtime.failure", "repro_torch.core.replication",
            "repro_torch.kernels.enoki_merge.ref"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.') or m == 'msgpack' "
            "or m.startswith('msgpack.'))))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_warm_path_modules_import_alone():
    """The step cache and the compile counter import in a fresh interpreter
    without jax, the reference or a kernel library, and the counter
    detaches from the step caches when its block ends."""
    code = ("import json, sys\n"
            "from repro_torch.analysis.jitprof import CompileCounter\n"
            "from repro_torch.core import graphs\n"
            "with CompileCounter() as cc:\n"
            "    assert graphs._COUNTERS == [cc]\n"
            "assert graphs._COUNTERS == []\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_no_kernel_library_loads_at_import():
    """Importing every module of the port builds and loads no kernel: a
    library is built and opened at a wrapper's first CUDA launch only."""
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import build\n"
            "assert not build._loaded and not build.BUILD_SECONDS\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'build/lib' not in maps, 'a kernel library is mapped'\n"
            "print(','.join(sorted(build.KERNEL_SOURCES)))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == \
        "enoki_merge,flash_attention,mlstm_chunk,ssd_chunk"


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
