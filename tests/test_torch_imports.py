"""The port, chip_smoke.py, the port's examples (``examples/torch_*.py``) and
its scripts (``scripts/torch_*.py``) import nothing of JAX or of the JAX
package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
FILES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + EXAMPLES
         + sorted((REPO / "scripts").glob("torch_*.py")))


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_port_module_loads_without_jax():
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
            for p in PORT.rglob("*.py")]
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('PASS', len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0 and "PASS" in out.stdout, out.stdout + out.stderr


def test_serving_modules_are_checked():
    """The serving slice's subpackages are among the files checked above."""
    checked = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    for name in ("serve/engine.py", "serve/scheduler.py", "serve/sampling.py", "serve/cache.py",
                 "serve/pool/blocks.py", "serve/pool/quant.py", "serve/pool/views.py",
                 "serve/pool/paged_cache.py", "launch/serve.py", "backends/paged.py",
                 "kernels/paged_attention.py", "models/attention.py", "models/rope.py"):
        assert name in checked, name


def test_sharded_modules_are_checked():
    """The sequence-parallel slice's modules are among the files checked above."""
    checked = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    for name in ("distributed/__init__.py", "distributed/compat.py", "distributed/sharding.py",
                 "launch/mesh.py", "core/flare_sp.py", "kernels/flare_packed_shard.py",
                 "backends/packed_shard.py", "backends/seqparallel.py"):
        assert name in checked, name


def test_examples_load_without_jax():
    """Each example module imports (its ``main`` not run) without pulling in
    JAX or the JAX package."""
    code = ("import importlib.util, sys\n"
            f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('example', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('PASS')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0 and "PASS" in out.stdout, out.stdout + out.stderr


def test_spectral_dispatch_and_examples_are_checked():
    """The spectral module, the dispatch CLI's module, the five examples and
    the MLA A/B script are among the files checked above."""
    checked = {str(p.relative_to(REPO)) for p in FILES}
    for name in ("src/repro_torch/core/spectral.py", "src/repro_torch/core/dispatch.py",
                 "src/repro_torch/core/__init__.py", "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/obs/metrics.py", "scripts/torch_ab_mla_fp32_flash.py",
                 *(f"examples/torch_{n}.py" for n in (
                     "quickstart", "train_pde_surrogate", "serve_llm", "long_context_stream",
                     "spectral_analysis"))):
        assert name in checked, name
