"""The port stands alone: no file of ``src/repro_torch/`` and none of its
card scripts (``chip_smoke.py``, ``kernel_turns.py``, ``serve_turns.py``,
``gram_variants.py``, ``mix_variants.py``) imports ``jax``, the reference
package ``repro`` or
``msgpack`` (the card's machine has none of them; the checkpoints carry
their own msgpack subset), and ``import repro_torch`` works in a process
where none of them was ever loaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "kernel_turns.py", "serve_turns.py",
                             "gram_variants.py", "mix_variants.py")]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists(), path
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names_are_caught():
    assert _forbidden("jax.numpy") and _forbidden("repro.core") and _forbidden("repro")
    assert _forbidden("msgpack")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def test_import_without_jax_loaded():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.federated.simulation, "
        "repro_torch.data.synthetic, repro_torch.models.lenet, repro_torch.interop, "
        "repro_torch.configs, repro_torch.models.transformer, repro_torch.launch.serve, "
        "repro_torch.federated.faults, repro_torch.core.similarity, repro_torch.checkpoint, "
        "repro_torch.checkpoint.io, repro_torch.optim, repro_torch.data.lm_synthetic, "
        "repro_torch.launch.steps, repro_torch.launch.train, repro_torch.core.pytree, "
        "repro_torch.models.whisper, repro_torch.models.registry\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro', 'msgpack'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
