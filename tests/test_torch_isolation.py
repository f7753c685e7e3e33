"""The port stands alone: it imports no jax and nothing of the JAX package,
builds no kernel on import, and its copies of the JAX package's jax-free
modules have not drifted from their originals."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# modules the port copies verbatim (path under src/repro == under src/repro_torch)
COPIED = (
    [f"configs/{n}.py" for n in (
        "base", "granite_8b", "internvl2_76b", "moonshot_v1_16b_a3b",
        "musicgen_large", "nemotron_4_15b", "qwen2_5_14b",
        "qwen3_moe_30b_a3b", "stablelm_3b", "xlstm_125m", "zamba2_1_2b")]
    + [f"core/{n}.py" for n in (
        "places", "task", "ptt", "queues", "schedulers", "lifecycle",
        "metrics", "dag", "interference", "faults", "preemption", "shards",
        "runtime")]
    + ["serve/batching.py", "serve/overload.py"]
)

# the only edits a copy may carry: (original text, port text)
EDITS = {
    "core/schedulers.py": [(
        '        from .placement_jax import make_score_fn\n'
        '        score_fn = make_score_fn()\n',
        '        raise ValueError("placement_backend=\'jax\' needs the JAX '
        'package; "\n'
        '                         "the torch placement hook is not ported '
        'yet")\n',
    )],
}

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
from repro_torch.kernels import build
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro", "triton"))
print(json.dumps({"modules": names, "bad": bad, "built": sorted(build._libs)}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.engine" in res["modules"]
    assert "repro_torch.kernels.flash_attention" in res["modules"]
    assert res["bad"] == []
    assert res["built"] == []


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted(ROOT.glob("tools/torch_*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), (path, mod)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    original = (SRC / "repro" / rel).read_text()
    for old, new in EDITS.get(rel, ()):
        assert original.count(old) == 1, f"listed edit no longer applies to {rel}"
        original = original.replace(old, new)
    assert (PORT / rel).read_text() == original
