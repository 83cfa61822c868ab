"""The port and chip_smoke.py import nothing of JAX or of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tchvp_tpu"}
SOURCES = sorted((ROOT / "tchvp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_top_names(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_model_loads_no_jax():
    code = (
        "import sys; import tchvp_tpu_torch.models.video, tchvp_tpu_torch.convert, "
        "tchvp_tpu_torch.bench, tchvp_tpu_torch.train.steps, tchvp_tpu_torch.train.state, "
        "tchvp_tpu_torch.losses, tchvp_tpu_torch.ops.msssim, tchvp_tpu_torch.models.streaming, "
        "tchvp_tpu_torch.ops.tiling; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tchvp_tpu')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
