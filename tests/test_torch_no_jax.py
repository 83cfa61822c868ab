"""The port, chip_smoke.py, the scripts beside it that time its kernels
(fused_tail_breakdown.py, window_fwd_breakdown.py, flash_fwd_breakdown.py,
attention_ab.py), their timers (card_timing.py) and the module the
sequence-parallel tests' spawned ranks run (tests/torch_dist.py)
import nothing of JAX or of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tchvp_tpu"}
SOURCES = sorted((ROOT / "tchvp_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "fused_tail_breakdown.py", "window_fwd_breakdown.py",
                             "flash_fwd_breakdown.py", "attention_ab.py", "card_timing.py",
                             "tests/torch_dist.py")]


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
        "tchvp_tpu_torch.ops.tiling, tchvp_tpu_torch.kernels.fused_tail, "
        "tchvp_tpu_torch.parallel.mesh, tchvp_tpu_torch.parallel.collectives, "
        "tchvp_tpu_torch.data, tchvp_tpu_torch.data.clippack, tchvp_tpu_torch.data.manifest, "
        "tchvp_tpu_torch.data.device_prefetch, tchvp_tpu_torch.data.synthetic, "
        "tchvp_tpu_torch.data.pipeline, tchvp_tpu_torch.cli, tchvp_tpu_torch.train.checkpoint, "
        "tchvp_tpu_torch.train.loops, tchvp_tpu_torch.train.health, tchvp_tpu_torch.train.logging, "
        "tchvp_tpu_torch.utils, tchvp_tpu_torch.utils.runrecord, tchvp_tpu_torch.utils.profiling, "
        "tchvp_tpu_torch.utils.summary, tchvp_tpu_torch.utils.imaging, "
        "tchvp_tpu_torch.models.unet, tchvp_tpu_torch.models.autoencoder, "
        "tchvp_tpu_torch.models.combined, tchvp_tpu_torch.models.frame_ae, "
        "tchvp_tpu_torch.utils.torch_port; "
        "sys.path.insert(0, 'tests'); import torch_dist; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tchvp_tpu')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
