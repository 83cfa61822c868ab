"""Experiment run records: ``run.json`` beside every training command's
checkpoints.

Counterpart of ``tchvp_tpu/utils/runrecord.py``: the fully resolved flags
(after ``--config`` YAML merging), the environment (torch and CUDA
versions, the device, rank and world size, the git revision) and the
launch argv, enough to re-run the experiment or audit an old checkpoint
directory. Only rank 0 writes it.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


def _git_revision() -> Optional[str]:
    """Best-effort `git rev-parse HEAD` of the working directory."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def _rank_world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collect_run_record(
    args: Any = None, extra: Optional[Dict[str, Any]] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """Assemble the record without writing it. ``device``: the device the
    command runs on (default: ``args.device``, else the CPU)."""
    resolved = {}
    if args is not None:
        resolved = {
            k: _jsonable(v)
            for k, v in sorted(vars(args).items())
            if not callable(v) and k != "fn"
        }
    if device is None:
        device = torch.device(getattr(args, "device", None) or "cpu")
    device = torch.device(device)
    rank, world = _rank_world()
    record: Dict[str, Any] = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "argv": list(sys.argv),
        "resolved_args": resolved,
        "environment": {
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": str(device),
            "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
            "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
            "rank": rank,
            "world_size": world,
            "python": sys.version.split()[0],
        },
        "git_revision": _git_revision(),
    }
    if extra:
        record.update(_jsonable(extra))
    return record


def write_run_record(
    checkpoint_dir: str,
    args: Any = None,
    extra: Optional[Dict[str, Any]] = None,
    device: Optional[torch.device] = None,
) -> str:
    """Write ``run.json`` into ``checkpoint_dir`` (created if needed).

    Only rank 0 writes under a multi-process launch. Returns the path
    (even when a non-zero rank skipped the write)."""
    path = os.path.join(checkpoint_dir, "run.json")
    if _rank_world()[0] != 0:
        return path
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(collect_run_record(args, extra, device), f, indent=2)
        f.write("\n")
    return path
