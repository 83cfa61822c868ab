"""Model summaries (the reference's torchsummary usage: recovered
``segmentationUNet.py`` import, commented ``FCT.py:258-262``).

Counterpart of ``tchvp_tpu/utils/summary.py``. The JAX package tabulates
a flax module by tracing it; an ``nn.Module`` holds its parameters, so the
table here is read from the module tree without running it: per
submodule, its class and parameter count, to a nesting ``depth``. The
counts are those of the flax parameter subtrees of the same config
(BatchNorm running stats are buffers here and ``batch_stats`` there, in
neither count).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.nn as nn

from tchvp_tpu_torch.train.state import human_param_count, param_count


def count_params(model: nn.Module) -> int:
    return param_count(model)


def submodule_param_counts(model: nn.Module) -> Dict[str, int]:
    """Parameter count of each top-level submodule, by name."""
    return {name: param_count(child) for name, child in model.named_children()}


def summarize(model: nn.Module, depth: Optional[int] = None) -> str:
    """Per-module table of class and parameter count. ``depth`` limits
    module nesting (torchsummary's flat view is depth=1); None shows
    every submodule."""
    rows = [("path", "module", "params")]
    for name, module in model.named_modules():
        level = name.count(".") + 1 if name else 0
        if depth is not None and level > depth:
            continue
        rows.append((name or "(root)", type(module).__name__, f"{param_count(module):,}"))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = [f"{r[0]:<{widths[0]}}  {r[1]:<{widths[1]}}  {r[2]:>{widths[2]}}" for r in rows]
    lines.insert(1, "-" * len(lines[0]))
    return "\n".join(lines)


def describe(model: nn.Module) -> str:
    """One-line description: class name + pretty param count."""
    n = count_params(model)
    return f"{type(model).__name__}: {human_param_count(n)} parameters ({n:,})"
