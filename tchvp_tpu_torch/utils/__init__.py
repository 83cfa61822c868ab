"""Utilities: image artifact dumps, profiling hooks, model summaries and
run records. Exports what ``tchvp_tpu/utils/__init__.py`` exports, less
the XLA compile cache, which has no counterpart here."""

from tchvp_tpu_torch.utils.imaging import (
    save_image,
    save_sample_triplet,
    save_side_by_side,
    to_uint8,
)
from tchvp_tpu_torch.utils.profiling import StepTimer, annotate, trace
from tchvp_tpu_torch.utils.summary import count_params, describe, summarize

__all__ = [
    "count_params",
    "describe",
    "summarize",
    "save_image",
    "save_sample_triplet",
    "save_side_by_side",
    "to_uint8",
    "StepTimer",
    "annotate",
    "trace",
]
