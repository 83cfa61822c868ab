"""Host-side image artifact dumps (survey §5.5 "eyeball evaluation").

A copy of ``tchvp_tpu/utils/imaging.py`` (numpy and PIL only).

Equivalents of the reference's sample-saving: per-epoch sneak-peek JPEGs
(``FCT.py:280-289``, AE_32K L194-215) and side-by-side input|prediction
stacks (``Model.py:128-132``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] (H,W,C) -> uint8; 1-channel squeezed to grayscale."""
    arr = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    arr = (arr * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def save_image(img: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


def save_sample_triplet(
    directory: str, epoch: int, x: np.ndarray, y: np.ndarray, y_pred: np.ndarray
) -> None:
    """input/actual/predicted JPEGs for the first batch element
    (FCT.py:280-289 naming)."""
    for name, img in zip(("input", "actual", "predicted"), (x, y, y_pred)):
        save_image(img[0], os.path.join(directory, f"{epoch}_{name}.jpg"))


def save_side_by_side(images: Sequence[np.ndarray], path: str) -> None:
    """Horizontally stacked panel (Model.py:128-132)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    panels = [Image.fromarray(to_uint8(i)).convert("RGB") for i in images]
    h = max(p.height for p in panels)
    w = sum(p.width for p in panels)
    out = Image.new("RGB", (w, h))
    x = 0
    for p in panels:
        out.paste(p, (x, 0))
        x += p.width
    out.save(path)
