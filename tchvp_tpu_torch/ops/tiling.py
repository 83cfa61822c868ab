"""Spatial frame tiling for the streaming high-resolution path.

Counterpart of ``tchvp_tpu/ops/tiling.py``: frames larger than the model's
operating point (1080p for BASELINE config 4) are edge-padded and cut into
square tiles, and each tile becomes an independent clip in the batch. Pure
indexing, reshapes and permutes, exact for every dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pad_frames(clip: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pad (B, T, H, W, C) so H and W are multiples of ``multiple``.

    Edge (replicate) padding keeps tile statistics natural at the frame
    border, unlike zero padding. Returns (padded clip, original (H, W)).
    """
    h, w = clip.shape[2], clip.shape[3]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        rows = torch.arange(h + ph, device=clip.device).clamp(max=h - 1)
        cols = torch.arange(w + pw, device=clip.device).clamp(max=w - 1)
        clip = clip.index_select(2, rows).index_select(3, cols)
    return clip, (h, w)


def tile_frames(clip: torch.Tensor, tile: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, T, H, W, C) -> (B*gh*gw, T, tile, tile, C) tile clips.

    H and W must be multiples of ``tile`` (:func:`pad_frames` first).
    Returns (tiles, (gh, gw)); the tiles of one source clip are contiguous
    in the batch dim, row-major over the grid.
    """
    b, t, h, w, c = clip.shape
    if h % tile or w % tile:
        raise ValueError(f"frame {h}x{w} not a multiple of tile {tile}")
    gh, gw = h // tile, w // tile
    x = clip.reshape(b, t, gh, tile, gw, tile, c).permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(b * gh * gw, t, tile, tile, c), (gh, gw)


def untile_frames(tiles: torch.Tensor, grid: Tuple[int, int],
                  orig_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverse of :func:`tile_frames`; optionally crop back to ``orig_hw``."""
    gh, gw = grid
    bt, t, th, tw, c = tiles.shape
    b = bt // (gh * gw)
    x = tiles.reshape(b, gh, gw, t, th, tw, c).permute(0, 3, 1, 4, 2, 5, 6)
    out = x.reshape(b, t, gh * th, gw * tw, c)
    if orig_hw is not None:
        out = out[:, :, : orig_hw[0], : orig_hw[1], :]
    return out
