"""Layout helpers: time folding and the NHWC <-> NCHW boundary.

The port keeps the JAX package's public layouts (clips ``(B, T, H, W, C)``)
and runs its convolutions NCHW on cuDNN; these helpers convert at the
boundary.
"""

from __future__ import annotations

import torch


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C)."""
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W)."""
    return x.permute(0, 3, 1, 2)


def ncthw_to_nthwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T, H, W, C)."""
    return x.permute(0, 2, 3, 4, 1)


def ntchw_to_nthwc(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T, H, W, C)."""
    return x.permute(0, 1, 3, 4, 2)


def nthwc_to_ntchw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, C, H, W)."""
    return x.permute(0, 1, 4, 2, 3)


def fold_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...): fold clip frames into the batch."""
    b, t = x.shape[0], x.shape[1]
    return x.reshape((b * t,) + tuple(x.shape[2:]))


def unfold_time(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, ...) -> (B, T, ...)."""
    t = x.shape[0] // batch
    return x.reshape((batch, t) + tuple(x.shape[1:]))
