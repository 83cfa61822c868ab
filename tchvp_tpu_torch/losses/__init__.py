"""Losses and metrics over NHWC tensors, reducing in fp32.

Counterpart of ``tchvp_tpu/losses/__init__.py``: ``dice_loss``,
``jaccard_score``, ``mse``, ``psnr`` and ``mixed_loss`` (alpha *
(1 - MS-SSIM) + beta * MSE), with the same channel-0 handling.
"""

from __future__ import annotations

import torch

from tchvp_tpu_torch.ops.msssim import ms_ssim, ssim

__all__ = [
    "dice_loss",
    "jaccard_score",
    "psnr",
    "mse",
    "mixed_loss",
    "ms_ssim",
    "ssim",
]


def dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice loss on channel 0 (channels last)."""
    if y_pred.shape != y_true.shape:
        raise ValueError(f"shapes differ: {tuple(y_pred.shape)} vs {tuple(y_true.shape)}")
    p = y_pred[..., 0].reshape(-1).float()
    t = y_true[..., 0].reshape(-1).float()
    intersection = torch.sum(p * t)
    dsc = (2.0 * intersection + smooth) / (torch.sum(p) + torch.sum(t) + smooth)
    return 1.0 - dsc


def jaccard_score(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """IoU of the nonzero entries of channel 0."""
    if y_pred.shape != y_true.shape:
        raise ValueError(f"shapes differ: {tuple(y_pred.shape)} vs {tuple(y_true.shape)}")
    p = y_pred[..., 0].reshape(-1) != 0
    t = y_true[..., 0].reshape(-1) != 0
    intersection = torch.sum(t & p)
    union = torch.sum(t | p)
    return intersection.float() / union.float()


def mse(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    d = y_pred.float() - y_true.float()
    return torch.mean(d * d)


def psnr(reconstructed: torch.Tensor, original: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB."""
    return 20.0 * torch.log10(max_val / torch.sqrt(mse(reconstructed, original)))


def mixed_loss(
    y_pred: torch.Tensor, y_true: torch.Tensor, alpha: float = 0.5, beta: float = 0.5,
    *, data_range: float = 1.0,
) -> torch.Tensor:
    """alpha * (1 - MS-SSIM) + beta * MSE."""
    msssim_term = 1.0 - ms_ssim(y_pred, y_true, data_range=data_range)
    return alpha * msssim_term + beta * mse(y_pred, y_true)
