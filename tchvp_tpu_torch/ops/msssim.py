"""SSIM and MS-SSIM over NHWC images, in plain PyTorch.

Counterpart of ``tchvp_tpu/ops/msssim.py``, with its algorithm and its
details: an 11-tap Gaussian window (sigma 1.5) built in float64 and cast
to float32, K1 0.01 and K2 0.03, a VALID separable depthwise blur, 5
scales weighted (0.0448, 0.2856, 0.3001, 0.2363, 0.1333) with ReLU'd
contrast-structure terms, and a 2x2 average pool that pads an odd side with
zeros at the top/left only and counts them in the mean. Inputs and outputs
keep the JAX package's NHWC layout; the blur runs as NCHW grouped convs.
``data_range`` defaults to the correct 1.0 for [0, 1] images.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur, VALID padding, NCHW: rows, then
    columns, as the JAX package filters H then W."""
    c, size = x.shape[1], window.shape[0]
    x = F.conv2d(x, window.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    return F.conv2d(x, window.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)


def _ssim_per_channel(
    x: torch.Tensor, y: torch.Tensor, window: torch.Tensor, data_range: float,
    k1: float = 0.01, k2: float = 0.03,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW fp32 -> (ssim, cs), each (B, C): spatial means of the maps. The
    five blurred maps (x, y, x^2, y^2, xy) go through one grouped conv."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    c = x.shape[1]
    blurred = _blur(torch.cat([x, y, x * x, y * y, x * y], dim=1), window)
    mu_x, mu_y, e_xx, e_yy, e_xy = blurred.split(c, dim=1)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = e_xx - mu_xx
    sigma_y = e_yy - mu_yy
    sigma_xy = e_xy - mu_xy
    cs_map = (2.0 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _nchw_f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over batch and channels; x, y are NHWC in [0, data_range]."""
    window = torch.from_numpy(_gaussian_window(window_size, sigma)).to(x.device)
    s, _ = _ssim_per_channel(_nchw_f32(x), _nchw_f32(y), window, data_range)
    return s.mean()


def ms_ssim(
    x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0,
    window_size: int = 11, sigma: float = 1.5, weights: Sequence[float] = _MS_WEIGHTS,
) -> torch.Tensor:
    """Multi-scale SSIM over NHWC images. Spatial dims must be larger than
    ``(window_size - 1) * 2**(len(weights) - 1)``."""
    min_side = (window_size - 1) * 2 ** (len(weights) - 1)
    if min(x.shape[1], x.shape[2]) <= min_side:
        raise ValueError(
            f"ms_ssim needs spatial dims > {min_side} for {len(weights)} scales "
            f"with window {window_size}; got {x.shape[1]}x{x.shape[2]}"
        )
    x, y = _nchw_f32(x), _nchw_f32(y)
    window = torch.from_numpy(_gaussian_window(window_size, sigma)).to(x.device)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)

    mcs = []
    ssim_val = None
    for i in range(len(weights)):
        ssim_val, cs = _ssim_per_channel(x, y, window, data_range)
        if i < len(weights) - 1:
            mcs.append(torch.relu(cs))
            x = _avg_pool2_nchw(x)
            y = _avg_pool2_nchw(y)
    stack = torch.stack(mcs + [torch.relu(ssim_val)], dim=0)  # (scales, B, C)
    return torch.prod(stack ** w.view(-1, 1, 1), dim=0).mean()


def _avg_pool2_nchw(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    if h % 2 or w % 2:
        x = F.pad(x, (w % 2, 0, h % 2, 0))  # zeros at the left and top only
    return F.avg_pool2d(x, 2, 2)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool of NHWC ``x``; an odd side gets one zero row or
    column at the top/left, counted in its window's mean."""
    return _avg_pool2_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
