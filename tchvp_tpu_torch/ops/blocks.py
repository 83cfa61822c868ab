"""Conv building blocks: BatchNorm, the ResNet Bottleneck, the polyphase
upconv, the biased layers of mixed precision, and the blocks of the conv
families (UNet's double conv, the AutoEncoder's encoder, decoder and
deep-supervision blocks).

Counterparts of ``tchvp_tpu/ops/blocks.py``'s ``BatchNorm``, ``Bottleneck``,
``PixelShuffleUpconv``, ``ConvBNReLUBlock``, ``_conv3x3``,
``EncoderBlock``, ``DecoderBlock`` and ``DeepSupervisionBlock``, NCHW,
with flax's module names. flax's BatchNorm momentum 0.9 is torch's
0.1; eps is 1e-5 in both. In train mode flax normalises with the biased
batch variance and updates the running variance with the biased one too,
where torch's own BatchNorm2d would update it with the unbiased one; the
port's :class:`BatchNorm` does what flax does.

Under ``torch.autocast`` (a model's ``compute_dtype``) the biased layers
:class:`Dense`, :class:`Conv2d` and :class:`ConvTranspose2d` round as
flax's ``Dense``/``Conv``/``ConvTranspose(dtype=bfloat16)`` do: the
product in the compute dtype, then the bias added in it. torch's own fuse
the bias into the product's one rounding. Outside autocast they are
torch's layers.

:class:`Conv2d` (and its subclasses) and :class:`Dense` consult one
context-local hook first (:func:`conv_hook`), the counterpart of the flax
method interceptor that the JAX package's int8 engine and QAT install
around ``nn.Conv``/``nn.Dense`` calls; ``ConvTranspose2d`` does not, as
flax's ``nn.ConvTranspose`` is not intercepted there.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tchvp_tpu_torch.ops.basic import max_pool_2x2, upsample2x_nearest
from tchvp_tpu_torch.parallel.collectives import all_reduce_sum
from tchvp_tpu_torch.parallel.mesh import axis_group, mesh_with_axis


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5, momentum 0.1) with flax's train-mode update.

    Train mode normalises with the batch mean and biased variance and moves
    the running stats toward them: ``r = 0.9 * r + 0.1 * batch``. While
    ``freeze_stats`` is set (:func:`frozen_batch_stats`) train mode updates
    nothing: the recompute of a checkpointed forward must not move the
    stats a second time.

    ``seq_axis`` (set by the model that owns the layer): while an ambient
    mesh carries it with size > 1, the batch is this rank's block of the
    frames, and train mode takes the statistics over the axis, as JAX's
    global arrays do under GSPMD: the sum and the count by one all-reduce,
    then the biased variance as a second all-reduced pass (the two-pass
    numerics of the single-process path). The all-reduces are
    differentiable, so the backward reduces too, and the running stats end
    with the same bits on every rank. Eval mode is untouched.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.freeze_stats = False
        self.seq_axis: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mesh = mesh_with_axis(self.seq_axis)
        if mesh is not None:
            out, mean, var = self._synced(x, axis_group(mesh, self.seq_axis))
        else:
            # One pass: the normalisation also returns the batch mean and
            # 1/sqrt(biased var + eps), from which the running stats move.
            out, mean, rstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                      True, 0.0, self.eps)
            with torch.no_grad():
                var = rstd.float().pow(-2) - self.eps
        if not self.freeze_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach().float(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach().float(), alpha=m)
                self.num_batches_tracked.add_(1)
        return out

    def _synced(self, x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(out, mean, biased var) with the statistics over ``group``, fp32."""
        xf = x.float()
        dims = (0, 2, 3)
        local = torch.cat([xf.sum(dims), xf.new_full((1,), float(xf.numel() // xf.shape[1]))])
        total = all_reduce_sum(local, group)
        mean = total[:-1] / total[-1]
        centered = xf - mean[None, :, None, None]
        var = all_reduce_sum((centered * centered).sum(dims), group) / total[-1]
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        out = centered * scale[None, :, None, None] + self.bias.float()[None, :, None, None]
        return out.to(x.dtype), mean, var


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Within the scope, train-mode :class:`BatchNorm` layers of ``module``
    leave their running stats alone."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.freeze_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.freeze_stats = False


def draw_keep(shape: Tuple[int, ...], rate: float, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """Bool keep mask (True = keep, P = 1 - rate) drawn from ``generator``
    on its own device, then moved to ``device``."""
    if generator is None:
        raise ValueError("active dropout requires a torch.Generator")
    return (torch.rand(shape, generator=generator, device=generator.device) >= rate).to(device)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shape: Optional[Tuple[int, ...]] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout whose keep mask, of ``shape`` (default: x's),
    broadcasts over x: ``keep`` when given (drawn beforehand), else drawn
    from ``generator``."""
    if keep is None:
        keep = draw_keep(shape or tuple(x.shape), rate, generator, x.device)
    return x * keep.to(x.dtype) / (1.0 - rate)


def _autocast(x: torch.Tensor) -> bool:
    return torch.is_autocast_enabled(x.device.type)


def _add_bias(y: torch.Tensor, bias: torch.Tensor, channel_dim: int) -> torch.Tensor:
    """``y + bias`` in y's dtype, the bias along ``channel_dim`` of y."""
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


# fn(next_fn, module, x) -> output, or None: the hook of conv_hook().
Hook = Callable[[Callable[[torch.Tensor], torch.Tensor], nn.Module, torch.Tensor], torch.Tensor]
_hook: contextvars.ContextVar[Optional[Hook]] = contextvars.ContextVar("tchvp_conv_hook", default=None)


@contextlib.contextmanager
def conv_hook(fn: Hook) -> Iterator[None]:
    """Within the scope (of this thread or task), every :class:`Conv2d` and
    :class:`Dense` call runs ``fn(next_fn, module, x)`` in place of its own
    forward ``next_fn(x)``; the scope replaces an outer one."""
    token = _hook.set(fn)
    try:
        yield
    finally:
        _hook.reset(token)


def with_current_hook(fn: Callable) -> Callable:
    """``fn`` run under the hook in scope now (or none), wherever it is
    called: the recompute of a checkpointed region runs in the backward,
    which on CUDA runs on the autograd engine's own thread, and a thread
    does not see another's :func:`conv_hook` scope."""
    hook = _hook.get()

    def run(*args):
        token = _hook.set(hook)
        try:
            return fn(*args)
        finally:
            _hook.reset(token)

    return run


class Dense(nn.Linear):
    """``nn.Linear``; under autocast, flax's two roundings (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hook = _hook.get()
        return self._fp_forward(x) if hook is None else hook(self._fp_forward, self, x)

    def _fp_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or not _autocast(x):
            return super().forward(x)
        return _add_bias(F.linear(x, self.weight), self.bias, -1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``; under autocast, flax's two roundings (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hook = _hook.get()
        return self._fp_forward(x) if hook is None else hook(self._fp_forward, self, x)

    def _fp_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or not _autocast(x):
            return super().forward(x)
        return _add_bias(self._conv_forward(x, self.weight, None), self.bias, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no ``output_size``); under autocast, flax's
    two roundings (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or not _autocast(x):
            return super().forward(x)
        y = F.conv_transpose2d(x, self.weight, None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return _add_bias(y, self.bias, 1)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
         bias: bool = False) -> nn.Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4: 1x1 -> 3x3(stride) -> 1x1(x4) convs
    with BN; optional 1x1-conv+BN downsample on the residual path.

    The 3x3 conv pads (1, 1) on both sides at stride 2 (XLA's SAME would
    pad (0, 1)); the 1x1 stride-2 downsample pads nothing.
    """

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, expansion: int = 4):
        super().__init__()
        out_ch = planes * expansion
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.downsample_conv: Optional[nn.Conv2d] = None
        self.downsample_bn: Optional[BatchNorm] = None
        if downsample:
            self.downsample_conv = conv(in_ch, out_ch, 1, stride=stride)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class ConvBNReLUBlock(nn.Module):
    """(conv3x3 without bias -> BatchNorm -> ReLU) x 2: UNet's block. The
    norms are ``norm1``/``norm2``, flax's BatchNorm wrapper one level up."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = conv(in_ch, features, 3, padding=1)
        self.norm1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, padding=1)
        self.norm2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        return torch.relu(self.norm2(self.conv2(x)))


def _conv3x3(in_ch: int, out_ch: int) -> nn.Conv2d:
    """3x3 SAME conv with a bias (stride 1: one pixel of padding a side)."""
    return conv(in_ch, out_ch, 3, padding=1, bias=True)


class EncoderBlock(nn.Module):
    """Multi-scale-input encoder block of the AutoEncoder.

    ``blk`` "first" or "bottleneck": conv1_a -> relu -> conv2 -> relu on x
    (``in_channels``). Otherwise the scaled image (``image_channels``) goes
    through conv1_b -> relu to ``in_channels`` and is concatenated before x
    (skip first), then conv2 -> relu -> conv3 -> relu. Both end in
    element-wise dropout (train mode, drawn from ``generator``) and a 2x2
    max pool."""

    def __init__(self, blk: str, in_channels: int, out_channels: int, dropout_rate: float = 0.3,
                 image_channels: int = 3):
        super().__init__()
        self.blk = blk
        self.dropout_rate = dropout_rate
        if blk in ("first", "bottleneck"):
            self.conv1_a = _conv3x3(in_channels, out_channels)
            self.conv2 = _conv3x3(out_channels, out_channels)
        else:
            self.conv1_b = _conv3x3(image_channels, in_channels)
            self.conv2 = _conv3x3(2 * in_channels, out_channels)
            self.conv3 = _conv3x3(out_channels, out_channels)

    def forward(self, x: torch.Tensor, scale_img: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.blk in ("first", "bottleneck"):
            x1 = torch.relu(self.conv2(torch.relu(self.conv1_a(x))))
        else:
            skip_x = torch.relu(self.conv1_b(scale_img))
            x1 = torch.relu(self.conv2(torch.cat([skip_x, x], dim=1)))
            x1 = torch.relu(self.conv3(x1))
        if self.training and self.dropout_rate > 0.0:
            x1 = dropout(x1, self.dropout_rate, generator)
        return max_pool_2x2(x1)


class DecoderBlock(nn.Module):
    """2x nearest upsample -> (conv3x3 -> relu) x 3 -> element-wise dropout."""

    def __init__(self, in_channels: int, out_channels: int, dropout_rate: float = 0.3):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.conv3 = _conv3x3(out_channels, out_channels)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x1 = torch.relu(self.conv1(upsample2x_nearest(x)))
        x1 = torch.relu(self.conv2(x1))
        x1 = torch.relu(self.conv3(x1))
        if self.training and self.dropout_rate > 0.0:
            x1 = dropout(x1, self.dropout_rate, generator)
        return x1


class DeepSupervisionBlock(nn.Module):
    """Output head: upsample -> (conv3x3 -> relu) x 2 -> conv3x3 -> the
    final activation, "relu" (the AutoEncoder's, as the reference has it)
    or "sigmoid"."""

    def __init__(self, in_channels: int, out_channels: int, final_activation: str = "relu"):
        super().__init__()
        if final_activation not in ("relu", "sigmoid"):
            raise ValueError(f"final_activation must be relu|sigmoid, got {final_activation!r}")
        self.final_activation = final_activation
        self.conv1 = _conv3x3(in_channels, in_channels)
        self.conv2 = _conv3x3(in_channels, in_channels)
        self.conv3 = _conv3x3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = torch.relu(self.conv1(upsample2x_nearest(x)))
        out = self.conv3(torch.relu(self.conv2(x1)))
        return torch.sigmoid(out) if self.final_activation == "sigmoid" else torch.relu(out)


def polyphase_weight(weight: torch.Tensor) -> torch.Tensor:
    """A ``ConvTranspose2d(c, f, 2, stride=2)`` weight (C, F, 2, 2) as the
    (C, 4F) matrix of the polyphase identity, columns in (di, dj, f) order:
    out[2i+di, 2j+dj, f] = sum_c x[i, j, c] * w[c, (di, dj, f)] + b[f].
    torch's kernel needs no flip here (flax's does: ``convert.py``)."""
    c, f = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(c, 4 * f)


class PixelShuffleUpconv(nn.Module):
    """``nn.ConvTranspose2d(c, f, 2, stride=2)`` computed as one (C -> 4F)
    matmul at the low resolution plus depth-to-space, NCHW.

    The taps of a 2x2 stride-2 transposed conv do not overlap, so the two
    are the same function (:func:`polyphase_weight`). The parameters are
    the transposed conv's, ``weight`` (C, F, 2, 2) and ``bias`` (F,), so
    its state_dict entries interchange with it. No model uses it, as in
    the JAX package.
    """

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        ref = nn.ConvTranspose2d(in_ch, features, 2, stride=2)
        self.weight = ref.weight
        self.bias = ref.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        f = self.weight.shape[1]
        y = x.permute(0, 2, 3, 1) @ polyphase_weight(self.weight).to(x.dtype)  # (N, H, W, 4F)
        y = y.reshape(n, h, w, 2, 2, f).permute(0, 5, 1, 3, 2, 4).reshape(n, f, 2 * h, 2 * w)
        return y + self.bias.to(x.dtype)[:, None, None]


def init_flax_default(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise like flax's defaults, from ``generator``: conv, transposed
    conv and linear weights lecun-normal (truncated at 2 sigma, fan-in over
    input channels x kernel taps), biases zero, norm scales one and shifts
    zero, BN running stats (0, 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
    return module
