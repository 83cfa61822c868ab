"""Quantization-aware training (QAT): fake-int8 convs and denses in the
train step.

Counterpart of ``tchvp_tpu/train/qat.py``. The forward quantizes and
dequantizes every conv input and kernel with the arithmetic of the int8
serving engine (:mod:`tchvp_tpu_torch.infer.quant`: symmetric int8,
per-output-channel weight scales, per-tensor activation scales), while
gradients flow through the rounding by the straight-through estimator
(``x + (round(x) - x).detach()``). The fp32 master weights then train
against the int8-constrained loss, and the checkpoint serves through the
unchanged ``Int8Engine``.

* weights: ``max|W[oc]| / 127`` per output channel (dim 0 here), the
  engine's formula;
* activations: ``max|x| / 127`` per tensor, taken per batch in the step
  (the engine freezes the same statistic over calibration batches);
* the conv runs in fp32 on the fake-quantized values, which is the
  dequantized int32 result up to fp32 rounding, by bilinearity;
* bias, BatchNorm and ReLU stay fp.

:func:`fake_quant` is one autograd Function with JAX's gradient: the STE
inside [-127, 127], half of it at a bound (``jnp.clip`` is a maximum and a
minimum, whose gradients split at a tie; ``torch.clamp`` would pass it
whole), none outside. It saves a one-byte code per element for the
backward where a composition of torch ops would keep several fp32
tensors: at the training cell (B 8 x 8 frames, 256^2) that composition
ran the card out of its 80 GB. Integration is the engine's hook
(``ops.blocks.conv_hook``): wrap the forward in :func:`qat_fake_quant`; a
remat policy's checkpointed regions take the hook into their recompute
(``ops.blocks.with_current_hook``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch
import torch.nn as nn

from tchvp_tpu_torch.infer.quant import _conv_interceptor, _is_dense, _out_dtype, module_names
from tchvp_tpu_torch.ops import dispatch_trace


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) in the forward, identity in the backward (STE)."""
    return x + (torch.round(x) - x).detach()


class _FakeQuant(torch.autograd.Function):
    """``clip(ste_round(x / s), -127, 127) * s`` and its gradient, in the
    order torch's autograd would take it: ``((g * s) * m) / s`` with m 1
    inside the range, 1/2 at a bound and 0 outside."""

    @staticmethod
    def forward(ctx, x, scale):
        u = torch.round(x / scale)
        a = u.abs()
        code = (a < 127).to(torch.int8) * 2 + (a == 127).to(torch.int8)  # 2 inside, 1 at a bound
        ctx.save_for_backward(code, scale)
        return torch.clamp(u, -127.0, 127.0) * scale

    @staticmethod
    def backward(ctx, g):
        code, scale = ctx.saved_tensors
        gs = g * scale
        gs = torch.where(code == 2, gs, torch.where(code == 1, gs / 2, torch.zeros_like(gs)))
        return gs / scale, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize with an STE backward. ``scale``
    broadcasts against x (a scalar for activations, per output channel for
    kernels) and carries no gradient."""
    return _FakeQuant.apply(x, scale.detach())


def _act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation scale max|x| / 127, 1.0 for an all-zero x."""
    m = x.abs().max()
    return torch.where(m > 0, m, torch.full_like(m, 127.0)) / 127.0


def _kernel_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel kernel scale, shaped to broadcast over w (the
    engine's formula, ``infer/quant.py::quantize_conv_params``)."""
    s = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True) / 127.0
    return torch.where(s > 0, s, torch.ones_like(s))


def _fq_weight_input(module: nn.Module, x: torch.Tensor):
    w = module.weight.float()
    x32 = x.float()
    return fake_quant(x32, _act_scale(x32)), fake_quant(w, _kernel_scale(w))


def _fq_conv(module: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """One ``Conv2d`` call on fake-quantized input and kernel, in fp32."""
    dispatch_trace.record("qat_fake_quant")
    dtype = _out_dtype(x)
    with torch.autocast(x.device.type, enabled=False):
        xq, wq = _fq_weight_input(module, x)
        out = module._conv_forward(xq, wq, None)
        if module.bias is not None:
            out = out + module.bias.float()[None, :, None, None]
    return out.to(dtype)


def _fq_dense(module: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """One ``Dense`` call on fake-quantized input and kernel, in fp32."""
    dispatch_trace.record("qat_fake_quant_dense")
    dtype = _out_dtype(x)
    with torch.autocast(x.device.type, enabled=False):
        xq, wq = _fq_weight_input(module, x)
        out = torch.nn.functional.linear(xq, wq)
        if module.bias is not None:
            out = out + module.bias.float()
    return out.to(dtype)


@contextlib.contextmanager
def qat_fake_quant(dense: bool = False, exclude: Sequence[str] = (),
                   model: Optional[nn.Module] = None) -> Iterator[None]:
    """Within the scope, every ``Conv2d`` (and ``Dense`` when ``dense``)
    call runs on fake-quantized input and kernel with STE gradients.

    ``exclude``: name substrings of layers kept in fp (as
    ``Int8Engine(exclude=...)``); the names are ``model``'s, which must be
    given with it."""
    exclude = tuple(exclude)
    if exclude and model is None:
        raise ValueError("qat_fake_quant(exclude=...) names layers by a model's module names: pass model")
    names = module_names(model) if exclude else {}

    def fq(next_fn, module, x):
        if exclude and any(e in names.get(module, "") for e in exclude):
            return next_fn(x)
        if _is_dense(module):
            return _fq_dense(module, x)
        return _fq_conv(module, x)

    with _conv_interceptor(fq, dense=dense):
        yield
