"""int8 post-training-quantized inference (the serving path).

Counterpart of ``tchvp_tpu/infer/quant.py``, with its names and its
scheme (standard symmetric PTQ):

* weights: per-output-channel int8, ``s_w = max|W[oc]| / 127`` over every
  dim but the output one (dim 0 of a conv's OIHW and of a ``Dense``'s
  (out, in)), 1.0 where that is 0, quantized once
  (:func:`quantize_conv_params`);
* activations: per-tensor int8 with STATIC scales, ``max|x| / 127`` over
  calibration batches (:func:`calibrate_conv_scales`), 1.0 for an all-zero
  input;
* each product accumulates exactly in int32 (``torch._int_mm``, cuBLASLt's
  int8 GEMM on a card; a conv goes through an im2col of its int8 input, a
  grouped conv through an int32 multiply-sum), is dequantized with
  ``s_x * s_w[oc]``, gets the fp32 bias and is rounded once to the layer's
  output dtype. BatchNorm, ReLU, attention and upsampling stay as they are.

The JAX package replaces ``nn.Conv`` (and, with ``dense=True``,
``nn.Dense``) calls through flax's method interceptor. Here the port's own
:class:`~tchvp_tpu_torch.ops.blocks.Conv2d` (and its subclass
``PaddedConv2d``) and :class:`~tchvp_tpu_torch.ops.blocks.Dense` consult
one context-local hook (``ops.blocks.conv_hook``), so the same layers are
quantized: not ``ConvTranspose2d``, ``PixelShuffleUpconv`` or the fixed
``F.conv2d`` filters of ``ops/sobel.py`` and ``ops/msssim.py``. Layers are
named by the port's module names (``model.named_modules()``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tchvp_tpu_torch.ops.blocks import Conv2d, Dense, conv_hook

QParams = Dict[str, Dict[str, torch.Tensor]]

# Elements of one im2col chunk: the rows of a conv's int8 product run in
# chunks of output rows so that no chunk holds more (a decoder conv at
# config 1's shape would unfold past 2**31 elements at once).
_CHUNK_ELEMENTS = 1 << 28


def module_names(model: nn.Module) -> Dict[nn.Module, str]:
    """Each submodule of ``model`` -> its name, the keys of the scales."""
    return {m: name for name, m in model.named_modules()}


def _is_conv(module: nn.Module) -> bool:
    return isinstance(module, Conv2d)


def _is_dense(module: nn.Module) -> bool:
    return isinstance(module, Dense)


@contextlib.contextmanager
def _conv_interceptor(fn: Callable, dense: bool = False) -> Iterator[None]:
    """Route every ``Conv2d`` call (and ``Dense`` when ``dense``) through
    ``fn(next_fn, module, x)``."""

    def hook(next_fn, module, x):
        if _is_conv(module) or (dense and _is_dense(module)):
            return fn(next_fn, module, x)
        return next_fn(x)

    with conv_hook(hook):
        yield


def _eval_call(model: nn.Module, fn: Callable[[], Any]) -> Any:
    """``fn()`` with ``model`` in eval mode under no_grad; the mode is given
    back afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return fn()
    finally:
        model.train(was_training)


def calibrate_conv_scales(
    model: nn.Module,
    apply_fn: Callable[[Any], Any],
    batches: Iterable[Any],
    dense: bool = False,
) -> Dict[str, float]:
    """Run ``apply_fn(batch)`` (eval mode, no grad) over calibration
    batches, recording each ``Conv2d`` (and, with ``dense=True``,
    ``Dense``) input's max|x| under its name in ``model``; the max over
    repeated calls of one module. Returns name -> ``max / 127`` (1.0 for
    a zero max), the division in Python float64 as the JAX package's."""
    names = module_names(model)
    maxima: Dict[str, float] = {}

    def record(next_fn, module, x):
        m = float(x.float().abs().max())
        key = names[module]
        maxima[key] = max(maxima.get(key, 0.0), m)
        return next_fn(x)

    for batch in batches:
        with _conv_interceptor(record, dense=dense):
            _eval_call(model, lambda: apply_fn(batch))
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in maxima.items()}


def quantize_conv_params(model: nn.Module, paths: Sequence[str]) -> QParams:
    """Per-output-channel int8 weights of the layers at ``paths``.

    Returns name -> {"w_i8" (the weight's layout: OIHW, or (out, in) for
    ``Dense``) int8, "s_w" (out,) fp32, "bias" (out,) fp32 or absent}."""
    out: QParams = {}
    for path in paths:
        module = model.get_submodule(path)
        with torch.no_grad():
            w = module.weight.detach().float()
            s_w = w.abs().amax(dim=tuple(range(1, w.dim()))) / 127.0
            s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
            shape = (-1,) + (1,) * (w.dim() - 1)
            q = {"w_i8": torch.clamp(torch.round(w / s_w.reshape(shape)), -127, 127).to(torch.int8),
                 "s_w": s_w}
            if module.bias is not None:
                q["bias"] = module.bias.detach().float()
        out[path] = q
    return out


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the fp layer would return: the autocast dtype inside an
    autocast scope (a ``compute_dtype`` model), else x's."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def _scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-dim fp32 tensor of ``value``: dividing by it is a true division
    on every device (a Python scalar divisor is multiplied by its
    reciprocal on a card)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mm_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 (M, N) = a (M, K) @ b (K, N), int8, K and N multiples
    of 8. ``torch._int_mm`` on a card takes only M > 16: fewer rows get
    zero rows, which are dropped after."""
    m = a.shape[0]
    if m <= 16:
        return torch._int_mm(torch.cat([a, a.new_zeros((17 - m, a.shape[1]))]), b)[:m]
    return torch._int_mm(a, b)


def _weight_matrix(w_i8: torch.Tensor, k_pad: int) -> torch.Tensor:
    """(K_pad, N_pad) int8: the (out, K) weight rows zero-padded to
    K_pad and to a multiple of 8 outputs, transposed."""
    o = w_i8.shape[0]
    w = w_i8.reshape(o, -1)
    w = F.pad(w, (0, k_pad - w.shape[1], 0, _round_up(o, 8) - o))
    return w.t()


def _dequantize(acc: torch.Tensor, q: Dict[str, torch.Tensor], s_x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    out = acc.float() * (q["s_w"] * s_x)
    if "bias" in q:
        out = out + q["bias"]
    return out.to(dtype)


def _conv_taps(buf: torch.Tensor, r0: int, rows: int, wo: int, module) -> torch.Tensor:
    """(N, rows, Wo, C, kh * kw) int8: the im2col of output rows [r0, r0 +
    rows) from the padded NHWC input ``buf``, taps in the weight's (i, j)
    order."""
    (kh, kw), (sh, sw), (dh, dw) = module.kernel_size, module.stride, module.dilation
    taps = []
    for i in range(kh):
        top = r0 * sh + i * dh
        for j in range(kw):
            left = j * dw
            taps.append(buf[:, top:top + (rows - 1) * sh + 1:sh, left:left + (wo - 1) * sw + 1:sw])
    return torch.stack(taps, dim=-1)


class _Geometry(NamedTuple):
    """A conv's kernel_size, stride, padding, dilation (pairs) and groups,
    as ``nn.Conv2d`` holds them."""

    kernel_size: Tuple[int, int]
    stride: Tuple[int, int]
    padding: Tuple[int, int]
    dilation: Tuple[int, int]
    groups: int


def _conv_geometry(module, h: int, w: int) -> Tuple[int, int]:
    """(Ho, Wo) of a conv (``nn.Conv2d`` or a :class:`_Geometry`)."""
    (kh, kw), (sh, sw), (dh, dw) = module.kernel_size, module.stride, module.dilation
    ph, pw = module.padding
    return (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1, (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1


def conv_accumulators(module, x: torch.Tensor, w_i8: torch.Tensor,
                      s_x: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
    """The exact int32 accumulators of a ``Conv2d`` on x (N, C, H, W)
    quantized by ``s_x`` (a 0-dim fp32 tensor) and its int8 OIHW weight,
    by chunks of output rows: yields (rows, (N * rows * Wo, O) int32), the
    rows in (n, row, col) order. Stride, padding, dilation and groups
    carry over (``module``: an ``nn.Conv2d`` or a :class:`_Geometry`)."""
    n, c, h, w = x.shape
    (kh, kw) = module.kernel_size
    ph, pw = module.padding
    groups = module.groups
    ho, wo = _conv_geometry(module, h, w)
    o = w_i8.shape[0]
    taps = kh * kw
    # Channels padded with zeros to a multiple of 8 (K = C' * taps then is
    # one, as the card's int8 GEMM needs); exact, as the weights get zero
    # input channels too. A grouped conv keeps its channels.
    cp = c if groups > 1 else _round_up(c, 8)
    budget = _CHUNK_ELEMENTS // max(n, 1)
    # The padded NHWC int8 input, quantized a few rows at a time.
    buf = x.new_zeros((n, h + 2 * ph, w + 2 * pw, cp), dtype=torch.int8)
    step = max(1, budget // max(1, c * w * 4))
    for r in range(0, h, step):
        buf[:, ph + r:ph + min(h, r + step), pw:pw + w, :c] = _quantize_act(
            x[:, :, r:r + step], s_x).permute(0, 2, 3, 1)
    if groups == 1:
        wmat = _weight_matrix(F.pad(w_i8, (0, 0, 0, 0, 0, cp - c)), cp * taps)
        per_row = wo * cp * taps
    else:
        # (1, G, O/G, C/G * taps) int32 weights of the grouped multiply-sum.
        wg = w_i8.reshape(groups, o // groups, -1).to(torch.int32)[None]
        per_row = wo * cp * taps * 4 * (o // groups)
    rows = max(1, min(ho, budget // max(1, per_row)))
    for r0 in range(0, ho, rows):
        nr = min(rows, ho - r0)
        cols = _conv_taps(buf, r0, nr, wo, module)  # (N, nr, Wo, C', taps)
        if groups == 1:
            yield nr, _mm_i8(cols.reshape(-1, cp * taps), wmat)[:, :o]
        else:
            cols = cols.reshape(-1, groups, 1, (c // groups) * taps).to(torch.int32)
            yield nr, (cols * wg).sum(dim=-1, dtype=torch.int32).reshape(-1, o)


# The int8 layers are torch.library custom ops (one implementation for
# every device, of the torch ops above): an exported program then holds one
# node per layer, with its scales as constants, and the rows of a conv are
# chunked at the batch it is given when it runs.
@torch.library.custom_op("tchvp::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor, bias: Optional[torch.Tensor],
                  s_x: float, stride: List[int], padding: List[int], dilation: List[int], groups: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    geometry = _Geometry(tuple(w_i8.shape[2:]), tuple(stride), tuple(padding), tuple(dilation), groups)
    s = _scalar(s_x, x.device)
    q = {"s_w": s_w} if bias is None else {"s_w": s_w, "bias": bias}
    n, wo, o = x.shape[0], _conv_geometry(geometry, x.shape[2], x.shape[3])[1], w_i8.shape[0]
    outs = [_dequantize(acc, q, s, out_dtype).reshape(n, nr, wo, o)
            for nr, acc in conv_accumulators(geometry, x, w_i8, s)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.permute(0, 3, 1, 2)


@_int8_conv_op.register_fake
def _int8_conv_fake(x, w_i8, s_w, bias, s_x, stride, padding, dilation, groups, out_dtype):
    geometry = _Geometry(tuple(w_i8.shape[2:]), tuple(stride), tuple(padding), tuple(dilation), groups)
    ho, wo = _conv_geometry(geometry, x.shape[2], x.shape[3])
    return x.new_empty((x.shape[0], ho, wo, w_i8.shape[0]), dtype=out_dtype).permute(0, 3, 1, 2)


def _int8_conv(module: nn.Conv2d, x: torch.Tensor, q: Dict[str, torch.Tensor],
               s_x: float) -> torch.Tensor:
    """The quantized replacement for one ``Conv2d`` call: x (N, C, H, W)
    -> (N, O, Ho, Wo) in the layer's output dtype (the NCHW view of an NHWC
    tensor), dequantized chunk by chunk (``tchvp::int8_conv``)."""
    return torch.ops.tchvp.int8_conv(x, q["w_i8"], q["s_w"], q.get("bias"), float(s_x), list(module.stride),
                                     list(module.padding), list(module.dilation), module.groups,
                                     _out_dtype(x))


def dense_accumulator(x: torch.Tensor, w_i8: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """The exact int32 (rows, out) accumulator of a ``Dense`` on x (...,
    in) quantized by ``s_x`` and its int8 (out, in) weight."""
    k = x.shape[-1]
    xq = _quantize_act(x.reshape(-1, k), s_x)
    kp = _round_up(k, 8)
    if kp != k:
        xq = F.pad(xq, (0, kp - k))
    return _mm_i8(xq, _weight_matrix(w_i8, kp))[:, :w_i8.shape[0]]


@torch.library.custom_op("tchvp::int8_dense", mutates_args=())
def _int8_dense_op(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor, bias: Optional[torch.Tensor],
                   s_x: float, out_dtype: torch.dtype) -> torch.Tensor:
    s = _scalar(s_x, x.device)
    q = {"s_w": s_w} if bias is None else {"s_w": s_w, "bias": bias}
    out = _dequantize(dense_accumulator(x, w_i8, s), q, s, out_dtype)
    return out.reshape(*x.shape[:-1], w_i8.shape[0])


@_int8_dense_op.register_fake
def _int8_dense_fake(x, w_i8, s_w, bias, s_x, out_dtype):
    return x.new_empty((*x.shape[:-1], w_i8.shape[0]), dtype=out_dtype)


def _int8_dense(module: nn.Linear, x: torch.Tensor, q: Dict[str, torch.Tensor],
                s_x: float) -> torch.Tensor:
    """The quantized replacement for one ``Dense`` call: (..., in) ->
    (..., out) in the layer's output dtype (``tchvp::int8_dense``)."""
    return torch.ops.tchvp.int8_dense(x, q["w_i8"], q["s_w"], q.get("bias"), float(s_x), _out_dtype(x))


def _last(out: Any) -> torch.Tensor:
    return out[-1] if isinstance(out, (tuple, list)) else out


class Int8Engine:
    """Calibrate-once, serve-many int8 inference over a model that holds
    its weights.

    >>> eng = Int8Engine(model).calibrate([batch1, batch2])
    >>> out = eng.apply(eng.qparams, clip)

    ``apply_fn(batch)`` is how a batch goes through the model (default
    ``model(batch)``); it runs in eval mode without gradients.
    ``exclude``: name substrings of layers kept in their dtype.
    ``quantize_dense``: also quantize ``Dense`` layers (attention
    projections, FFNs).
    """

    def __init__(self, model: nn.Module, exclude: Sequence[str] = (),
                 apply_fn: Optional[Callable[[Any], Any]] = None,
                 quantize_dense: bool = False):
        self.model = model
        self.exclude = tuple(exclude)
        self.quantize_dense = quantize_dense
        self.apply_fn = apply_fn if apply_fn is not None else model
        self.scales: Optional[Dict[str, float]] = None
        self.qparams: Optional[QParams] = None
        self._names = module_names(model)

    def _apply_fp(self, batch):
        return _eval_call(self.model, lambda: self.apply_fn(batch))

    def calibrate(self, batches: Iterable[Any]) -> "Int8Engine":
        scales = calibrate_conv_scales(self.model, self.apply_fn, batches,
                                       dense=self.quantize_dense)
        self.scales = {k: v for k, v in scales.items()
                       if not any(e in k for e in self.exclude)}
        self.qparams = quantize_conv_params(self.model, sorted(self.scales))
        return self

    @contextlib.contextmanager
    def intercepting(self, qparams: QParams) -> Iterator[None]:
        """Within the scope, the calibrated layers of ``self.model`` run
        int8 with ``qparams``, whatever code applies the model
        (``stream_video``, ``microbatched_infer``, an exported program's
        trace)."""
        if self.scales is None:
            raise ValueError("engine is not calibrated (call calibrate() first)")
        scales, names = self.scales, self._names

        def quant_conv(next_fn, module, x):
            key = names.get(module)
            if key in scales:
                if _is_dense(module):
                    return _int8_dense(module, x, qparams[key], scales[key])
                return _int8_conv(module, x, qparams[key], scales[key])
            return next_fn(x)

        with _conv_interceptor(quant_conv, dense=self.quantize_dense):
            yield

    def apply(self, qparams: QParams, batch) -> Any:
        """The int8 forward of ``batch`` (eval mode, no gradients)."""
        with self.intercepting(qparams):
            return self._apply_fp(batch)

    def psnr_vs(self, batch) -> float:
        """Reconstruction PSNR of the int8 output against the model's own
        dtype's output on ``batch``, in dB (the last output of a tuple)."""
        ref = _last(self._apply_fp(batch)).float()
        got = _last(self.apply(self.qparams, batch)).float()
        mse = float(torch.mean((ref - got) ** 2))
        rng = float(ref.max() - ref.min())
        return 20.0 * math.log10(max(rng, 1e-9)) - 10.0 * math.log10(max(mse, 1e-12))
