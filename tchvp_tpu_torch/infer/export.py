"""Ahead-of-time serving artifacts through ``torch.export``.

Counterpart of ``tchvp_tpu/infer/export.py`` (which ships ``jax.export``'s
StableHLO). One artifact is one zip file:

* ``program.pt2``: ``torch.export.save`` of the ``ExportedProgram`` of
  ``fn(batch)``, uint8 preprocessing fused in front, the model's weights
  lifted to graph inputs (as JAX's ``fn(weights, batch)`` takes them) and
  saved beside the graph;
* ``meta.json``: ``artifact_version``, ``platforms`` (``["cuda"]`` or
  ``["cpu"]``), ``batch_aval``, ``out_avals`` and the caller's ``meta``, the
  record of the JAX package's.

The hand-written attention forwards are ``torch.library`` custom ops
(``tchvp.flash_fwd``, ``tchvp.band_fwd``; ``kernels/flash_attention.py``),
so a program exported on a card keeps them as nodes and runs the kernels
when it is served.

Batch-polymorphic by default: the batch dim is ``torch.export.Dim("b",
min=1)``. ``torch.export`` specializes a dim whose example size is 0 or 1,
so the example batch is 2 where JAX's is 1; ``symbolic_batch=False`` pins
a batch of 1, and other sizes are then refused. A program is exported on
the device it is to serve on (creation ops with an explicit device are
baked into the graph) and does not move: loading it for another platform
raises, as JAX's does. Data-parallel serving (``over_mesh``) is item 11 of
ROADMAP.md.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tchvp_tpu_torch.infer import quant  # noqa: F401 (registers the tchvp int8 ops)
from tchvp_tpu_torch.kernels import flash_attention  # noqa: F401 (registers the tchvp attention ops)

ARTIFACT_VERSION = 1
_PROGRAM_NAME = "program.pt2"
_META_NAME = "meta.json"
_JAX_FN_NAME = "fn.jaxexp"
_SYMBOLIC_EXAMPLE_BATCH = 2

_DTYPES = {"uint8": torch.uint8, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8, "int32": torch.int32, "int64": torch.int64}


class _Program(nn.Module):
    """``fn(*inputs)`` over ``model``, whose parameters and buffers the
    export lifts to graph inputs."""

    def __init__(self, model: nn.Module, fn: Callable[..., Any]):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *inputs):
        return self._fn(*inputs)


def _aval(t: torch.Tensor, batch: Optional[str] = None) -> str:
    """``dtype[d0,d1,...]`` as JAX prints an aval; dim 0 named ``batch``
    when it is symbolic."""
    dims = [batch if (i == 0 and batch) else str(int(d)) for i, d in enumerate(t.shape)]
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(dims)}]"


def _parse_aval(aval: str) -> Tuple[torch.dtype, Tuple[Optional[int], ...]]:
    m = re.fullmatch(r"(\w+)\[([^\]]*)\]", aval)
    if m is None or m[1] not in _DTYPES:
        raise ValueError(f"artifact aval {aval!r} is not dtype[dims]")
    dims = tuple(int(d) if d.isdigit() else None for d in filter(None, m[2].split(",")))
    return _DTYPES[m[1]], dims


def export_serving(
    fn: Callable[..., Any],
    model: nn.Module,
    example_inputs: Sequence[torch.Tensor],
    *,
    platforms: Optional[Sequence[str]] = None,
    symbolic_batch: bool = True,
) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Export ``fn(*inputs)``, a function over ``model`` (whose weights the
    program lifts), at ``example_inputs`` on their device. With
    ``symbolic_batch`` dim 0 of the last input (the batch) is symbolic.

    Returns ``(exported, record)``, the record holding the avals and the
    platform for :func:`save_artifact`. ``platforms`` may only name the
    example's device type: a program serves where it was exported."""
    device = example_inputs[-1].device
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(f"platforms {list(platforms)}: the program is exported on {device} and "
                         f"serves there only (export on the device it is to serve on)")
    program = _Program(model, fn).eval()
    dims = None
    if symbolic_batch:
        b = torch.export.Dim("b", min=1)
        # One entry: forward's ``*inputs``, a tuple of one spec per input.
        dims = (tuple({0: b} if i == len(example_inputs) - 1 else None
                      for i in range(len(example_inputs))),)
    with torch.no_grad():
        outs = program(*example_inputs)  # eager first: fills the model's caches with real tensors
        exported = torch.export.export(program, tuple(example_inputs), dynamic_shapes=dims, strict=False)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    n_in = len(example_inputs)
    record = {
        "platforms": [device.type],
        "in_avals": [_aval(t, "b" if symbolic_batch and i == n_in - 1 else None)
                     for i, t in enumerate(example_inputs)],
        "out_avals": [_aval(t, "b" if symbolic_batch and n_in == 1 else None) for t in outs],
    }
    record["batch_aval"] = record["in_avals"][-1]
    return exported, record


def save_artifact(path: str, exported: torch.export.ExportedProgram, record: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the serving zip (program + weights, metadata)."""
    full = {
        "artifact_version": ARTIFACT_VERSION,
        "platforms": record["platforms"],
        "batch_aval": record["batch_aval"],
        "in_avals": record["in_avals"],
        "out_avals": record["out_avals"],
        "meta": meta or {},
    }
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr(_PROGRAM_NAME, buf.getvalue())
        z.writestr(_META_NAME, json.dumps(full, indent=2))


def _to_device_input(x: Any, aval: str, device: torch.device, what: str) -> torch.Tensor:
    """``x`` (numpy or a tensor) on ``device``, checked against ``aval``:
    a wrong dtype is a TypeError, a wrong rank or static dim a ValueError
    (the server answers both with 400), a tensor on another device type a
    ValueError (a program does not move)."""
    dtype, dims = _parse_aval(aval)
    if isinstance(x, torch.Tensor):
        if x.device.type not in ("cpu", device.type):
            raise ValueError(f"{what}: a tensor on {x.device}; the artifact runs on {device.type} only")
        t = x
    else:
        arr = np.asarray(x)
        if arr.dtype.kind not in "biuf":
            raise TypeError(f"{what}: dtype {arr.dtype} is not numeric")
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {str(t.dtype).removeprefix('torch.')}, the program takes {aval}")
    if t.dim() != len(dims) or any(d is not None and d != s for d, s in zip(dims, t.shape)):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, the program takes {aval}")
    if dims and dims[0] is None and t.shape[0] < 1:
        raise ValueError(f"{what}: an empty batch")
    return t.to(device, non_blocking=True)


class ServingModel:
    """A loaded artifact: ``model(batch)`` runs the exported program on the
    artifact's platform and returns its output there (a tensor)."""

    def __init__(self, program: torch.nn.Module, meta: Dict[str, Any], device: torch.device):
        self._program = program
        self.meta = meta
        self.device = device

    @property
    def platforms(self) -> Tuple[str, ...]:
        return tuple(self.meta["platforms"])

    def example_input(self, batch_size: int = 1):
        """A zeros batch of the program's input: its dtype and static dims,
        the symbolic batch set to ``batch_size``; numpy, or a CPU tensor for
        a dtype numpy lacks (bfloat16)."""
        dtype, dims = _parse_aval(self.meta["batch_aval"])
        zeros = torch.zeros(tuple(batch_size if d is None else d for d in dims), dtype=dtype)
        return zeros if dtype == torch.bfloat16 else zeros.numpy()

    def __call__(self, batch) -> torch.Tensor:
        x = _to_device_input(batch, self.meta["batch_aval"], self.device, "batch")
        with torch.inference_mode():
            return self._program(x)

    def over_mesh(self, mesh=None, axis: str = "data"):
        raise NotImplementedError(
            "data-parallel serving (over_mesh) is not ported yet "
            "(ROADMAP.md, modules to port, item 11: parallelism)")


class StreamingServingModel(ServingModel):
    """A loaded STREAMING artifact: ``step(carry, chunk)`` advances one
    chunk and returns ``(new_carry, recon)`` on the device;
    ``init_carry()`` is a fresh session's state."""

    @property
    def stream_meta(self) -> Dict[str, Any]:
        return self.meta["meta"]

    def init_carry(self) -> torch.Tensor:
        return torch.zeros(tuple(self.stream_meta["carry_shape"]),
                           dtype=_DTYPES[self.stream_meta.get("carry_dtype", "float32")], device=self.device)

    def step(self, carry, chunk):
        c = _to_device_input(carry, self.meta["in_avals"][0], self.device, "carry")
        x = _to_device_input(chunk, self.meta["in_avals"][1], self.device, "chunk")
        with torch.inference_mode():
            return self._program(c, x)

    def __call__(self, batch):
        raise TypeError("streaming artifact: use step(carry, chunk) / the /stream "
                        "endpoints, not whole-batch __call__")


def load_artifact(path: str, device: Optional[torch.device | str] = None) -> ServingModel:
    """Load a ``.tchvp`` artifact of the port onto its platform's device
    (``device``, default the platform's current one): its weights are
    placed there once. Another version, a JAX package artifact, or a
    device of another platform than the artifact's raise."""
    with zipfile.ZipFile(path, "r") as z:
        names = set(z.namelist())
        if _PROGRAM_NAME not in names and _JAX_FN_NAME in names:
            raise ValueError(f"{path} is a JAX package artifact ({_JAX_FN_NAME}, StableHLO); re-export the "
                             "model with the port: python -m tchvp_tpu_torch.cli export")
        meta = json.loads(z.read(_META_NAME).decode("utf-8"))
        if meta.get("artifact_version") != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {meta.get('artifact_version')} "
                             f"!= supported {ARTIFACT_VERSION}")
        platform = meta["platforms"][0]
        dev = torch.device(platform if device is None else device)
        if dev.type != platform:
            raise ValueError(f"{path} was exported for {meta['platforms']}; it does not run on {dev}")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{path} was exported for cuda and there is no CUDA device")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        program = torch.export.load(io.BytesIO(z.read(_PROGRAM_NAME))).module()
    if meta.get("meta", {}).get("streaming"):
        return StreamingServingModel(program, meta, dev)
    return ServingModel(program, meta, dev)


def _model_dtype(model: nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


def export_video_model(
    model: nn.Module,
    *,
    clip_len: int,
    image_size: int,
    platforms: Optional[Sequence[str]] = None,
    symbolic_batch: bool = True,
    preprocess: bool = True,
):
    """A clip model (the flagship, a frame AE) -> ``(exported, record)``
    of ``batch (B, T, H, W, 3) -> reconstruction``: uint8 in when
    ``preprocess`` (normalize and resize fused in front, in the model's
    dtype), else the model's dtype. Eval mode."""
    from tchvp_tpu_torch.data import pipeline

    dtype = _model_dtype(model)
    device = next(model.parameters()).device

    def fn(batch):
        x = pipeline.preprocess_clip(batch, image_size, dtype=dtype) if preprocess else batch
        return model(x)[1]

    b = _SYMBOLIC_EXAMPLE_BATCH if symbolic_batch else 1
    example = torch.zeros((b, clip_len, image_size, image_size, 3),
                          dtype=torch.uint8 if preprocess else dtype, device=device)
    model.eval()
    return export_serving(fn, model, (example,), platforms=platforms, symbolic_batch=symbolic_batch)


def export_image_model(
    model: nn.Module,
    *,
    image_size: int,
    platforms: Optional[Sequence[str]] = None,
    symbolic_batch: bool = True,
    preprocess: bool = True,
):
    """A per-image model (FCT, UNet, AutoEncoder, Image2Image2Mask) ->
    ``(exported, record)`` of ``batch (B, H, W, 3) -> output``, eval mode;
    a tuple-returning model serves its last output."""
    from tchvp_tpu_torch.data import pipeline

    dtype = _model_dtype(model)
    device = next(model.parameters()).device

    def fn(batch):
        x = pipeline.preprocess_images(batch, image_size, dtype=dtype) if preprocess else batch
        out = model(x)
        return out[-1] if isinstance(out, tuple) else out

    b = _SYMBOLIC_EXAMPLE_BATCH if symbolic_batch else 1
    example = torch.zeros((b, image_size, image_size, 3),
                          dtype=torch.uint8 if preprocess else dtype, device=device)
    model.eval()
    return export_serving(fn, model, (example,), platforms=platforms, symbolic_batch=symbolic_batch)


def _streaming_fn(model: nn.Module, chunk_len: int, ctx_frames: int, image_size: int,
                  dtype: torch.dtype, scope: Callable[[], Any]):
    """The carry step of ``models/streaming.py::stream_clip``'s loop:
    ``fn(carry, chunk) -> (new_carry, recon)``; the carry (the raw encoder
    tokens of the last ``ctx_frames`` frames) is fp32 on the wire."""
    from tchvp_tpu_torch.data import pipeline

    if ctx_frames > chunk_len:
        raise ValueError("ctx_frames must be <= chunk_len")
    ctx_tokens = ctx_frames * model.config.tokens_per_frame

    def fn(carry, chunk):
        x = pipeline.preprocess_clip(chunk, image_size, dtype=dtype)
        with scope():
            tokens, hw = model.encode_clip(x)
            if ctx_tokens:
                mixed = model.temporal_mix(torch.cat([carry.to(tokens.dtype), tokens], dim=1))
                out_tokens = mixed[:, ctx_tokens:]
                new_carry = tokens[:, -ctx_tokens:].float()
            else:
                out_tokens = model.temporal_mix(tokens)
                new_carry = carry
            recon = model.decode_tokens(out_tokens, hw)
        return new_carry, recon

    return fn, ctx_tokens


def _export_streaming(model, fn, ctx_tokens, *, chunk_len, image_size, batch, platforms):
    device = next(model.parameters()).device
    d = (image_size // 4) ** 2
    carry0 = torch.zeros((batch, ctx_tokens, d), dtype=torch.float32, device=device)
    chunk0 = torch.zeros((batch, chunk_len, image_size, image_size, 3), dtype=torch.uint8, device=device)
    model.eval()
    return export_serving(fn, model, (carry0, chunk0), platforms=platforms, symbolic_batch=False)


def export_streaming_step(
    model: nn.Module,
    *,
    chunk_len: int,
    ctx_frames: int,
    image_size: int,
    batch: int = 1,
    platforms: Optional[Sequence[str]] = None,
):
    """The streaming carry step of a ``VideoHybridNet``: ``fn(carry, chunk)
    -> (new_carry, recon)``, the per-chunk computation of
    :func:`~tchvp_tpu_torch.models.streaming.stream_clip`, static shapes (a
    session has one geometry)."""
    import contextlib

    fn, ctx = _streaming_fn(model, chunk_len, ctx_frames, image_size, _model_dtype(model),
                            contextlib.nullcontext)
    return _export_streaming(model, fn, ctx, chunk_len=chunk_len, image_size=image_size, batch=batch,
                             platforms=platforms)


def export_int8_streaming_step(
    engine,
    *,
    chunk_len: int,
    ctx_frames: int,
    image_size: int,
    batch: int = 1,
    platforms: Optional[Sequence[str]] = None,
):
    """:func:`export_streaming_step` through a calibrated ``Int8Engine``'s
    int8 layers, its scales and int8 weights baked into the program."""
    if engine.qparams is None:
        raise ValueError("engine is not calibrated (call calibrate() first)")
    model = engine.model
    fn, ctx = _streaming_fn(model, chunk_len, ctx_frames, image_size, _model_dtype(model),
                            lambda: engine.intercepting(engine.qparams))
    return _export_streaming(model, fn, ctx, chunk_len=chunk_len, image_size=image_size, batch=batch,
                             platforms=platforms)


def streaming_meta(*, chunk_len: int, ctx_frames: int, image_size: int, batch: int,
                   tokens_per_frame: int, carry_dtype: str = "float32") -> Dict[str, Any]:
    """The ``meta`` a streaming artifact carries (read by
    :class:`StreamingServingModel` and the server's /stream endpoints)."""
    return {
        "streaming": True,
        "chunk_len": chunk_len,
        "ctx_frames": ctx_frames,
        "image_size": image_size,
        "batch": batch,
        "carry_shape": [batch, ctx_frames * tokens_per_frame, (image_size // 4) ** 2],
        "carry_dtype": carry_dtype,
    }


def export_int8_video_model(
    engine,
    *,
    clip_len: int,
    image_size: int,
    platforms: Optional[Sequence[str]] = None,
    symbolic_batch: bool = True,
):
    """A calibrated ``Int8Engine`` -> ``(exported, record)``: the int8
    forward (its activation scales and int8 weights baked in as constants,
    the calibration result) with uint8 preprocessing in front."""
    from tchvp_tpu_torch.data import pipeline

    if engine.qparams is None:
        raise ValueError("engine is not calibrated (call calibrate() first)")
    model = engine.model
    dtype = _model_dtype(model)
    device = next(model.parameters()).device

    def fn(batch):
        out = engine.apply(engine.qparams, pipeline.preprocess_clip(batch, image_size, dtype=dtype))
        return out[1] if isinstance(out, tuple) else out

    b = _SYMBOLIC_EXAMPLE_BATCH if symbolic_batch else 1
    example = torch.zeros((b, clip_len, image_size, image_size, 3), dtype=torch.uint8, device=device)
    model.eval()
    return export_serving(fn, model, (example,), platforms=platforms, symbolic_batch=symbolic_batch)
