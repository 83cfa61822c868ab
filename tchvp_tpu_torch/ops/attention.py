"""Token multi-head attention: one op interface over the attention cores.

Counterpart of ``tchvp_tpu/ops/attention.py``:

* ``"xla"`` — the plain dense core :func:`sdpa_xla` (the JAX name is kept:
  there it is XLA's einsum attention, here it is plain PyTorch); full
  attention whatever ``window_size`` says, as in JAX;
* ``"flash"`` — the hand-written kernels: full attention
  (:func:`tchvp_tpu_torch.kernels.flash_attention.mha`) or, with
  ``window_size > 0``, banded attention (``windowed_mha``);
* ``"windowed"`` — the dense banded core :func:`sdpa_windowed` with
  ``window_size > 0``, else :func:`sdpa_xla`;
* ``"auto"`` — ``"flash"`` for CUDA tensors without a mask, as the JAX
  package resolves to its Pallas kernels on the TPU, else ``"windowed"``
  with a window and no mask, else ``"xla"``.

A mask sends every impl to :func:`sdpa_xla`, as in JAX. ``"ring"`` and
``seq_axis`` (sequence parallelism) are not ported yet and raise; they
never fall back to another core.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tchvp_tpu_torch.ops import dispatch_trace

_INT32_MAX = 2**31 - 1


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, D) -> (B, H, S, D//H)."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, Dh) -> (B, S, H*Dh)."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def sdpa_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dropout_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, S, Dh) with fp32 softmax.

    ``mask``: optional boolean, broadcastable to (B, H, Sq, Sk); True =
    keep; masked logits are filled with -1e9. Dropout uses the boolean
    ``dropout_keep`` (B, H, Sq, Sk) when given (drawn beforehand), else
    draws a Bernoulli keep mask from ``generator``.
    """
    dispatch_trace.record("sdpa_xla")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        keep = dropout_keep
        if keep is None:
            keep = torch.rand(weights.shape, generator=generator, device=weights.device) < 1.0 - dropout_rate
        weights = weights * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def _sdpa_banded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_prev0: torch.Tensor,
    v_prev0: torch.Tensor,
    mask_prev0,
    *,
    window_size: int,
    scale: float,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dropout_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Banded overlapping-window attention core over (B, H, S, Dh).

    Window ``i`` attends to windows ``i-1`` and ``i``. The first window's
    left context comes from ``k_prev0``/``v_prev0`` (B, H, w, Dh): zeros at
    a sequence start, or a neighbour's halo under sequence parallelism.
    ``mask_prev0`` (a bool or a bool tensor) masks that context with -1e9,
    True at a true sequence start. Dropout uses the boolean
    ``dropout_keep`` (B, H, S/w, w, 2w) when given, else draws it from
    ``generator``.
    """
    dispatch_trace.record("banded_core")
    b, h, s, dh = q.shape
    w = window_size
    assert s % w == 0, f"seq len {s} not a multiple of window {w}"
    nw = s // w
    qw, kw, vw = (t.reshape(b, h, nw, w, dh) for t in (q, k, v))
    k_prev = torch.cat([k_prev0[:, :, None], kw[:, :, :-1]], dim=2)
    v_prev = torch.cat([v_prev0[:, :, None], vw[:, :, :-1]], dim=2)
    k_ctx = torch.cat([k_prev, kw], dim=3)  # (b, h, nw, 2w, dh)
    v_ctx = torch.cat([v_prev, vw], dim=3)
    logits = torch.einsum("bhnqd,bhnkd->bhnqk", qw.float(), k_ctx.float()) * scale
    # Mask the first window's left context at a sequence start.
    first = (torch.arange(nw, device=q.device) == 0).reshape(1, 1, nw, 1, 1)
    is_prev = (torch.arange(2 * w, device=q.device) < w).reshape(1, 1, 1, 1, 2 * w)
    drop = first & is_prev & torch.as_tensor(mask_prev0, dtype=torch.bool, device=q.device)
    logits = logits.masked_fill(drop, -1e9)
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        keep = dropout_keep
        if keep is None:
            keep = torch.rand(weights.shape, generator=generator, device=weights.device) < 1.0 - dropout_rate
        weights = weights * keep / (1.0 - dropout_rate)
    out = torch.einsum("bhnqk,bhnkd->bhnqd", weights.to(v.dtype), v_ctx)
    return out.reshape(b, h, s, dh)


def sdpa_windowed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dropout_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Overlapping-window attention over (B, H, S, Dh): each query window
    of ``window_size`` tokens attends to its own window and the previous
    one, with O(S * window) memory. S must be a multiple of
    ``window_size``. Dropout as in :func:`_sdpa_banded`."""
    dispatch_trace.record("sdpa_windowed")
    b, h, _, dh = q.shape
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    zeros = k.new_zeros((b, h, window_size, dh))
    return _sdpa_banded(
        q, k, v, zeros, zeros, True, window_size=window_size, scale=scale,
        dropout_rate=dropout_rate, generator=generator, deterministic=deterministic,
        dropout_keep=dropout_keep,
    )


def resolve_impl(impl: str, is_cuda: bool, has_mask: bool, window_size: int = 0) -> str:
    """``"auto"`` -> the core it stands for: ``"flash"`` on CUDA without a
    mask, as the JAX package takes its Pallas kernels on the accelerator;
    ``"windowed"`` with a window and no mask; else ``"xla"``."""
    if impl != "auto":
        return impl
    if is_cuda and not has_mask:
        return "flash"
    if window_size > 0 and not has_mask:
        return "windowed"
    return "xla"


def attention_core(impl: str, has_mask: bool, window_size: int) -> str:
    """The core a resolved ``impl`` runs, by the JAX package's rules:
    ``"flash"`` or ``"flash_windowed"`` (the kernels), ``"windowed"`` (the
    dense band) or ``"xla"`` (full dense attention, also for ``"xla"`` with
    a window, ``"windowed"`` without one, and any mask)."""
    if impl == "flash" and not has_mask:
        return "flash_windowed" if window_size > 0 else "flash"
    if impl == "windowed" and window_size > 0 and not has_mask:
        return "windowed"
    return "xla"


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    *,
    impl: str = "xla",
    window_size: int = 0,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    seq_axis: Optional[str] = None,
    dropout_draw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over already-projected (B, S, D) tokens.

    ``dropout_draw``: the attention dropout's randomness drawn beforehand
    (:func:`draw_attention_dropout`), so that a recompute under
    ``torch.utils.checkpoint`` sees the same mask; without it active
    dropout draws from ``generator`` here.
    """
    if seq_axis is not None:
        raise NotImplementedError(
            "seq_axis (sequence parallelism) is not ported yet "
            "(ROADMAP.md, modules to port, item 11: parallelism)"
        )
    impl = resolve_impl(impl, q.is_cuda, mask is not None, window_size)
    if impl == "ring":
        raise NotImplementedError(
            "impl='ring' is not ported yet (ROADMAP.md, modules to port, item 11: ring attention)"
        )
    if impl not in ("xla", "flash", "windowed"):
        raise ValueError(f"unknown attention impl {impl!r}")
    core = attention_core(impl, mask is not None, window_size)
    drop_active = dropout_rate > 0.0 and not deterministic
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if drop_active and dropout_draw is None:
        dropout_draw = draw_attention_dropout(core, tuple(qh.shape[:3]), dropout_rate, generator,
                                              q.device, window_size)
    if core in ("flash", "flash_windowed"):
        from tchvp_tpu_torch.kernels import flash_attention

        # The kernels apply attention-weight dropout from a counter-based
        # mask seeded by a (1,) int32 tensor on the device: no host sync.
        rate = dropout_rate if drop_active else 0.0
        seed = dropout_draw if drop_active else None
        if core == "flash_windowed":
            dispatch_trace.record("flash_windowed")
            out = flash_attention.windowed_mha(qh, kh, vh, window_size=window_size, scale=scale,
                                               dropout_rate=rate, dropout_seed=seed)
        else:
            dispatch_trace.record("flash_mha")
            out = flash_attention.mha(qh, kh, vh, scale=scale, dropout_rate=rate, dropout_seed=seed)
    elif core == "windowed":
        out = sdpa_windowed(
            qh, kh, vh, window_size=window_size, scale=scale, dropout_rate=dropout_rate,
            generator=generator, deterministic=deterministic, dropout_keep=dropout_draw,
        )
    else:
        out = sdpa_xla(
            qh, kh, vh, scale=scale, mask=mask, dropout_rate=dropout_rate,
            generator=generator, deterministic=deterministic, dropout_keep=dropout_draw,
        )
    return _merge_heads(out)


def draw_attention_dropout(
    core: str, bhs: Tuple[int, int, int], rate: float,
    generator: Optional[torch.Generator], device: torch.device, window_size: int = 0,
) -> torch.Tensor:
    """The randomness of one attention call's weight dropout, from
    ``generator``, for the :func:`attention_core` ``core``: for the kernels
    a (1,) int32 seed in [0, 2^31 - 1) on ``device``; for the dense band the
    (B, H, S/w, w, 2w) boolean keep mask; for the dense core (B, H, S, S)."""
    if generator is None:
        raise ValueError("active attention dropout requires a torch.Generator")
    if core in ("flash", "flash_windowed"):
        seed = torch.randint(0, _INT32_MAX, (1,), generator=generator,
                             device=generator.device, dtype=torch.int32)
        return seed.to(device)
    b, h, s = bhs
    w = window_size
    shape = (b, h, s // w, w, 2 * w) if core == "windowed" else (b, h, s, s)
    keep = torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate
    return keep.to(device)
