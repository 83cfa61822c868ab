"""Token multi-head attention: one op interface over the attention cores.

Counterpart of ``tchvp_tpu/ops/attention.py`` for the cores this port has:

* ``"xla"`` — the plain dense core :func:`sdpa_xla` (the JAX name is kept:
  there it is XLA's einsum attention, here it is plain PyTorch);
* ``"flash"`` — the hand-written flash kernel
  (:func:`tchvp_tpu_torch.kernels.flash_attention.mha`);
* ``"auto"`` — ``"flash"`` for CUDA tensors without a mask, as the JAX
  package resolves to its Pallas kernel on the TPU, else the JAX rules.

``"windowed"``, ``"ring"``, ``window_size > 0`` and ``seq_axis`` are not
ported yet and raise; they never fall back to another core.
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


def resolve_impl(impl: str, is_cuda: bool, has_mask: bool, window_size: int = 0) -> str:
    """``"auto"`` -> the core it stands for: ``"flash"`` on CUDA without a
    mask, as the JAX package takes its Pallas kernel on the accelerator;
    ``"windowed"`` with a window and no mask; else ``"xla"``."""
    if impl != "auto":
        return impl
    if is_cuda and not has_mask:
        return "flash"
    if window_size > 0 and not has_mask:
        return "windowed"
    return "xla"


def uses_flash_core(impl: str, has_mask: bool) -> bool:
    """Whether a resolved ``impl`` runs the flash kernel: a mask sends
    ``"flash"`` to the dense core, as in the JAX package."""
    return impl == "flash" and not has_mask


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
    if impl == "windowed" or window_size > 0:
        raise NotImplementedError(
            "windowed attention is not ported yet (ROADMAP.md, modules to port, item 3: "
            "sdpa_windowed; TPU kernels to port, item 3: windowed_mha)"
        )
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    drop_active = dropout_rate > 0.0 and not deterministic
    flash = uses_flash_core(impl, mask is not None)
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if drop_active and dropout_draw is None:
        b, h, s = qh.shape[:3]
        dropout_draw = draw_attention_dropout(flash, (b, h, s), dropout_rate, generator, q.device)
    if flash:
        from tchvp_tpu_torch.kernels import flash_attention

        # The kernel applies attention-weight dropout from a counter-based
        # mask seeded by a (1,) int32 tensor on the device: no host sync.
        dispatch_trace.record("flash_mha")
        out = flash_attention.mha(
            qh, kh, vh, scale=scale, dropout_rate=dropout_rate if drop_active else 0.0,
            dropout_seed=dropout_draw if drop_active else None,
        )
    else:
        out = sdpa_xla(
            qh, kh, vh, scale=scale, mask=mask, dropout_rate=dropout_rate,
            generator=generator, deterministic=deterministic, dropout_keep=dropout_draw,
        )
    return _merge_heads(out)


def draw_attention_dropout(
    flash: bool, bhs: Tuple[int, int, int], rate: float,
    generator: Optional[torch.Generator], device: torch.device,
) -> torch.Tensor:
    """The randomness of one attention call's weight dropout, from
    ``generator``: for the flash kernel a (1,) int32 seed in [0, 2^31 - 1)
    on ``device``; for the dense core the (B, H, S, S) boolean keep mask."""
    if generator is None:
        raise ValueError("active attention dropout requires a torch.Generator")
    if flash:
        seed = torch.randint(0, _INT32_MAX, (1,), generator=generator,
                             device=generator.device, dtype=torch.int32)
        return seed.to(device)
    b, h, s = bhs
    keep = torch.rand((b, h, s, s), generator=generator, device=generator.device) < 1.0 - rate
    return keep.to(device)
