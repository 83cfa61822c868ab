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

A mask sends every impl to :func:`sdpa_xla`, as in JAX. ``"ring"`` is
full attention over seq-sharded tokens (:func:`sdpa_ring_seq_sharded`); it
needs ``seq_axis``, no mask and no window, and without a mesh carrying the
axis it runs :func:`sdpa_xla` (marker ``ring_fallback``), as in JAX.

:class:`TorchMultiheadAttention` is FCT's attention layer: separate
q/k/v/out projections around :func:`multi_head_attention` at the 1/sqrt(Dh)
scale.

``seq_axis`` (sequence parallelism): while an ambient mesh carries the axis
with size > 1 (:func:`tchvp_tpu_torch.parallel.mesh.mesh_with_axis`, JAX's
gate), each rank holds a contiguous block of the tokens. A banded impl
(``"flash"`` or ``"windowed"`` with a window, no mask) then runs
:func:`sdpa_windowed_seq_sharded`, which takes one window of k/v from the
left neighbour; ``"xla"`` (and any impl with a mask) stays full attention
over the whole sequence, its keys and values gathered over the axis and
the mask's rows of this rank taken (what GSPMD inserts in JAX); full
attention on the kernel (``"flash"`` without a window) gathers q too, runs
``mha`` on the whole sequence and keeps this rank's rows. Without such a
mesh, dispatch is as without ``seq_axis``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.ops.blocks import Dense
from tchvp_tpu_torch.parallel.collectives import all_reduce_sum, ppermute, ring_shift
from tchvp_tpu_torch.parallel.mesh import axis_group, axis_shards, mesh_with_axis

_INT32_MAX = 2**31 - 1


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, D) -> (B, H, S, D//H)."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, Dh) -> (B, S, H*Dh)."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _fp32_logits(spec: str, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """QK^T in fp32, also under autocast (which would run the product in
    its compute dtype): JAX's ``preferred_element_type=float32``."""
    with torch.autocast(q.device.type, enabled=False):
        return torch.einsum(spec, q.float(), k.float())


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
    logits = _fp32_logits("bhqd,bhkd->bhqk", q, k) * scale
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
    logits = _fp32_logits("bhnqd,bhnkd->bhnqk", qw, k_ctx) * scale
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


def _seq_mesh(seq_axis: Optional[str]):
    """The ambient mesh iff it carries ``seq_axis`` with size > 1: the gate
    of sequence parallelism, :func:`mesh_with_axis` as for JAX."""
    return mesh_with_axis(seq_axis)


def sdpa_windowed_seq_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    seq_axis: str,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    use_flash: bool = False,
    dropout_draw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel windowed attention over this rank's (B, H, S/n,
    Dh) block of the tokens, the n blocks in rank order along ``seq_axis``.

    The band (window i attends to i-1 and i) needs exactly one window of
    keys and values from the left neighbour: :func:`ppermute` sends each
    rank's last window to the next rank, and rank 0's halo arrives as zeros
    and is masked, so the result is the unsharded band's rows of this rank.
    Gradients of the halo go back to its owner through the reverse
    exchange. ``use_flash``: the per-shard band runs in the halo kernels
    (:func:`tchvp_tpu_torch.kernels.flash_attention.windowed_mha_halo`)
    over ``cat([halo, local])`` with ``has_prev = (rank > 0)``; else in the
    dense :func:`_sdpa_banded` with the halo as its left context. S/n must
    be a multiple of ``window_size``.

    Dropout: ``dropout_draw`` is this rank's draw (:func:`draw_attention_dropout`
    with ``shards``): for the kernels the rank's one of n seeds drawn at
    once from the shared generator, for the dense band the rank's windows
    of the global keep mask; without it the draw is made here. Every rank
    draws the same numbers, so the generators stay in step. Without a mesh
    carrying ``seq_axis`` this is :func:`sdpa_windowed` over the tokens it
    is given.
    """
    mesh = _seq_mesh(seq_axis)
    if mesh is None:
        dispatch_trace.record("seq_sharded_fallback")
        return sdpa_windowed(q, k, v, window_size=window_size, scale=scale,
                             dropout_rate=dropout_rate, generator=generator,
                             deterministic=deterministic, dropout_keep=dropout_draw)
    n, idx = axis_shards(seq_axis)
    b, h, s_local, dh = q.shape
    w = window_size
    if s_local % w:
        raise ValueError(f"seq shard {s_local * n}//{n} not a multiple of window {window_size}")
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    group = axis_group(mesh, seq_axis)
    dispatch_trace.record("seq_sharded_shard_map")
    k_halo = ppermute(k[:, :, -w:], group)
    v_halo = ppermute(v[:, :, -w:], group)
    drop_on = dropout_rate > 0.0 and not deterministic
    if drop_on and dropout_draw is None:
        core = "flash_windowed" if use_flash else "windowed"
        dropout_draw = draw_attention_dropout(core, (b, h, s_local), dropout_rate, generator,
                                              q.device, w, shards=(n, idx))
    if use_flash:
        from tchvp_tpu_torch.kernels import flash_attention

        dispatch_trace.record("windowed_mha_halo")
        return flash_attention.windowed_mha_halo(
            q, torch.cat([k_halo, k], dim=2), torch.cat([v_halo, v], dim=2), window_size=w,
            has_prev=int(idx > 0), scale=scale, dropout_rate=dropout_rate if drop_on else 0.0,
            dropout_seed=dropout_draw if drop_on else None)
    return _sdpa_banded(q, k, v, k_halo, v_halo, idx == 0, window_size=w, scale=scale,
                        dropout_rate=dropout_rate, generator=generator,
                        deterministic=deterministic, dropout_keep=dropout_draw)


def _gather_seq(x: torch.Tensor, mesh, seq_axis: str) -> torch.Tensor:
    """(B, H, S/n, Dh) blocks -> the (B, H, S, Dh) sequence on every rank,
    differentiable: each rank places its block in zeros and the blocks are
    summed over the axis (exact), so the adjoint sums the cotangents and
    keeps the rank's rows."""
    n, idx = axis_shards(seq_axis)
    s_local = x.shape[2]
    full = torch.cat([x.new_zeros(x.shape[:2] + (idx * s_local,) + x.shape[3:]), x,
                      x.new_zeros(x.shape[:2] + ((n - 1 - idx) * s_local,) + x.shape[3:])], dim=2)
    return all_reduce_sum(full, axis_group(mesh, seq_axis))


def _ring_block(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                acc: torch.Tensor, seed: Optional[torch.Tensor], scale: float, rate: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming-softmax update of (m, l, acc) against the k/v block
    ``kb``/``vb``, all fp32. Dropout (``seed``, a (1,) int32 tensor) scales
    the unnormalised weights by the block's counter-based keep mask, the
    denominator keeping every key (dropout after the softmax)."""
    from tchvp_tpu_torch.kernels.flash_attention import _keep_mask

    with torch.autocast(q.device.type, enabled=False):
        logits = _fp32_logits("bhqd,bhkd->bhqk", q, kb) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if seed is not None:
            b, h, s_q, s_k = p.shape
            bh = torch.arange(b * h, device=q.device).reshape(b, h)
            p = p * _keep_mask(seed, bh, s_q, s_k, rate) / (1.0 - rate)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
    return m_new, l, acc


def sdpa_ring_seq_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    seq_axis: str,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    loop: str = "auto",
    remat: bool = True,
    dropout_draw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ring attention: full all-pairs attention over this rank's (B, H, S/n,
    Dh) block of seq-sharded tokens, which never gather (JAX's
    ``sdpa_ring_seq_sharded``).

    The k/v blocks rotate one :func:`ring_shift` hop a step (rank i sends to
    rank i + 1 mod n, JAX's ``perm``), so at step i rank ``my`` holds the
    block of rank (my - i) mod n; a streaming softmax carries the fp32 row
    max m, denominator l and numerator over the n steps, and the result is
    ``acc / l`` in v's dtype. Memory is O(S/n * S/n) transient logits per
    hop. ``loop``: JAX's loop form, ``"unroll"``, ``"scan"`` (marker
    ``ring_shard_map_scan``) or ``"auto"`` (scan for n > 8); in the port
    every form is the same Python loop of n - 1 hops (JAX's scan makes one
    more, whose result nothing reads). ``remat``: each
    hop's block update runs under ``torch.utils.checkpoint``, so the
    backward holds the hops' O(S/n * Dh) inputs, not n fp32 probability
    blocks.

    Dropout: ``dropout_draw`` is the (n, n) table of int32 seeds of
    :func:`draw_attention_dropout` (core ``"ring"``), the same on every
    rank; block (query shard ``my``, key block ``src``) takes seed
    ``[my, src]`` and builds its keep mask on the device from the block's
    local (row, col) indices, so each (query, key) pair has one draw
    whatever the ring position or loop form, and no S x S mask is formed.
    Without a mesh carrying ``seq_axis`` this is :func:`sdpa_xla` (marker
    ``ring_fallback``), ``dropout_draw`` then its keep mask. The blocks are
    equal shares of the sequence: JAX's S % n error is raised where the
    whole sequence is cut (``parallel.shard_frames``)."""
    mesh = _seq_mesh(seq_axis)
    if mesh is None:
        dispatch_trace.record("ring_fallback")
        return sdpa_xla(q, k, v, scale=scale, dropout_rate=dropout_rate, generator=generator,
                        deterministic=deterministic, dropout_keep=dropout_draw)
    n, my = axis_shards(seq_axis)
    b, h, s, dh = q.shape
    group = axis_group(mesh, seq_axis)
    if loop not in ("auto", "unroll", "scan"):
        raise ValueError(f"loop must be auto|unroll|scan, got {loop!r}")
    scan = loop == "scan" or (loop == "auto" and n > 8)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    drop_on = dropout_rate > 0.0 and not deterministic
    if drop_on and dropout_draw is None:
        dropout_draw = draw_attention_dropout("ring", (b, h, s), dropout_rate, generator, q.device,
                                              shards=(n, my))
    dispatch_trace.record("ring_shard_map_scan" if scan else "ring_shard_map")
    block = functools.partial(_ring_block, scale=scale, rate=dropout_rate)
    if remat:
        block = functools.partial(checkpoint, block, use_reentrant=False, preserve_rng_state=False)
    m = q.new_full((b, h, s, 1), -math.inf, dtype=torch.float32)
    l = q.new_zeros((b, h, s, 1), dtype=torch.float32)
    acc = q.new_zeros((b, h, s, dh), dtype=torch.float32)
    kb, vb = k, v
    for i in range(n):
        src = (my - i) % n
        seed = dropout_draw[my, src:src + 1] if drop_on else None
        m, l, acc = block(q, kb, vb, m, l, acc, seed)
        if i + 1 < n:
            kb, vb = ring_shift(kb, group), ring_shift(vb, group)
    return (acc / l).to(v.dtype)


def _seq_rows(x: torch.Tensor, dim: int, seq_axis: str) -> torch.Tensor:
    """This rank's block of the whole sequence's ``x`` along ``dim``."""
    n, i = axis_shards(seq_axis)
    s = x.shape[dim] // n
    return x.narrow(dim, i * s, s)


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
    ``"ring"``, ``"flash"`` or ``"flash_windowed"`` (the kernels),
    ``"windowed"`` (the dense band) or ``"xla"`` (full dense attention, also
    for ``"xla"`` with a window, ``"windowed"`` without one, and any mask)."""
    if impl == "ring":
        return "ring"
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

    ``seq_axis``: under a mesh carrying it (module docstring) the tokens
    are this rank's block of the sequence: a banded impl without a mask
    runs :func:`sdpa_windowed_seq_sharded`, ``"ring"``
    :func:`sdpa_ring_seq_sharded`, the full-attention kernel ``mha`` over
    the gathered sequence, and ``"xla"`` (or a mask) the dense core over the
    gathered keys. A mask is (B, 1, S, S) over the whole sequence or
    (B, 1, S/n, S) of this rank's rows.

    ``impl="ring"`` raises JAX's ``ValueError`` with a mask, with a window
    or without ``seq_axis``.
    """
    impl = resolve_impl(impl, q.is_cuda, mask is not None, window_size)
    if impl not in ("xla", "flash", "windowed", "ring"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "ring":
        if mask is not None:
            raise ValueError("impl='ring' does not support attention masks")
        if window_size > 0:
            raise ValueError("impl='ring' computes FULL attention; use impl='windowed' "
                             "or 'flash' for banded windows under sequence sharding")
        if seq_axis is None:
            raise ValueError("impl='ring' requires seq_axis")
    core = attention_core(impl, mask is not None, window_size)
    mesh = _seq_mesh(seq_axis)
    shards = axis_shards(seq_axis)
    drop_active = dropout_rate > 0.0 and not deterministic
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if drop_active and dropout_draw is None:
        dropout_draw = draw_attention_dropout(core, tuple(qh.shape[:3]), dropout_rate, generator,
                                              q.device, window_size, shards)
    if core == "ring":
        return _merge_heads(sdpa_ring_seq_sharded(
            qh, kh, vh, seq_axis=seq_axis, scale=scale, dropout_rate=dropout_rate,
            generator=generator, deterministic=deterministic, dropout_draw=dropout_draw))
    if mesh is not None and core in ("windowed", "flash_windowed"):
        # Only a resolved impl that already means banded attention: "xla"
        # computes full attention whatever window_size says, and sharding
        # must never change the math.
        out = sdpa_windowed_seq_sharded(
            qh, kh, vh, window_size=window_size, seq_axis=seq_axis, scale=scale,
            dropout_rate=dropout_rate, generator=generator, deterministic=deterministic,
            use_flash=core == "flash_windowed", dropout_draw=dropout_draw)
        return _merge_heads(out)
    gathered_q = False
    if mesh is not None:
        dispatch_trace.record("seq_gathered")
        if mask is not None and mask.shape[-2] == shards[0] * qh.shape[2]:
            mask = _seq_rows(mask, mask.dim() - 2, seq_axis)
        kh, vh = _gather_seq(kh, mesh, seq_axis), _gather_seq(vh, mesh, seq_axis)
        if core == "flash":
            # mha takes q, k and v of one shape: the kernel runs on the
            # whole sequence, its seed the unsharded call's on every rank.
            qh, gathered_q = _gather_seq(qh, mesh, seq_axis), True
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
        if gathered_q:
            out = _seq_rows(out, 2, seq_axis)
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
    shards: Tuple[int, int] = (1, 0), head_shards: Tuple[int, int] = (1, 0),
) -> torch.Tensor:
    """The randomness of one attention call's weight dropout, from
    ``generator``, for the :func:`attention_core` ``core``: for the kernels
    a (1,) int32 seed in [0, 2^31 - 1) on ``device``; for the dense band the
    (B, H, S/w, w, 2w) boolean keep mask; for the dense core (B, H, S, S);
    for the ring an (n, n) table of int32 seeds on ``device``, one per
    (query shard, key block), as JAX folds both into its key.

    ``shards`` (n, i): under sequence parallelism ``bhs`` is rank i's
    (B, H, S/n) block of n. The draw is made for all n ranks at once, the
    same on each, and rank i's part comes back: the halo kernels' seed i of
    n (one per shard, as JAX folds the shard index into its key), the dense
    cores' windows or query rows of the global keep mask, the whole ring
    table. ``"flash"`` (full attention) runs on the gathered sequence, so
    it draws the one seed of the unsharded call; the ring without a mesh
    is the dense core.

    ``head_shards`` (m, j): under tensor parallelism this rank runs block j
    of m of the heads. The dense cores keep its heads of the whole keep
    mask (its rows of it beside sequence parallelism); the kernels take
    seed j of m, one per rank, as their hash cannot be moved to another
    rank's heads; beside sequence parallelism the halo kernels and the ring
    take draw j of m of their seeds."""
    if generator is None:
        raise ValueError("active attention dropout requires a torch.Generator")
    m, j = head_shards
    if m > 1:
        if shards[0] > 1 and core in ("flash_windowed", "ring"):
            # Beside sequence parallelism: the halo kernels' seeds, or the
            # ring's table, of head block j of m (m draws, one a block).
            draws = [draw_attention_dropout(core, bhs, rate, generator, device, window_size, shards)
                     for _ in range(m)]
            return draws[j]
        if core in ("flash", "flash_windowed"):
            seeds = torch.randint(0, _INT32_MAX, (m,), generator=generator, device=generator.device,
                                  dtype=torch.int32)
            return seeds[j:j + 1].to(device)
        whole = draw_attention_dropout(core, bhs, rate, generator, device, window_size, shards)
        per = bhs[1] // m
        return whole[:, j * per:(j + 1) * per]
    n, i = shards
    if core == "ring" and n > 1:
        return torch.randint(0, _INT32_MAX, (n, n), generator=generator, device=generator.device,
                             dtype=torch.int32).to(device)
    if core == "ring":
        core = "xla"
    if core == "flash":
        n, i = 1, 0
    if core in ("flash", "flash_windowed"):
        seeds = torch.randint(0, _INT32_MAX, (n,), generator=generator,
                              device=generator.device, dtype=torch.int32)
        return seeds[i:i + 1].to(device)
    b, h, s = bhs
    w = window_size
    shape = (b, h, n * s // w, w, 2 * w) if core == "windowed" else (b, h, n * s, n * s)
    keep = torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate
    rows = s // w if core == "windowed" else s
    return keep[:, :, i * rows:(i + 1) * rows].to(device)


class TorchMultiheadAttention(nn.Module):
    """Attention numerically matching ``torch.nn.MultiheadAttention``:
    q/k/v in-projections and the out-projection, with biases, around
    :func:`multi_head_attention` at the 1/sqrt(head_dim) scale. The core
    used by every FCT block; ``impl`` selects it ("xla", "flash", "auto" or
    "ring", which needs ``seq_axis``). Parameter names are the JAX layer's;
    its window and mask wait for a caller (FCT passes neither)."""

    def __init__(self, features: int, num_heads: int, impl: str = "xla", seq_axis: Optional[str] = None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.impl = impl
        self.seq_axis = seq_axis
        self.q_proj = Dense(features, features)
        self.k_proj = Dense(features, features)
        self.v_proj = Dense(features, features)
        self.out_proj = Dense(features, features)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """(B, Sq, D) queries, (B, Sk, D) keys and values -> (B, Sq, D)."""
        out = multi_head_attention(self.q_proj(query), self.k_proj(key), self.v_proj(value),
                                   self.num_heads, impl=self.impl, seq_axis=self.seq_axis)
        return self.out_proj(out)
