"""Flash, banded and halo attention: the Hopper kernels, their plain
versions, ``mha``, ``windowed_mha`` and ``windowed_mha_halo``.

Counterpart of ``tchvp_tpu/kernels/flash_attention.py``'s ``mha``,
``windowed_mha`` and ``windowed_mha_halo`` with their custom VJPs. On a CUDA
tensor :func:`_flash_fwd` launches the hand-written forward
``csrc/flash_fwd.cu`` (on the tensor cores, one pass of online softmax over
head-dim column blocks; it takes ``mha``'s (B, H, S, Dh) views as they are
and writes ``out`` into a (B, S, H, Dh) buffer, so neither the heads'
split nor their merge copies) and :func:`_flash_bwd` the two backward kernels of
``csrc/flash_bwd.cu`` (dq; dk and dv; on the tensor cores too, reading the
same views and writing each gradient into a (B, S, H, Dh) buffer);
:func:`_win_fwd` and :func:`_win_bwd` launch the banded kernels of
``csrc/band_attention.cu``, where query window i sees key windows i-1 and i; :func:`_halo_fwd` and :func:`_halo_bwd` launch
those of ``csrc/halo_attention.cu``, one shard of the band under sequence
parallelism, whose k and v carry the left neighbour's last window in front.
The banded and halo forwards run on the tensor cores in two passes over
an fp32 logits scratch (``csrc/window_fwd.cuh``) whose width and key-tile
grid :func:`window_plan` gives; their backward (``csrc/window_bwd.cuh``)
forms P_drop and dS once per (query tile, key tile) pair into a scratch of
the inputs' dtype (pass A), then dq and dk/dv from it (pass B), on the
tensor cores too, its tiles and scratch as :func:`window_bwd_plan` says.
All are built at first use by :mod:`.build`. On a CPU tensor they run
:func:`mha_reference`, :func:`mha_bwd_reference` and their windowed and halo
counterparts, the dense fp32 versions of the same functions (the band as a
mask over the logits). A CUDA tensor never reaches a plain version, and a
build or launch failure raises.

Attention-weight dropout uses the TPU kernels' counter-based mask: a
squirrel3 hash of the global (row, col) index of the (S, S) weight matrix,
seeded per call, so the mask here is bit for bit the JAX package's
``attention_dropout_mask``. The seed is a ``(1,)`` int32 tensor on the
device, as the Pallas kernels read theirs from SMEM, so drawing it needs no
host sync. Torch has no full uint32 arithmetic, so the plain versions
compute the hash in int64 and keep the low 32 bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from tchvp_tpu_torch.ops import dispatch_trace

_MASK32 = 0xFFFFFFFF

# Launches of each CUDA kernel in this process (never the plain versions);
# chip_smoke.py resets them around the main path.
launches = 0  # flash_fwd
dq_launches = 0  # flash_bwd_dq
dkv_launches = 0  # flash_bwd_dkv
band_fwd_launches = 0  # band_attention: forward
band_ds_launches = 0  # band_attention: backward pass A (P_drop and dS)
band_dq_launches = 0  # band_attention: backward pass B, dq
band_dkv_launches = 0  # band_attention: backward pass B, dk/dv
halo_fwd_launches = 0  # halo_attention: forward
halo_ds_launches = 0  # halo_attention: backward pass A
halo_dq_launches = 0  # halo_attention: backward pass B, dq
halo_dkv_launches = 0  # halo_attention: backward pass B, dk/dv

Seed = Union[int, torch.Tensor, None]

# Tiles of the banded and halo forwards (csrc/window_fwd.cuh): 64 query rows,
# 64 keys per logits block and P.V step.
WIN_BLOCK_Q, WIN_BLOCK_K = 64, 64


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _squirrel3(x: torch.Tensor) -> torch.Tensor:
    """Squirrel3 avalanche hash over uint32 values held in int64."""
    x = _mul32(x, 0xB5297A4D)
    x = x ^ (x >> 8)
    x = (x + 0x68E31DA4) & _MASK32
    x = x ^ ((x << 8) & _MASK32)
    x = _mul32(x, 0x1B56C4E9)
    x = x ^ (x >> 8)
    return x


def _drop_threshold(rate: float) -> int:
    """uint32 threshold t: drop where hash < t, so P(drop) = t / 2^32."""
    return min(0xFFFFFFFF, max(0, int(round(rate * 4294967296.0))))


def _keep_mask(seed: Seed, bh: torch.Tensor, s_q: int, s_k: int, rate: float,
               row0: int = 0, col0: int = 0) -> torch.Tensor:
    """Keep mask of the batch-heads ``bh`` (int64, any shape): bool of
    shape ``bh.shape + (s_q, s_k)``, True = keep, of the weights at rows
    ``row0..`` and columns ``col0..``. ``seed``: an int or a one-element
    integer tensor. A negative index hashes as its int32 -> uint32 cast, as
    the TPU kernels' does (the halo columns -w..-1)."""
    device = bh.device
    seed_t = torch.as_tensor(seed).to(device=device, dtype=torch.int64).reshape(())
    row = (torch.arange(s_q, dtype=torch.int64, device=device)[:, None] + row0) & _MASK32
    col = (torch.arange(s_k, dtype=torch.int64, device=device)[None, :] + col0) & _MASK32
    base = (_mul32(seed_t & _MASK32, 0x9E3779B1)
            + _mul32(bh.to(torch.int64) & _MASK32, 0x85EBCA77)) & _MASK32
    base = base[..., None, None]
    h = _squirrel3(row ^ base)
    h = _squirrel3((h + _mul32(col, 0x27D4EB2F)) & _MASK32)
    return h >= _drop_threshold(rate)


def attention_dropout_mask(seed: int, bh: int, s_q: int, s_k: int, rate: float) -> torch.Tensor:
    """(s_q, s_k) bool keep mask of batch-head ``bh``: the torch mirror of
    the JAX package's ``attention_dropout_mask``."""
    return _keep_mask(seed, torch.tensor(bh, dtype=torch.int64), s_q, s_k, rate)


def band_mask(s: int, window: int, device: torch.device) -> torch.Tensor:
    """(S, S) bool: True where query row r sees key c, i.e. c's window is
    r's or the one before it (the TPU kernels' ``_band_mask``)."""
    win = torch.arange(s, device=device) // window
    gap = win[:, None] - win[None, :]
    return (gap == 0) | (gap == 1)


def halo_band_mask(s: int, window: int, has_prev, device: torch.device) -> torch.Tensor:
    """(S, S + w) bool: True where local query row r sees k_ext column c,
    i.e. c's window is r's or the one after it, and c is not in the halo
    window (c < w) where ``has_prev`` (an int or a one-element tensor) is 0
    (the TPU kernels' ``_halo_band_mask``)."""
    row_win = torch.arange(s, device=device)[:, None] // window
    col = torch.arange(s + window, device=device)[None, :]
    gap = col // window - row_win
    no_prev = torch.as_tensor(has_prev, device=device).reshape(()) == 0
    return ((gap == 0) | (gap == 1)) & ~((col < window) & no_prev)


def window_key_span(first: int, last: int, seq_len: int, window: int, halo: bool,
                    no_prev: bool = False) -> Tuple[int, int]:
    """[lo, hi): the keys that query rows first..last (last < S) may see,
    ``csrc/flash_common.cuh``'s ``key_span``. Band: the window before the
    first row's through the last row's own. Halo (k_ext columns): the first
    row's window through the window after the last row's, without the halo
    window where ``no_prev``."""
    if halo:
        return (max(window if no_prev else 0, (first // window) * window),
                min(seq_len + window, (last // window + 2) * window))
    return max(0, (first // window - 1) * window), min(seq_len, (last // window + 1) * window)


class WindowPlan(NamedTuple):
    """Scratch of the tensor-core banded or halo forward, which the C
    launchers take as they are."""

    span_cols: int     # the widest key span of a 64-row query tile: the logits
                       # pass's grid.y is its 64-key tiles
    scratch_cols: int  # row width of the (BH, S, scratch_cols) fp32 scratch


@functools.lru_cache(maxsize=256)
def window_plan(seq_len: int, window: int, halo: bool) -> WindowPlan:
    """The one rule for the banded (``halo`` False, 1 <= window <= S) and
    halo forwards' key tiles and scratch. A scratch row holds the logits of
    the widest key span of a 64-row query tile (with has_prev 1 for the
    halo, which holds has_prev 0's), then the row's max over each of its
    64-key tiles; its width is rounded up to a multiple of 4, so the P.V
    pass copies each tile's logits in aligned 16-byte pieces."""
    widest = max(hi - lo for lo, hi in (
        window_key_span(q0, min(seq_len, q0 + WIN_BLOCK_Q) - 1, seq_len, window, halo)
        for q0 in range(0, seq_len, WIN_BLOCK_Q)))
    cols = widest + -(-widest // WIN_BLOCK_K)
    return WindowPlan(widest, -(-cols // 4) * 4)


def window_tile_base(window: int, halo: bool) -> int:
    """Where the backward's grid of 64-key tiles starts (``csrc/window_bwd.cuh``):
    0 for the band; for the halo the last start <= 0 of the grid through
    k_ext column w, so that halo tiles lie on the band's tiles of the local
    sequence."""
    r = window % WIN_BLOCK_K if halo else 0
    return r - WIN_BLOCK_K if r else 0


def window_tile_span(q0: int, seq_len: int, window: int, halo: bool,
                     no_prev: bool = False) -> Tuple[int, int]:
    """(base, n_tiles): the first key tile and the number of key tiles that
    cover the key span of the 64-row query tile at ``q0``, the kernels'
    ``window_tile_span``. Scratch column c of the tile's rows is key base + c."""
    lo, hi = window_key_span(q0, min(seq_len, q0 + WIN_BLOCK_Q) - 1, seq_len, window, halo, no_prev)
    tb = window_tile_base(window, halo)
    base = tb + (lo - tb) // WIN_BLOCK_K * WIN_BLOCK_K
    return base, -(-(hi - base) // WIN_BLOCK_K)


def window_query_span(first: int, last: int, seq_len: int, window: int, halo: bool,
                      no_prev: bool = False) -> Tuple[int, int]:
    """[lo, hi): the query rows that may see keys first..last (last < the
    rows of k), ``csrc/flash_common.cuh``'s ``query_span``. Band: the first
    key's window through the one after the last key's. Halo: the window
    before the first k_ext key's through the last key's own; none for keys
    of the masked halo window."""
    if halo:
        lo = max(0, (first // window - 1) * window)
        return (lo, lo) if no_prev and last < window else (lo, min(seq_len, (last // window + 1) * window))
    return (first // window) * window, min(seq_len, (last // window + 2) * window)


class WindowBwdPlan(NamedTuple):
    """Tiles and scratch of the tensor-core banded or halo backward, which
    the C launchers take as they are."""

    span_tiles: int  # key tiles of the widest query tile's span: pass A's grid.y
    key_tiles: int   # 64-key tiles of k (S + w rows for the halo): the dk/dv pass's grid.x
    tile_base: int   # the first key tile's start (:func:`window_tile_base`)

    @property
    def scratch_cols(self) -> int:
        """Row width of each half (dS, P_drop) of the (2, BH, S, cols) scratch."""
        return self.span_tiles * WIN_BLOCK_K


@functools.lru_cache(maxsize=256)
def window_bwd_plan(seq_len: int, window: int, halo: bool) -> WindowBwdPlan:
    """The one rule for the banded (``halo`` False, 1 <= window <= S) and
    halo backwards' key tiles and scratch: the widest span in key tiles
    (has_prev 1 for the halo, which holds has_prev 0's), the key tiles of
    k and where they start."""
    span = max(window_tile_span(q0, seq_len, window, halo)[1] for q0 in range(0, seq_len, WIN_BLOCK_Q))
    tb = window_tile_base(window, halo)
    keys = seq_len + window if halo else seq_len
    return WindowBwdPlan(span, -(-(keys - tb) // WIN_BLOCK_K), tb)


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float,
            band: Optional[torch.Tensor]) -> torch.Tensor:
    """(BH, Sq, Sk) fp32 scaled logits; pairs outside ``band`` are -inf."""
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return logits if band is None else logits.masked_fill(~band, float("-inf"))


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0, band: Optional[torch.Tensor] = None,
    col0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: dense fp32 softmax attention over
    (BH, S, Dh) -> (out (BH, S, Dh) in q's dtype, lse (BH, S) fp32).
    ``band``: an (S, Sk) bool mask of the pairs that may attend (all when
    None); every row must keep at least one. ``col0``: the dropout hash's
    column of k's first row (-w for the halo's k_ext)."""
    bh, s, _ = q.shape
    logits = _logits(q, k, scale, band)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    w = p / l
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, torch.arange(bh, device=q.device), s, k.shape[1], dropout_rate,
                          col0=col0)
        w = w * keep / (1.0 - dropout_rate)
    out = torch.einsum("bqk,bkd->bqd", w, v.float())
    return out.to(q.dtype), lse


def _flat(*tensors: torch.Tensor) -> tuple:
    """(BH, S, Dh) of each (BH, S, Dh) tensor or (B, H, S, Dh) view (a copy
    where the view's strides need one)."""
    return tuple(t.reshape(-1, *t.shape[-2:]) for t in tensors)


def _grad_weights(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, dropout_rate: float, seed: Seed,
    band: Optional[torch.Tensor] = None, col0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ds, P_drop), (BH, S, Sk) fp32: P recomputed from ``lse`` (0 outside
    ``band``); with dropout the keep mask rides on dp, and P_drop is
    P * keep / (1 - rate)."""
    bh, s, _ = q.shape
    p = torch.exp(_logits(q, k, scale, band) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    p_drop = p
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, torch.arange(bh, device=q.device), s, k.shape[1], dropout_rate,
                          col0=col0)
        keep = keep.float() / (1.0 - dropout_rate)
        dp = dp * keep
        p_drop = p * keep
    return p * (dp - delta[..., None]) * scale, p_drop


def mha_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0, band: Optional[torch.Tensor] = None,
    col0: int = 0,
) -> torch.Tensor:
    """Plain version of the dq kernel: dq = ds k, in q's dtype. q, k, v, do:
    (BH, S, Dh), or (B, H, S, Dh) views of any strides as the flash kernels
    take them; lse, delta (B * H, S); dq comes back in q's shape."""
    q3, k3, v3, do3 = _flat(q, k, v, do)
    ds, _ = _grad_weights(q3, k3, v3, do3, lse, delta, scale, dropout_rate, seed, band, col0)
    return torch.einsum("bqk,bkd->bqd", ds, k3.float()).to(q.dtype).reshape(q.shape)


def mha_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0, band: Optional[torch.Tensor] = None,
    col0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dk = ds^T q, dv = P_drop^T do,
    taking the inputs as :func:`mha_bwd_dq_reference` does; dk and dv come
    back in k's shape."""
    q3, k3, v3, do3 = _flat(q, k, v, do)
    ds, p_drop = _grad_weights(q3, k3, v3, do3, lse, delta, scale, dropout_rate, seed, band, col0)
    dk = torch.einsum("bqk,bqd->bkd", ds, q3.float())
    dv = torch.einsum("bqk,bqd->bkd", p_drop, do3.float())
    return dk.to(k.dtype).reshape(k.shape), dv.to(v.dtype).reshape(v.shape)


def mha_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels: dense fp32 recompute of P
    from ``lse`` with their formulas, (BH, S, Dh) each or (B, H, S, Dh)
    views -> (dq, dk, dv) in the inputs' dtype and shape. ``delta`` =
    rowsum(do * out), (B * H, S) fp32."""
    args = (q, k, v, do, lse, delta, scale, dropout_rate, seed)
    return (mha_bwd_dq_reference(*args),) + mha_bwd_dkv_reference(*args)


def windowed_mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the banded forward: :func:`mha_reference` over the
    pairs of :func:`band_mask` -> (out, lse); any S, the last window may be
    partial."""
    band = band_mask(q.shape[1], window, q.device)
    return mha_reference(q, k, v, scale, dropout_rate, seed, band)


def windowed_mha_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> torch.Tensor:
    """Plain version of the banded dq kernel."""
    band = band_mask(q.shape[1], window, q.device)
    return mha_bwd_dq_reference(q, k, v, do, lse, delta, scale, dropout_rate, seed, band)


def windowed_mha_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the banded dk/dv kernel."""
    band = band_mask(q.shape[1], window, q.device)
    return mha_bwd_dkv_reference(q, k, v, do, lse, delta, scale, dropout_rate, seed, band)


def windowed_mha_halo_reference(
    q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, scale: float, window: int,
    has_prev, dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the halo forward: :func:`mha_reference` of q (BH,
    S, Dh) over k_ext, v_ext (BH, S + w, Dh) on the pairs of
    :func:`halo_band_mask`, the dropout hash at the shard-local columns
    (k_ext column - w) -> (out, lse)."""
    band = halo_band_mask(q.shape[1], window, has_prev, q.device)
    return mha_reference(q, k_ext, v_ext, scale, dropout_rate, seed, band, col0=-window)


def windowed_mha_halo_bwd_dq_reference(
    q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int, has_prev,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> torch.Tensor:
    """Plain version of the halo dq kernel."""
    band = halo_band_mask(q.shape[1], window, has_prev, q.device)
    return mha_bwd_dq_reference(q, k_ext, v_ext, do, lse, delta, scale, dropout_rate, seed, band,
                                col0=-window)


def windowed_mha_halo_bwd_dkv_reference(
    q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int, has_prev,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the halo dk/dv kernel: (dk_ext, dv_ext) of S + w
    rows, the halo window's gradient in the first w."""
    band = halo_band_mask(q.shape[1], window, has_prev, q.device)
    return mha_bwd_dkv_reference(q, k_ext, v_ext, do, lse, delta, scale, dropout_rate, seed,
                                 band, col0=-window)


def _no_prev(has_prev) -> bool:
    return has_prev is not None and int(torch.as_tensor(has_prev).reshape(())) == 0


def _scratch_tiles(s: int, keys: int, window: int, has_prev):
    """(rows, key columns, scratch columns) of each 64-row query tile's key
    tiles (:func:`window_tile_span`): scratch column c is key base + c."""
    halo = has_prev is not None
    for q0 in range(0, s, WIN_BLOCK_Q):
        base, n = window_tile_span(q0, s, window, halo, _no_prev(has_prev))
        lo, hi = max(base, 0), min(base + n * WIN_BLOCK_K, keys)
        yield slice(q0, q0 + WIN_BLOCK_Q), slice(lo, hi), slice(lo - base, hi - base)


def _window_geometry(s: int, window: int, has_prev) -> Tuple[int, WindowBwdPlan]:
    """The backward's window (the band takes min(w, S)) and plan."""
    halo = has_prev is not None
    window = int(window) if halo else min(int(window), s)
    return window, window_bwd_plan(s, window, halo)


def window_bwd_scratch_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0, has_prev=None,
) -> torch.Tensor:
    """Plain version of the backward's pass A (banded, or halo where
    ``has_prev`` is given): (2, BH, S, cols) fp32, dS then P_drop of each
    64-row query tile's key tiles (:func:`window_tile_span`), 0 outside the
    band and past the span, as the kernel writes them."""
    bh, s, _ = q.shape
    window, plan = _window_geometry(s, window, has_prev)
    if has_prev is None:
        band, col0 = band_mask(s, window, q.device), 0
    else:
        band, col0 = halo_band_mask(s, window, has_prev, q.device), -window
    ds, p_drop = _grad_weights(q, k, v, do, lse, delta, scale, dropout_rate, seed, band, col0)
    out = torch.zeros((2, bh, s, plan.scratch_cols), dtype=torch.float32, device=q.device)
    for rows, keys, cols in _scratch_tiles(s, k.shape[1], window, has_prev):
        out[0, :, rows, cols] = ds[:, rows, keys]
        out[1, :, rows, cols] = p_drop[:, rows, keys]
    return out


def window_bwd_unpack(scratch: torch.Tensor, kv_len: int, window: int,
                      has_prev=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dS, P_drop), (BH, S, kv_len) fp32, from a scratch of pass A."""
    _, bh, s, _ = scratch.shape
    window, _ = _window_geometry(s, window, has_prev)
    dense = torch.zeros((2, bh, s, kv_len), dtype=torch.float32, device=scratch.device)
    for rows, keys, cols in _scratch_tiles(s, kv_len, window, has_prev):
        dense[:, :, rows, keys] = scratch[:, :, rows, cols].float()
    return dense[0], dense[1]


def window_bwd_dq_reference(scratch: torch.Tensor, k: torch.Tensor, window: int,
                            has_prev=None) -> torch.Tensor:
    """Plain version of pass B's dq: dS K from a scratch, in k's dtype."""
    ds, _ = window_bwd_unpack(scratch, k.shape[1], window, has_prev)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(k.dtype)


def window_bwd_dkv_reference(scratch: torch.Tensor, q: torch.Tensor, do: torch.Tensor, window: int,
                             has_prev=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of pass B's dk/dv: (dS^T Q, P_drop^T dO) from a scratch,
    in q's dtype, of S rows (the band) or S + w (the halo's k_ext)."""
    s = q.shape[1]
    kv_len = s + int(window) if has_prev is not None else s
    ds, p_drop = window_bwd_unpack(scratch, kv_len, window, has_prev)
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p_drop, do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _signature(pointers: int, ints: int, halo: bool = False, strides: int = 0) -> list:
    """A C launcher's argument types: tensor pointers, then the ints (BH, S,
    Dh[, window][, span_cols, scratch_cols]; the flash kernels' B, H, S, Dh,
    their int64 (batch, head, row) strides of each tensor view, then
    is_bf16), scale, rate, threshold, seed[, has_prev], stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    dims = [i] * ints if not strides else [i] * (ints - 1) + [ctypes.c_longlong] * strides + [i]
    return [p] * pointers + dims + [ctypes.c_float, ctypes.c_float, ctypes.c_uint32, p] + [p] * halo + [p]


def _pass_b_signature(pointers: int, halo: bool = False) -> list:
    """The window backward's pass-B launchers: the scratch and tensor
    pointers, BH, S, Dh, window, span_tiles, key_tiles, tile_base, is_bf16[,
    has_prev], stream."""
    p = ctypes.c_void_p
    return [p] * pointers + [ctypes.c_int] * 8 + [p] * halo + [p]


# Each library's C launchers and their argument types.
_LAUNCHERS = {
    "flash_fwd": {"tchvp_flash_fwd": _signature(5, 5, strides=12)},
    "flash_bwd": {"tchvp_flash_bwd_dq": _signature(7, 5, strides=15),
                  "tchvp_flash_bwd_dkv": _signature(8, 5, strides=18)},
    "band_attention": {"tchvp_band_fwd": _signature(6, 7), "tchvp_band_bwd_ds": _signature(7, 8),
                       "tchvp_band_bwd_dq": _pass_b_signature(3), "tchvp_band_bwd_dkv": _pass_b_signature(5)},
    "halo_attention": {"tchvp_halo_fwd": _signature(6, 7, halo=True),
                       "tchvp_halo_bwd_ds": _signature(7, 8, halo=True),
                       "tchvp_halo_bwd_dq": _pass_b_signature(3, halo=True),
                       "tchvp_halo_bwd_dkv": _pass_b_signature(5, halo=True)},
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    """Build (once) and bind ``csrc/<name>.cu``'s C launchers."""
    from tchvp_tpu_torch.kernels import build

    lib = build.load(name, [f"{name}.cu"])
    if lib.tchvp_cuda_error_string.restype is not ctypes.c_char_p:
        for fn, argtypes in _LAUNCHERS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tchvp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tchvp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(ref: torch.Tensor, window: Optional[int], **tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: dtype, shape, device, layout,
    an empty head dim, window. Any head dim >= 1 runs."""
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {ref.dtype}")
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (BH, S, Dh)")
    if ref.shape[2] < 1:
        raise ValueError(f"flash kernels take head dims >= 1, got {ref.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"the banded kernels take a window >= 1, got {window}")


def _seed_arg(seed: Seed, dropout_rate: float, device: torch.device) -> Tuple[int, Optional[torch.Tensor]]:
    """(pointer, tensor kept alive) of the (1,) int32 device seed; a null
    pointer when dropout is off, so the inference path moves nothing."""
    if dropout_rate <= 0.0:
        return 0, None
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(seed) & _MASK32], dtype=torch.int64).to(torch.int32)
    seed = seed.reshape(1).to(device=device, dtype=torch.int32).contiguous()
    return seed.data_ptr(), seed


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tchvp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the flash forward does not take: dtype, rank, shape,
    device, a stride along Dh other than 1, an empty head dim. Any other
    layout runs."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() not in (3, 4):
        raise ValueError(f"the flash forward takes (BH, S, Dh) or (B, H, S, Dh), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
    if q.shape[-1] < 1:
        raise ValueError(f"flash kernels take head dims >= 1, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must have unit stride along the head dim, got {t.stride()}")


def _strides4(t: torch.Tensor) -> tuple:
    """(batch, head, row) strides of a (B, H, S, Dh) view, or of a (BH, S,
    Dh) tensor read as (1, BH, S, Dh)."""
    return t.stride()[:3] if t.dim() == 4 else (0,) + t.stride()[:2]


_flash_fwd_bound = None  # (the C launcher, its library), bound at the first launch


def _cuda_stream(device: torch.device) -> int:
    """The raw current stream of ``device``, by torch's own fast path (a
    tenth of ``torch.cuda.current_stream(device).cuda_stream``'s host time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream. q, k, v: (BH, S,
    Dh), or (B, H, S, Dh) views of any strides with unit stride along Dh ->
    (out, lse (B * H, S) fp32); out is (BH, S, Dh) contiguous, or the (B, H,
    S, Dh) view of a (B, S, H, Dh) buffer, whose heads merge without a copy."""
    global launches, _flash_fwd_bound
    _check_flash_inputs(q, k, v)
    if _flash_fwd_bound is None:
        lib = _kernel_lib("flash_fwd")
        _flash_fwd_bound = (lib.tchvp_flash_fwd, lib)
    launch, lib = _flash_fwd_bound
    if q.dim() == 4:
        b, h, s, dh = q.shape
        out = q.new_empty((b, s, h, dh)).transpose(1, 2)
    else:
        (h, s, dh), b = q.shape, 1
        out = q.new_empty((h, s, dh))
    lse = q.new_empty((b * h, s), dtype=torch.float32)
    seed_ptr, _keep_alive = _seed_arg(seed, dropout_rate, q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, s, dh,
            *_strides4(q), *_strides4(k), *_strides4(v), *_strides4(out),
            int(q.dtype == torch.bfloat16), float(scale), float(dropout_rate),
            _drop_threshold(dropout_rate), seed_ptr, _cuda_stream(q.device))
    if q.device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(q.device):
            err = launch(*args)
    _raise_on(lib, err, "flash_fwd")
    launches += 1
    return out, lse


def _window_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int,
                dropout_rate: float, seed: Seed, has_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/band_attention.cu``'s forward (``has_prev`` None) or
    ``csrc/halo_attention.cu``'s on the current stream, its scratch as
    :func:`window_plan` says. The inputs are checked by the caller."""
    bh, s, dh = q.shape
    halo = has_prev is not None
    window = int(window) if halo else min(int(window), s)
    plan = window_plan(s, window, halo)
    name = "halo_attention" if halo else "band_attention"
    lib = _kernel_lib(name)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    scratch = torch.empty((bh, s, plan.scratch_cols), dtype=torch.float32, device=q.device)
    seed_ptr, _keep_seed = _seed_arg(seed, dropout_rate, q.device)
    prev = (_has_prev_arg(has_prev, q.device),) if halo else ()
    with torch.cuda.device(q.device):
        launch = lib.tchvp_halo_fwd if halo else lib.tchvp_band_fwd
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     scratch.data_ptr(), bh, s, dh, window, plan.span_cols, plan.scratch_cols,
                     int(q.dtype == torch.bfloat16), float(scale), float(dropout_rate),
                     _drop_threshold(dropout_rate), seed_ptr, *(t.data_ptr() for t in prev),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, f"{name} forward")
    return out, lse


def band_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int,
    dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the banded forward: the logits pass (grid: 64-row
    query tile x 64-key tile of its span x batch-head), then the P.V pass
    (64-row query tile x 128-column block x batch-head)."""
    global band_fwd_launches
    _check_inputs(q, window, q=q, k=k, v=v)
    result = _window_fwd(q, k, v, scale, window, dropout_rate, seed, None)
    band_fwd_launches += 1
    return result


def _split_seed(seed: Seed) -> Tuple[int, Optional[torch.Tensor]]:
    """A seed as the custom ops take it: (int, None) or (0, tensor)."""
    return (0, seed) if isinstance(seed, torch.Tensor) else (int(seed or 0), None)


def _op_seed(seed: int, seed_tensor: Optional[torch.Tensor]) -> Seed:
    return seed_tensor if seed_tensor is not None else seed


# The forwards as torch.library operators, so that torch.export keeps them
# in an exported graph as ``tchvp.flash_fwd`` and ``tchvp.band_fwd`` nodes
# (it cannot follow a ctypes launch on a data_ptr()). The CUDA kernel
# launches the hand-written kernel or raises; the CPU kernel is the plain
# version; the fake one gives the shapes, dtypes and strides the real ones
# return. They are defined on a ``Library`` fragment rather than by
# ``torch.library.custom_op``, whose Python wrappers add to every call's
# host time (PERF.md); they are called with grad off (inside the autograd
# Functions or under no_grad), so no autograd kernel is needed.
# The dispatch markers stay in Python outside the ops, where they run when
# a graph is traced, as in JAX.
_LIB = torch.library.Library("tchvp", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, float scale, float dropout_rate, int seed, "
            "Tensor? seed_tensor) -> (Tensor, Tensor)")
_LIB.define("band_fwd(Tensor q, Tensor k, Tensor v, float scale, int window, float dropout_rate, int seed, "
            "Tensor? seed_tensor) -> (Tensor, Tensor)")


def _flash_fwd_op_cpu(q, k, v, scale, dropout_rate, seed, seed_tensor):
    flat = (t.reshape(-1, *t.shape[-2:]) for t in (q, k, v))
    out, lse = mha_reference(*flat, scale, dropout_rate, _op_seed(seed, seed_tensor))
    return out.reshape(q.shape), lse


def _flash_fwd_op_cuda(q, k, v, scale, dropout_rate, seed, seed_tensor):
    return _flash_fwd_cuda(q, k, v, scale, dropout_rate, _op_seed(seed, seed_tensor))


def _flash_fwd_op_fake(q, k, v, scale, dropout_rate, seed, seed_tensor):
    if q.dim() == 4 and q.device.type == "cuda":  # the (B, H, S, Dh) view of a (B, S, H, Dh) buffer
        b, h, s, dh = q.shape
        out = q.new_empty((b, s, h, dh)).transpose(1, 2)
    else:
        out = q.new_empty(q.shape)
    return out, q.new_empty((math.prod(q.shape[:-2]), q.shape[-2]), dtype=torch.float32)


def _band_fwd_op_cpu(q, k, v, scale, window, dropout_rate, seed, seed_tensor):
    return windowed_mha_reference(q, k, v, scale, window, dropout_rate, _op_seed(seed, seed_tensor))


def _band_fwd_op_cuda(q, k, v, scale, window, dropout_rate, seed, seed_tensor):
    return band_fwd_cuda(q, k, v, scale, window, dropout_rate, _op_seed(seed, seed_tensor))


def _band_fwd_op_fake(q, k, v, scale, window, dropout_rate, seed, seed_tensor):
    return q.new_empty(q.shape), q.new_empty(q.shape[:2], dtype=torch.float32)


_LIB.impl("flash_fwd", _flash_fwd_op_cpu, "CPU")
_LIB.impl("flash_fwd", _flash_fwd_op_cuda, "CUDA")
torch.library.register_fake("tchvp::flash_fwd", _flash_fwd_op_fake, lib=_LIB)
_LIB.impl("band_fwd", _band_fwd_op_cpu, "CPU")
_LIB.impl("band_fwd", _band_fwd_op_cuda, "CUDA")
torch.library.register_fake("tchvp::band_fwd", _band_fwd_op_fake, lib=_LIB)
_FLASH_FWD_OP, _BAND_FWD_OP = torch.ops.tchvp.flash_fwd.default, torch.ops.tchvp.band_fwd.default


def _flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (BH, S, Dh) or (B, H, S, Dh) -> (out of q's shape, lse (BH,
    S) fp32), through ``tchvp::flash_fwd``."""
    dispatch_trace.record("flash_mha_cuda" if q.is_cuda else "flash_mha_plain")
    return _FLASH_FWD_OP(q, k, v, float(scale), float(dropout_rate), *_split_seed(seed))


def _win_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded q, k, v: (BH, S, Dh) -> (out (BH, S, Dh), lse (BH, S) fp32),
    through ``tchvp::band_fwd``."""
    dispatch_trace.record("flash_windowed_cuda" if q.is_cuda else "flash_windowed_plain")
    return _BAND_FWD_OP(q, k, v, float(scale), int(window), float(dropout_rate), *_split_seed(seed))


def _check_flash_bwd_inputs(q, k, v, do, lse, delta) -> None:
    """:func:`_check_flash_inputs` for q, k, v and do; lse and delta
    contiguous fp32 (B * H, S) on q's device."""
    _check_flash_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do: {tuple(do.shape)} {do.dtype} {do.device} does not match q")
    if do.stride(-1) != 1 and do.shape[-1] > 1:
        raise ValueError(f"do must have unit stride along the head dim, got {do.stride()}")
    stats = (math.prod(q.shape[:-2]), q.shape[-2])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != stats or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 {stats} on {q.device}")


def grad_buffer(x: torch.Tensor) -> torch.Tensor:
    """An empty gradient of ``x``'s shape for the flash backward kernels:
    the (B, H, S, Dh) view of a (B, S, H, Dh) buffer for a 4-d ``x``, whose
    heads then merge without a copy; (BH, S, Dh) contiguous for a 3-d one."""
    if x.dim() == 4:
        b, h, s, dh = x.shape
        return x.new_empty((b, s, h, dh)).transpose(1, 2)
    return x.new_empty(x.shape)


_flash_bwd_bound: dict = {}  # C launcher name -> (launcher, library), bound at the first launch


def _launch_flash_bwd(name: str, q, k, v, do, lse, delta, outs, scale: float,
                      dropout_rate: float, seed: Seed) -> None:
    """Launch ``csrc/flash_bwd.cu``'s ``name`` into ``outs`` on the current
    stream, every tensor through its (batch, head, row) strides."""
    _check_flash_bwd_inputs(q, k, v, do, lse, delta)
    if name not in _flash_bwd_bound:
        lib = _kernel_lib("flash_bwd")
        _flash_bwd_bound[name] = (getattr(lib, name), lib)
    launch, lib = _flash_bwd_bound[name]
    b, h = q.shape[:2] if q.dim() == 4 else (1, q.shape[0])
    s, dh = q.shape[-2:]
    seed_ptr, _keep_alive = _seed_arg(seed, dropout_rate, q.device)
    tensors = (q, k, v, do) + tuple(outs)
    args = (*(t.data_ptr() for t in (q, k, v, do, lse, delta) + tuple(outs)), b, h, s, dh,
            *(st for t in tensors for st in _strides4(t)), int(q.dtype == torch.bfloat16), float(scale),
            float(dropout_rate), _drop_threshold(dropout_rate), seed_ptr, _cuda_stream(q.device))
    if q.device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(q.device):
            err = launch(*args)
    _raise_on(lib, err, name)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, dropout_rate: float,
                      seed: Seed) -> torch.Tensor:
    """dq of the dq kernel (grid: 64-row query tile x head-dim column block
    x batch-head, each block walking every key tile). q, k, v, do: (BH, S,
    Dh), or (B, H, S, Dh) views with unit stride along Dh, read as they are;
    dq: :func:`grad_buffer` of q."""
    global dq_launches
    dq = grad_buffer(q)
    _launch_flash_bwd("tchvp_flash_bwd_dq", q, k, v, do, lse, delta, (dq,), scale, dropout_rate, seed)
    dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, dropout_rate: float,
                       seed: Seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the dk/dv kernel (grid: 64-key tile x head-dim column
    block x batch-head, each block walking every query tile); inputs as in
    :func:`flash_bwd_dq_cuda`, dk and dv :func:`grad_buffer` of k and v."""
    global dkv_launches
    dk, dv = grad_buffer(k), grad_buffer(v)
    _launch_flash_bwd("tchvp_flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale, dropout_rate, seed)
    dkv_launches += 1
    return dk, dv


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel and takes CUDA tensors, got {t.device}; "
                         "the plain versions take the CPU's")


def _check_stats(q: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 (BH, S) on {q.device}")


def _check_scratch(scratch: torch.Tensor, like: torch.Tensor, bh: int, s: int, plan: WindowBwdPlan) -> None:
    want = (2, bh, s, plan.scratch_cols)
    if (tuple(scratch.shape) != want or scratch.dtype != like.dtype or scratch.device != like.device
            or not scratch.is_contiguous()):
        raise ValueError(f"scratch: {tuple(scratch.shape)} {scratch.dtype} {scratch.device}; pass B takes "
                         f"pass A's contiguous {want} {like.dtype} on {like.device}")


def _launch_window_bwd(fn: str, q_like: torch.Tensor, pointers: tuple, ints: tuple, extra: tuple,
                       has_prev) -> None:
    """Launch ``fn`` of ``csrc/band_attention.cu`` (``has_prev`` None) or
    ``csrc/halo_attention.cu`` on the current stream: the pointers, the ints,
    then ``extra`` (pass A's scale, rate, threshold, seed)[, has_prev],
    stream."""
    name = "band_attention" if has_prev is None else "halo_attention"
    lib = _kernel_lib(name)
    prev = () if has_prev is None else (_has_prev_arg(has_prev, q_like.device),)
    with torch.cuda.device(q_like.device):
        err = getattr(lib, fn)(*pointers, *ints, *extra, *(t.data_ptr() for t in prev),
                               _cuda_stream(q_like.device))
    _raise_on(lib, err, fn)


def _window_ds(q, k, v, do, lse, delta, scale: float, window: int, dropout_rate: float, seed: Seed,
               has_prev) -> torch.Tensor:
    """Pass A of the banded or halo backward into a new scratch; inputs
    checked by the caller."""
    bh, s, dh = q.shape
    window, plan = _window_geometry(s, window, has_prev)
    scratch = torch.empty((2, bh, s, plan.scratch_cols), dtype=q.dtype, device=q.device)
    seed_ptr, _keep_seed = _seed_arg(seed, dropout_rate, q.device)
    fn = "tchvp_band_bwd_ds" if has_prev is None else "tchvp_halo_bwd_ds"
    _launch_window_bwd(fn, q, tuple(t.data_ptr() for t in (q, k, v, do, lse, delta, scratch)),
                       (bh, s, dh, window, *plan, int(q.dtype == torch.bfloat16)),
                       (float(scale), float(dropout_rate), _drop_threshold(dropout_rate), seed_ptr), has_prev)
    return scratch


def _window_dq(scratch: torch.Tensor, k: torch.Tensor, window: int, has_prev) -> torch.Tensor:
    """Pass B's dq from ``scratch``; k (BH, S or S + w, Dh)."""
    _, bh, s, _ = scratch.shape
    window, plan = _window_geometry(s, window, has_prev)
    dh = k.shape[-1]
    _check_inputs(k, window, k=k)
    if k.shape != (bh, s + (window if has_prev is not None else 0), dh):
        raise ValueError(f"k: {tuple(k.shape)} does not match a scratch of (BH, S) = ({bh}, {s})")
    _check_scratch(scratch, k, bh, s, plan)
    _check_cuda(k, "the dq pass")
    dq = k.new_empty((bh, s, dh))
    fn = "tchvp_band_bwd_dq" if has_prev is None else "tchvp_halo_bwd_dq"
    _launch_window_bwd(fn, k, (scratch.data_ptr(), k.data_ptr(), dq.data_ptr()),
                       (bh, s, dh, window, *plan, int(k.dtype == torch.bfloat16)), (), has_prev)
    return dq


def _window_dkv(scratch: torch.Tensor, q: torch.Tensor, do: torch.Tensor, window: int,
                has_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass B's dk and dv from ``scratch``; q, do (BH, S, Dh)."""
    _, bh, s, _ = scratch.shape
    window, plan = _window_geometry(s, window, has_prev)
    _check_inputs(q, window, q=q, do=do)
    dh = q.shape[-1]
    if q.shape != (bh, s, dh):
        raise ValueError(f"q: {tuple(q.shape)} does not match a scratch of (BH, S) = ({bh}, {s})")
    _check_scratch(scratch, q, bh, s, plan)
    _check_cuda(q, "the dk/dv pass")
    kv_len = s + window if has_prev is not None else s
    dk, dv = q.new_empty((bh, kv_len, dh)), q.new_empty((bh, kv_len, dh))
    fn = "tchvp_band_bwd_dkv" if has_prev is None else "tchvp_halo_bwd_dkv"
    _launch_window_bwd(fn, q, tuple(t.data_ptr() for t in (scratch, q, do, dk, dv)),
                       (bh, s, dh, window, *plan, int(q.dtype == torch.bfloat16)), (), has_prev)
    return dk, dv


def band_bwd_ds_cuda(q, k, v, do, lse, delta, scale: float, window: int, dropout_rate: float,
                     seed: Seed) -> torch.Tensor:
    """Pass A of the banded backward (grid: 64-row query tile x key tile of
    its span x batch-head): dS and P_drop into a (2, BH, S, cols) scratch of
    q's dtype (:func:`window_bwd_plan`)."""
    global band_ds_launches
    _check_inputs(q, window, q=q, k=k, v=v, do=do)
    _check_stats(q, lse, delta)
    _check_cuda(q, "the banded backward")
    scratch = _window_ds(q, k, v, do, lse, delta, scale, window, dropout_rate, seed, None)
    band_ds_launches += 1
    return scratch


def band_bwd_dq_cuda(scratch: torch.Tensor, k: torch.Tensor, window: int) -> torch.Tensor:
    """dq of the banded backward's pass B from pass A's scratch (grid: 64-row
    query tile x head-dim column block x batch-head, each block walking its
    span's key tiles)."""
    global band_dq_launches
    dq = _window_dq(scratch, k, window, None)
    band_dq_launches += 1
    return dq


def band_bwd_dkv_cuda(scratch: torch.Tensor, q: torch.Tensor, do: torch.Tensor,
                      window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the banded backward's pass B (grid: 64-key tile x column
    block x batch-head, each block walking the query tiles of its window and
    the next)."""
    global band_dkv_launches
    result = _window_dkv(scratch, q, do, window, None)
    band_dkv_launches += 1
    return result


def _check_halo(q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, window: int,
                **tensors: torch.Tensor) -> None:
    """:func:`_check_inputs` for the halo kernels: q and ``tensors`` (BH,
    S, Dh), k_ext and v_ext (BH, S + w, Dh) of q's dtype and device."""
    _check_inputs(q, window, q=q, **tensors)
    _check_inputs(k_ext, window, k_ext=k_ext, v_ext=v_ext)
    bh, s, dh = q.shape
    if k_ext.shape != (bh, s + window, dh) or k_ext.dtype != q.dtype or k_ext.device != q.device:
        raise ValueError(f"k_ext: {tuple(k_ext.shape)} {k_ext.dtype} {k_ext.device}; the halo "
                         f"kernels take ({bh}, {s} + {window}, {dh}) {q.dtype} on {q.device}")


def _has_prev_arg(has_prev, device: torch.device) -> torch.Tensor:
    """``has_prev`` (an int, a bool or a one-element tensor) as the (1,)
    int32 device tensor the halo kernels read; made on the device from a
    Python value, so no host-to-device copy."""
    if isinstance(has_prev, torch.Tensor):
        return has_prev.reshape(1).to(device=device, dtype=torch.int32).contiguous()
    return torch.full((1,), int(has_prev), dtype=torch.int32, device=device)


def halo_fwd_cuda(
    q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, scale: float, window: int,
    has_prev, dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the halo forward: the two passes of
    :func:`band_fwd_cuda` over each 64-row query tile's k_ext span."""
    global halo_fwd_launches
    _check_halo(q, k_ext, v_ext, window)
    result = _window_fwd(q, k_ext, v_ext, scale, window, dropout_rate, seed, has_prev)
    halo_fwd_launches += 1
    return result


def halo_bwd_ds_cuda(q, k_ext, v_ext, do, lse, delta, scale: float, window: int, has_prev,
                     dropout_rate: float, seed: Seed) -> torch.Tensor:
    """Pass A of the halo backward: :func:`band_bwd_ds_cuda` over each
    64-row query tile's k_ext span."""
    global halo_ds_launches
    _check_halo(q, k_ext, v_ext, window, do=do)
    _check_stats(q, lse, delta)
    _check_cuda(q, "the halo backward")
    scratch = _window_ds(q, k_ext, v_ext, do, lse, delta, scale, window, dropout_rate, seed, has_prev)
    halo_ds_launches += 1
    return scratch


def halo_bwd_dq_cuda(scratch: torch.Tensor, k_ext: torch.Tensor, window: int, has_prev) -> torch.Tensor:
    """dq of the halo backward's pass B (each query tile walks its k_ext
    span's key tiles)."""
    global halo_dq_launches
    dq = _window_dq(scratch, k_ext, window, has_prev)
    halo_dq_launches += 1
    return dq


def halo_bwd_dkv_cuda(scratch: torch.Tensor, q: torch.Tensor, do: torch.Tensor, window: int,
                      has_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk_ext, dv_ext) of the halo backward's pass B, S + w rows (each
    64-key tile of k_ext walks the local rows of its window and the one
    before; zeros for the masked halo window)."""
    global halo_dkv_launches
    result = _window_dkv(scratch, q, do, window, has_prev)
    halo_dkv_launches += 1
    return result


def _flash_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq kernel, then the dk/dv kernel, on the current stream."""
    args = (q, k, v, do, lse, delta, scale, dropout_rate, seed)
    return (flash_bwd_dq_cuda(*args),) + flash_bwd_dkv_cuda(*args)


def _flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(BH, S, Dh) q, k, v, do or (B, H, S, Dh) views, and (B * H, S) fp32
    lse, delta -> (dq, dk, dv) in q's shape."""
    if q.is_cuda:
        dispatch_trace.record("flash_mha_bwd_cuda")
        return _flash_bwd_cuda(q, k, v, do, lse, delta, scale, dropout_rate, seed)
    dispatch_trace.record("flash_mha_bwd_plain")
    return mha_bwd_reference(q, k, v, do, lse, delta, scale, dropout_rate, seed)


def _win_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The banded backward: (dq, dk, dv), the dq kernel first."""
    args = (q, k, v, do, lse, delta, scale, window, dropout_rate, seed)
    if q.is_cuda:
        dispatch_trace.record("flash_windowed_bwd_cuda")
        scratch = band_bwd_ds_cuda(*args)
        return (band_bwd_dq_cuda(scratch, k, window),) + band_bwd_dkv_cuda(scratch, q, do, window)
    dispatch_trace.record("flash_windowed_bwd_plain")
    return (windowed_mha_bwd_dq_reference(*args),) + windowed_mha_bwd_dkv_reference(*args)


def _halo_fwd(
    q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, scale: float, window: int,
    has_prev, dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, S, Dh), k_ext, v_ext (BH, S + w, Dh) -> (out, lse)."""
    if q.is_cuda:
        dispatch_trace.record("flash_halo_cuda")
        return halo_fwd_cuda(q, k_ext, v_ext, scale, window, has_prev, dropout_rate, seed)
    dispatch_trace.record("flash_halo_plain")
    return windowed_mha_halo_reference(q, k_ext, v_ext, scale, window, has_prev, dropout_rate, seed)


def _halo_bwd(
    q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, window: int, has_prev,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The halo backward: (dq, dk_ext, dv_ext), the dq kernel first."""
    args = (q, k_ext, v_ext, do, lse, delta, scale, window, has_prev, dropout_rate, seed)
    if q.is_cuda:
        dispatch_trace.record("flash_halo_bwd_cuda")
        scratch = halo_bwd_ds_cuda(*args)
        return ((halo_bwd_dq_cuda(scratch, k_ext, window, has_prev),)
                + halo_bwd_dkv_cuda(scratch, q, do, window, has_prev))
    dispatch_trace.record("flash_halo_bwd_plain")
    return (windowed_mha_halo_bwd_dq_reference(*args),) + windowed_mha_halo_bwd_dkv_reference(*args)


def _save_residuals(ctx, q, k, v, out, lse, scale: float, dropout_rate: float, seed: Seed) -> None:
    ctx.scale, ctx.dropout_rate = scale, dropout_rate
    ctx.seed = seed if not isinstance(seed, torch.Tensor) else None
    ctx.save_for_backward(q, k, v, out, lse, seed if isinstance(seed, torch.Tensor) else None)


def _residuals(ctx, do: torch.Tensor, views: bool = False):
    """(q, k, v, do, lse, delta) for the backward kernels, and the seed.
    ``views`` (the flash kernels): q, k, v, out and do stay as they are,
    (B, H, S, Dh) views or (BH, S, Dh), and only a ``do`` without unit
    stride along Dh is copied; else (the banded and halo kernels) they are
    made contiguous. delta = rowsum(do * out) in fp32, (B * H, S)."""
    q, k, v, out, lse, seed_t = ctx.saved_tensors
    if not views:
        q, k, v, out, do = (t.contiguous() for t in (q, k, v, out, do))
    elif do.stride(-1) != 1 and do.shape[-1] > 1:
        do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).reshape(lse.shape).contiguous()
    return (q, k, v, do, lse, delta), seed_t if seed_t is not None else ctx.seed


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash_attention``: the forward saves q, k, v,
    out, lse and the seed; the backward recomputes P in the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, dropout_rate, seed):
        out, lse = _flash_fwd(q, k, v, scale, dropout_rate, seed)
        _save_residuals(ctx, q, k, v, out, lse, scale, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        tensors, seed = _residuals(ctx, do, views=True)
        return _flash_bwd(*tensors, ctx.scale, ctx.dropout_rate, seed) + (None, None, None)


class _WindowedAttention(torch.autograd.Function):
    """The custom VJP of ``_windowed_attention``: as :class:`_FlashAttention`
    over the band of ``window``-token windows."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, dropout_rate, seed):
        out, lse = _win_fwd(q, k, v, scale, window, dropout_rate, seed)
        _save_residuals(ctx, q, k, v, out, lse, scale, dropout_rate, seed)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        tensors, seed = _residuals(ctx, do)
        dq, dk, dv = _win_bwd(*tensors, ctx.scale, ctx.window, ctx.dropout_rate, seed)
        return dq, dk, dv, None, None, None, None


class _HaloAttention(torch.autograd.Function):
    """The custom VJP of ``_windowed_attention_halo``: as
    :class:`_WindowedAttention` with k_ext and v_ext of S + w rows; the
    backward returns dk_ext and dv_ext, the halo window's gradient
    included, and none for ``has_prev``."""

    @staticmethod
    def forward(ctx, q, k_ext, v_ext, has_prev, scale, window, dropout_rate, seed):
        out, lse = _halo_fwd(q, k_ext, v_ext, scale, window, has_prev, dropout_rate, seed)
        _save_residuals(ctx, q, k_ext, v_ext, out, lse, scale, dropout_rate, seed)
        ctx.window, ctx.has_prev = window, has_prev
        return out

    @staticmethod
    def backward(ctx, do):
        (q, k_ext, v_ext, do, lse, delta), seed = _residuals(ctx, do)
        grads = _halo_bwd(q, k_ext, v_ext, do, lse, delta, ctx.scale, ctx.window, ctx.has_prev,
                          ctx.dropout_rate, seed)
        return grads + (None,) * 5


def _scale_seed(head_dim: int, scale: Optional[float], dropout_rate: float,
                dropout_seed: Seed) -> Tuple[float, Seed]:
    """The scale and the seed of the public wrappers."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    scale = 1.0 / math.sqrt(head_dim) if scale is None else scale
    seed = 0 if dropout_seed is None else dropout_seed
    return float(scale), seed if isinstance(seed, torch.Tensor) else int(seed)


def _flat_inputs(q, k, v, scale: Optional[float], dropout_rate: float, dropout_seed: Seed):
    """(BH, S, Dh) contiguous q, k, v, the scale and the seed of the banded
    wrapper."""
    b, h, s, dh = q.shape
    scale, seed = _scale_seed(dh, scale, dropout_rate, dropout_seed)
    flat = tuple(t.reshape(b * h, s, dh).contiguous() for t in (q, k, v))
    return flat, scale, seed


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Seed = None,
) -> torch.Tensor:
    """Flash attention over (B, H, S, Dh), no mask, differentiable.

    ``dropout_rate``/``dropout_seed``: attention-weight dropout inside the
    kernels; the seed is an int or a one-element int32 tensor (on the
    device, for no host sync), and the mask of batch-head ``bh`` equals
    ``attention_dropout_mask(dropout_seed, bh, S, S, rate)``.

    q, k, v may be views of any strides with unit stride along Dh, such as
    ``ops.attention._split_heads``' views of (B, S, D) tokens: the CUDA
    kernel reads them as they are and returns the (B, H, S, Dh) view of a
    (B, S, H, Dh) buffer; the backward kernels read the same views and the
    gradients come back the same way. Without a gradient to track, the
    forward runs without the autograd Function.

    Self-attention over one token count: k and v of another shape than q
    (a strided k/v projection) raise on either device, as JAX's ``mha``
    fails reshaping k to q's S.
    """
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mha takes q, k, v of one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale, seed = _scale_seed(q.shape[-1], scale, dropout_rate, dropout_seed)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, float(dropout_rate), seed)
    return _flash_fwd(q, k, v, scale, float(dropout_rate), seed)[0]


def windowed_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Seed = None,
) -> torch.Tensor:
    """Banded flash attention over (B, H, S, Dh), differentiable: each query
    window of ``window_size`` tokens attends to its own and the previous
    window (the kernel counterpart of ``ops.attention.sdpa_windowed``, with
    O(S * window) work). Any S: the last window may be partial. Dropout as
    in :func:`mha`, with the same global-index mask."""
    if window_size < 1:
        raise ValueError(f"windowed_mha needs window_size >= 1, got {window_size}")
    (qf, kf, vf), scale, seed = _flat_inputs(q, k, v, scale, dropout_rate, dropout_seed)
    out = _WindowedAttention.apply(qf, kf, vf, scale, int(window_size), float(dropout_rate), seed)
    return out.reshape(q.shape)


def windowed_mha_halo(
    q: torch.Tensor,
    k_ext: torch.Tensor,
    v_ext: torch.Tensor,
    *,
    window_size: int,
    has_prev,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Seed = None,
) -> torch.Tensor:
    """Banded flash attention with an explicit left-context window,
    differentiable: one shard of sequence-parallel windowed attention.

    q: (B, H, S, Dh); k_ext, v_ext: (B, H, S + window_size, Dh) whose first
    window is the context (the neighbour's halo). ``has_prev``: an int, a
    bool or a one-element integer tensor (on the device, for no host sync);
    0 masks the context window (the true sequence start). Equals
    :func:`windowed_mha` over the concatenated sequence with the first
    window's outputs dropped; with ``has_prev`` 0, ``windowed_mha`` over
    the local sequence. Gradients of k_ext and v_ext cover all S + w rows.
    Dropout as in :func:`windowed_mha`, the mask hashed at the shard-local
    (row, k_ext column - w). S must be a multiple of ``window_size``.
    """
    b, h, s, dh = q.shape
    w = int(window_size)
    if w < 1:
        raise ValueError(f"windowed_mha_halo needs window_size >= 1, got {window_size}")
    if s % w:
        raise ValueError(f"halo kernel needs S % window == 0; {s} % {w}")
    scale, seed = _scale_seed(dh, scale, dropout_rate, dropout_seed)
    qf = q.reshape(b * h, s, dh).contiguous()
    kf, vf = (t.reshape(b * h, s + w, dh).contiguous() for t in (k_ext, v_ext))
    prev = _has_prev_arg(has_prev, q.device)
    out = _HaloAttention.apply(qf, kf, vf, prev, scale, w, float(dropout_rate), seed)
    return out.reshape(q.shape)
