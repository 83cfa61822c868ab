"""Flash and banded attention: the Hopper kernels, their plain versions,
``mha`` and ``windowed_mha``.

Counterpart of ``tchvp_tpu/kernels/flash_attention.py``'s ``mha`` and
``windowed_mha`` with their custom VJPs. On a CUDA tensor :func:`_flash_fwd`
launches the hand-written forward ``csrc/flash_fwd.cu`` and
:func:`_flash_bwd` the two backward kernels of ``csrc/flash_bwd.cu`` (dq;
dk and dv); :func:`_win_fwd` and :func:`_win_bwd` launch the banded
kernels of ``csrc/band_attention.cu``, where query window i sees key
windows i-1 and i. All are built at first use by :mod:`.build`. On a CPU
tensor they run :func:`mha_reference`, :func:`mha_bwd_reference` and their
windowed counterparts, the dense fp32 versions of the same functions (the
band as a mask over the (S, S) logits). A CUDA tensor never reaches a plain
version, and a build or launch failure raises.

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
import math
from typing import Optional, Tuple, Union

import torch

from tchvp_tpu_torch.ops import dispatch_trace

_MASK32 = 0xFFFFFFFF

# Launches of each CUDA kernel in this process (never the plain versions);
# chip_smoke.py resets them around the main path.
launches = 0  # flash_fwd
dq_launches = 0  # flash_bwd_dq
dkv_launches = 0  # flash_bwd_dkv
band_fwd_launches = 0  # band_attention: forward
band_dq_launches = 0  # band_attention: dq
band_dkv_launches = 0  # band_attention: dk/dv

Seed = Union[int, torch.Tensor, None]


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


def _keep_mask(seed: Seed, bh: torch.Tensor, s_q: int, s_k: int, rate: float) -> torch.Tensor:
    """Keep mask of the batch-heads ``bh`` (int64, any shape): bool of
    shape ``bh.shape + (s_q, s_k)``, True = keep. ``seed``: an int or a
    one-element integer tensor."""
    device = bh.device
    seed_t = torch.as_tensor(seed).to(device=device, dtype=torch.int64).reshape(())
    row = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(s_k, dtype=torch.int64, device=device)[None, :]
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


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float,
            band: Optional[torch.Tensor]) -> torch.Tensor:
    """(BH, S, S) fp32 scaled logits; pairs outside ``band`` are -inf."""
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return logits if band is None else logits.masked_fill(~band, float("-inf"))


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0, band: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: dense fp32 softmax attention over
    (BH, S, Dh) -> (out (BH, S, Dh) in q's dtype, lse (BH, S) fp32).
    ``band``: an (S, S) bool mask of the pairs that may attend (all when
    None); every row must keep at least one."""
    bh, s, _ = q.shape
    logits = _logits(q, k, scale, band)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    w = p / l
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, torch.arange(bh, device=q.device), s, s, dropout_rate)
        w = w * keep / (1.0 - dropout_rate)
    out = torch.einsum("bqk,bkd->bqd", w, v.float())
    return out.to(q.dtype), lse


def _grad_weights(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, dropout_rate: float, seed: Seed,
    band: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ds, P_drop), (BH, S, S) fp32: P recomputed from ``lse`` (0 outside
    ``band``); with dropout the keep mask rides on dp, and P_drop is
    P * keep / (1 - rate)."""
    bh, s, _ = q.shape
    p = torch.exp(_logits(q, k, scale, band) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    p_drop = p
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, torch.arange(bh, device=q.device), s, s, dropout_rate)
        keep = keep.float() / (1.0 - dropout_rate)
        dp = dp * keep
        p_drop = p * keep
    return p * (dp - delta[..., None]) * scale, p_drop


def mha_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0, band: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the dq kernel: dq = ds k, in q's dtype."""
    ds, _ = _grad_weights(q, k, v, do, lse, delta, scale, dropout_rate, seed, band)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def mha_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0, band: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dk = ds^T q, dv = P_drop^T do."""
    ds, p_drop = _grad_weights(q, k, v, do, lse, delta, scale, dropout_rate, seed, band)
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p_drop, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def mha_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels: dense fp32 recompute of P
    from ``lse`` with their formulas, (BH, S, Dh) each -> (dq, dk, dv) in
    the inputs' dtype. ``delta`` = rowsum(do * out), (BH, S) fp32."""
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


# Each library's C launchers and their leading pointer arguments.
_LAUNCHERS = {
    "flash_fwd": {"tchvp_flash_fwd": 5},
    "flash_bwd": {"tchvp_flash_bwd_dq": 7, "tchvp_flash_bwd_dkv": 8},
    "band_attention": {"tchvp_band_fwd": 5, "tchvp_band_bwd_dq": 7, "tchvp_band_bwd_dkv": 8},
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    """Build (once) and bind ``csrc/<name>.cu``'s C launchers: pointers,
    then (BH, S, Dh[, window], is_bf16), scale, rate, threshold, seed and
    stream."""
    from tchvp_tpu_torch.kernels import build

    lib = build.load(name, [f"{name}.cu"])
    if lib.tchvp_cuda_error_string.restype is not ctypes.c_char_p:
        ints = 5 if name == "band_attention" else 4
        tail = [ctypes.c_int] * ints + [ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                                        ctypes.c_void_p, ctypes.c_void_p]
        for fn, pointers in _LAUNCHERS[name].items():
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * pointers + tail
            getattr(lib, fn).restype = ctypes.c_int
        lib.tchvp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tchvp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(ref: torch.Tensor, window: Optional[int], **tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: dtype, shape, device, layout,
    head dim, window."""
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {ref.dtype}")
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (BH, S, Dh)")
    if not 1 <= ref.shape[2] <= 1280:
        raise ValueError(f"flash kernels take head dims 1..1280, got {ref.shape[2]}")
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


def _scalars(q: torch.Tensor, window: Optional[int], scale: float, dropout_rate: float,
             seed_ptr: int) -> tuple:
    """The launchers' arguments after the pointers, the stream aside. The
    banded launchers take a window of 1..S; one of S or more holds every
    pair, as one of S does."""
    bh, s, dh = q.shape
    dims = (bh, s, dh) if window is None else (bh, s, dh, min(int(window), s))
    return dims + (int(q.dtype == torch.bfloat16), float(scale), float(dropout_rate),
                   _drop_threshold(dropout_rate), seed_ptr)


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                dropout_rate: float, seed: Seed, window: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` (``window`` None) or
    ``csrc/band_attention.cu``'s forward on the current stream."""
    _check_inputs(q, window, q=q, k=k, v=v)
    bh, s, _ = q.shape
    name = "flash_fwd" if window is None else "band_attention"
    lib = _kernel_lib(name)
    launch = lib.tchvp_flash_fwd if window is None else lib.tchvp_band_fwd
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    seed_ptr, _keep_alive = _seed_arg(seed, dropout_rate, q.device)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     *_scalars(q, window, scale, dropout_rate, seed_ptr),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, name)
    return out, lse


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    global launches
    result = _launch_fwd(q, k, v, scale, dropout_rate, seed, None)
    launches += 1
    return result


def band_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int,
    dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the banded forward kernel (grid: batch-head x 16-row
    query tile, each walking its tile's key span)."""
    global band_fwd_launches
    result = _launch_fwd(q, k, v, scale, dropout_rate, seed, window)
    band_fwd_launches += 1
    return result


def _flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (BH, S, Dh) -> (out (BH, S, Dh), lse (BH, S) fp32)."""
    if q.is_cuda:
        dispatch_trace.record("flash_mha_cuda")
        return _flash_fwd_cuda(q, k, v, scale, dropout_rate, seed)
    dispatch_trace.record("flash_mha_plain")
    return mha_reference(q, k, v, scale, dropout_rate, seed)


def _win_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, window: int,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded q, k, v: (BH, S, Dh) -> (out (BH, S, Dh), lse (BH, S) fp32)."""
    if q.is_cuda:
        dispatch_trace.record("flash_windowed_cuda")
        return band_fwd_cuda(q, k, v, scale, window, dropout_rate, seed)
    dispatch_trace.record("flash_windowed_plain")
    return windowed_mha_reference(q, k, v, scale, window, dropout_rate, seed)


def _launch_bwd(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, outs,
                scale: float, dropout_rate: float, seed: Seed, window: Optional[int]) -> None:
    """Launch the ``which`` kernel ("dq" or "dkv") of ``csrc/flash_bwd.cu``
    (``window`` None) or ``csrc/band_attention.cu`` into ``outs`` on the
    current stream."""
    _check_inputs(q, window, q=q, k=k, v=v, do=do)
    bh, s, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, s) or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 (BH, S) on {q.device}")
    name = "flash_bwd" if window is None else "band_attention"
    lib = _kernel_lib(name)
    launch = getattr(lib, f"tchvp_{'flash' if window is None else 'band'}_bwd_{which}")
    seed_ptr, _keep_alive = _seed_arg(seed, dropout_rate, q.device)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), *(t.data_ptr() for t in outs),
                     *_scalars(q, window, scale, dropout_rate, seed_ptr),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, f"{name} {which}")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, dropout_rate: float,
                      seed: Seed) -> torch.Tensor:
    """dq of the dq kernel (grid: batch-head x 16-row query tile)."""
    global dq_launches
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), scale, dropout_rate, seed, None)
    dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, dropout_rate: float,
                       seed: Seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the dk/dv kernel (grid: batch-head x 8-key tile)."""
    global dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), scale, dropout_rate, seed, None)
    dkv_launches += 1
    return dk, dv


def band_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, window: int,
                     dropout_rate: float, seed: Seed) -> torch.Tensor:
    """dq of the banded dq kernel (each query tile walks its key span)."""
    global band_dq_launches
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), scale, dropout_rate, seed, window)
    band_dq_launches += 1
    return dq


def band_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, window: int,
                      dropout_rate: float, seed: Seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the banded dk/dv kernel (each 8-key tile walks the query
    rows of its window and the next)."""
    global band_dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), scale, dropout_rate, seed, window)
    band_dkv_launches += 1
    return dk, dv


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
    """(BH, S, Dh) q, k, v, do and (BH, S) fp32 lse, delta -> (dq, dk, dv)."""
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
        return (band_bwd_dq_cuda(*args),) + band_bwd_dkv_cuda(*args)
    dispatch_trace.record("flash_windowed_bwd_plain")
    return (windowed_mha_bwd_dq_reference(*args),) + windowed_mha_bwd_dkv_reference(*args)


def _save_residuals(ctx, q, k, v, out, lse, scale: float, dropout_rate: float, seed: Seed) -> None:
    ctx.scale, ctx.dropout_rate = scale, dropout_rate
    ctx.seed = seed if not isinstance(seed, torch.Tensor) else None
    ctx.save_for_backward(q, k, v, out, lse, seed if isinstance(seed, torch.Tensor) else None)


def _residuals(ctx, do: torch.Tensor):
    """(q, k, v, do, lse, delta) for the backward kernels, and the seed."""
    q, k, v, out, lse, seed_t = ctx.saved_tensors
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
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
        tensors, seed = _residuals(ctx, do)
        dq, dk, dv = _flash_bwd(*tensors, ctx.scale, ctx.dropout_rate, seed)
        return dq, dk, dv, None, None, None


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


def _flat_inputs(q, k, v, scale: Optional[float], dropout_rate: float, dropout_seed: Seed):
    """(BH, S, Dh) q, k, v, the scale and the seed of the public wrappers."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    b, h, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    seed = 0 if dropout_seed is None else dropout_seed
    if not isinstance(seed, torch.Tensor):
        seed = int(seed)
    flat = tuple(t.reshape(b * h, s, dh).contiguous() for t in (q, k, v))
    return flat, float(scale), seed


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
    """
    (qf, kf, vf), scale, seed = _flat_inputs(q, k, v, scale, dropout_rate, dropout_seed)
    out = _FlashAttention.apply(qf, kf, vf, scale, float(dropout_rate), seed)
    return out.reshape(q.shape)


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
