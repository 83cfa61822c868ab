"""Flash attention: the Hopper kernels, their plain versions, and ``mha``.

Counterpart of ``tchvp_tpu/kernels/flash_attention.py``'s ``mha`` with its
custom VJP. On a CUDA tensor :func:`_flash_fwd` launches the hand-written
forward ``csrc/flash_fwd.cu`` and :func:`_flash_bwd` the two backward
kernels of ``csrc/flash_bwd.cu`` (dq; dk and dv), all built at first use by
:mod:`.build`; on a CPU tensor they run :func:`mha_reference` and
:func:`mha_bwd_reference`, the dense fp32 versions of the same functions.
A CUDA tensor never reaches a plain version, and a build or launch failure
raises.

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


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: dense fp32 softmax attention over
    (BH, S, Dh) -> (out (BH, S, Dh) in q's dtype, lse (BH, S) fp32)."""
    bh, s, _ = q.shape
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ds, P_drop), (BH, S, S) fp32: P recomputed from ``lse``; with
    dropout the keep mask rides on dp, and P_drop is P * keep / (1 - rate)."""
    bh, s, _ = q.shape
    p = torch.exp(torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale - lse[..., None])
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
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> torch.Tensor:
    """Plain version of the dq kernel: dq = ds k, in q's dtype."""
    ds, _ = _grad_weights(q, k, v, do, lse, delta, scale, dropout_rate, seed)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def mha_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: Seed = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dk = ds^T q, dv = P_drop^T do."""
    ds, p_drop = _grad_weights(q, k, v, do, lse, delta, scale, dropout_rate, seed)
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


def _kernel_lib(name: str) -> ctypes.CDLL:
    """Build (once) and bind ``csrc/<name>.cu``'s C launchers."""
    from tchvp_tpu_torch.kernels import build

    lib = build.load(name, [f"{name}.cu"])
    if lib.tchvp_cuda_error_string.restype is not ctypes.c_char_p:
        tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                                     ctypes.c_void_p, ctypes.c_void_p]
        if name == "flash_fwd":
            lib.tchvp_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
            lib.tchvp_flash_fwd.restype = ctypes.c_int
        else:
            lib.tchvp_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
            lib.tchvp_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
            lib.tchvp_flash_bwd_dq.restype = lib.tchvp_flash_bwd_dkv.restype = ctypes.c_int
        lib.tchvp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tchvp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: dtype, shape, device, layout."""
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {ref.dtype}")
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (BH, S, Dh)")
    if not 1 <= ref.shape[2] <= 1280:
        raise ValueError(f"flash kernels take head dims 1..1280, got {ref.shape[2]}")


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


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float, seed: Seed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    global launches
    _check_inputs(q, q=q, k=k, v=v)
    bh, s, dh = q.shape
    lib = _kernel_lib("flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    seed_ptr, _keep_alive = _seed_arg(seed, dropout_rate, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tchvp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, s, dh, int(q.dtype == torch.bfloat16), float(scale), float(dropout_rate),
            _drop_threshold(dropout_rate), seed_ptr, stream,
        )
    _raise_on(lib, err, "flash_fwd")
    launches += 1
    return out, lse


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


def _launch_bwd(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, outs,
                scale: float, dropout_rate: float, seed: Seed) -> None:
    """Launch ``csrc/flash_bwd.cu``'s ``which`` kernel ("dq" or "dkv")
    into ``outs`` on the current stream."""
    _check_inputs(q, q=q, k=k, v=v, do=do)
    bh, s, dh = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, s) or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 (BH, S) on {q.device}")
    lib = _kernel_lib("flash_bwd")
    seed_ptr, _keep_alive = _seed_arg(seed, dropout_rate, q.device)
    launch = lib.tchvp_flash_bwd_dq if which == "dq" else lib.tchvp_flash_bwd_dkv
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), *(t.data_ptr() for t in outs), bh, s, dh,
                     int(q.dtype == torch.bfloat16), float(scale), float(dropout_rate),
                     _drop_threshold(dropout_rate), seed_ptr,
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, f"flash_bwd_{which}")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, dropout_rate: float,
                      seed: Seed) -> torch.Tensor:
    """dq of the dq kernel (grid: batch-head x 16-row query tile)."""
    global dq_launches
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), scale, dropout_rate, seed)
    dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, dropout_rate: float,
                       seed: Seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the dk/dv kernel (grid: batch-head x 8-key tile)."""
    global dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), scale, dropout_rate, seed)
    dkv_launches += 1
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


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash_attention``: the forward saves q, k, v,
    out, lse and the seed; the backward recomputes P in the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, dropout_rate, seed):
        out, lse = _flash_fwd(q, k, v, scale, dropout_rate, seed)
        ctx.scale, ctx.dropout_rate = scale, dropout_rate
        ctx.seed = seed if not isinstance(seed, torch.Tensor) else None
        ctx.save_for_backward(q, k, v, out, lse, seed if isinstance(seed, torch.Tensor) else None)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seed_t = ctx.saved_tensors
        seed = seed_t if seed_t is not None else ctx.seed
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq, dk, dv = _flash_bwd(q, k, v, do, lse, delta, ctx.scale, ctx.dropout_rate, seed)
        return dq, dk, dv, None, None, None


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
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    b, h, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    seed = 0 if dropout_seed is None else dropout_seed
    if not isinstance(seed, torch.Tensor):
        seed = int(seed)
    qf, kf, vf = (t.reshape(b * h, s, dh).contiguous() for t in (q, k, v))
    out = _FlashAttention.apply(qf, kf, vf, float(scale), float(dropout_rate), seed)
    return out.reshape(b, h, s, dh)
