"""Flash-attention forward: the Hopper kernel, its plain version, and ``mha``.

Counterpart of ``tchvp_tpu/kernels/flash_attention.py`` (the forward of
``mha``). On a CUDA tensor :func:`_flash_fwd` launches the hand-written
kernel ``csrc/flash_fwd.cu`` (built at first use by :mod:`.build`); on a
CPU tensor it runs :func:`mha_reference`, the dense fp32 version of the
same function. A CUDA tensor never reaches the plain version, and a build
or launch failure raises.

Attention-weight dropout uses the TPU kernel's counter-based mask: a
squirrel3 hash of the global (row, col) index of the (S, S) weight matrix,
seeded per call, so the mask here is bit for bit the JAX package's
``attention_dropout_mask``. Torch has no full uint32 arithmetic, so the
plain version computes the hash in int64 and keeps the low 32 bits.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tchvp_tpu_torch.ops import dispatch_trace

_MASK32 = 0xFFFFFFFF

# Launches of the CUDA kernel in this process (never counts the plain
# version); chip_smoke.py resets it around the main path.
launches = 0


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


def _keep_mask(seed: int, bh: torch.Tensor, s_q: int, s_k: int, rate: float) -> torch.Tensor:
    """Keep mask of the batch-heads ``bh`` (int64, any shape): bool of
    shape ``bh.shape + (s_q, s_k)``, True = keep."""
    device = bh.device
    row = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(s_k, dtype=torch.int64, device=device)[None, :]
    base = (_mul32(torch.tensor(seed & _MASK32, dtype=torch.int64, device=device), 0x9E3779B1)
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
    dropout_rate: float = 0.0, seed: int = 0,
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


def _kernel_lib() -> ctypes.CDLL:
    """Build (once) and bind ``csrc/flash_fwd.cu``'s C launcher."""
    from tchvp_tpu_torch.kernels import build

    lib = build.load("flash_fwd", ["flash_fwd.cu"])
    if lib.tchvp_flash_fwd.argtypes is None:
        lib.tchvp_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.tchvp_flash_fwd.restype = ctypes.c_int
        lib.tchvp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tchvp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float, seed: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    global launches
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does not match q")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (BH, S, Dh)")
    bh, s, dh = q.shape
    if not 1 <= dh <= 1280:
        raise ValueError(f"flash kernel takes head dims 1..1280, got {dh}")
    lib = _kernel_lib()
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tchvp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, s, dh, int(q.dtype == torch.bfloat16), float(scale), float(dropout_rate),
            _drop_threshold(dropout_rate), seed & _MASK32, stream,
        )
    if err != 0:
        msg = lib.tchvp_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cudaError {err})")
    launches += 1
    return out, lse


def _flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (BH, S, Dh) -> (out (BH, S, Dh), lse (BH, S) fp32)."""
    if q.is_cuda:
        dispatch_trace.record("flash_mha_cuda")
        return _flash_fwd_cuda(q, k, v, scale, dropout_rate, seed)
    dispatch_trace.record("flash_mha_plain")
    return mha_reference(q, k, v, scale, dropout_rate, seed)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, dropout_rate, seed):
        out, _ = _flash_fwd(q, k, v, scale, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash attention backward is not ported yet "
            "(ROADMAP.md, TPU kernels to port, item 2: mha backward)"
        )


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over (B, H, S, Dh), no mask.

    ``dropout_rate``/``dropout_seed``: attention-weight dropout inside the
    kernel; the mask of batch-head ``bh`` equals
    ``attention_dropout_mask(dropout_seed, bh, S, S, rate)``.
    """
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    b, h, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    seed = 0 if dropout_seed is None else int(dropout_seed)
    qf, kf, vf = (t.reshape(b * h, s, dh).contiguous() for t in (q, k, v))
    out = _FlashAttention.apply(qf, kf, vf, float(scale), float(dropout_rate), seed)
    return out.reshape(b, h, s, dh)
