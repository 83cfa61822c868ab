"""Persistent block-size autotuner of the Hopper attention kernels.

Counterpart of ``tchvp_tpu/kernels/autotune.py``. The kernels of
``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` (query rows per block and keys
per tile) and of ``csrc/band_attention.cu``, ``csrc/halo_attention.cu``
(query rows per tile) are instantiated for every block candidate of
:mod:`.flash_attention` (``FLASH_BLOCKS``, ``WIN_BLOCKS``):

* :func:`tune_flash` / :func:`tune_banded` time the candidates on the card
  (:func:`tchvp_tpu_torch.utils.timing.timeit`) and persist the winner;
* the wrappers ``mha``, ``windowed_mha`` and ``windowed_mha_halo`` resolve
  their blocks through :func:`flash_blocks` / :func:`band_rows` on the host,
  once a call: the explicit arguments, then the cache, then the shipped
  defaults (the port's own tiles, 64 rows and 64 keys). A tuned process,
  and every later process on the machine, launches the tuned blocks.

Cache: one JSON file at ``$TCHVP_AUTOTUNE_CACHE`` or
``~/.cache/tchvp_tpu_torch/autotune.json``, keyed as JAX's,
``device_kind|kernel|BxHxSxDh|wW|dtype`` (the device kind is the card's
name with spaces as ``_``, ``cpu`` for CPU tensors; dtypes by JAX's names,
``bfloat16``, ``float32``). ``TCHVP_AUTOTUNE_CACHE=0`` disables it. Entries
keep the measured ms and mode. The file is replaced atomically. Drive it by
``python -m tchvp_tpu_torch.cli tune``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

_DEFAULT_PATH = os.path.join(os.path.expanduser("~"), ".cache", "tchvp_tpu_torch", "autotune.json")

_lock = threading.Lock()
_cache: Optional[Dict[str, dict]] = None
_cache_path: Optional[str] = None
# Resolved blocks of a (kernel, shape, window, dtype, device, explicit
# arguments): emptied whenever the cache is (re)read or written.
_resolved: Dict[tuple, tuple] = {}
_device_kinds: Dict[Optional[int], str] = {}


def cache_path() -> Optional[str]:
    """Resolved cache file path, or None when disabled."""
    env = os.environ.get("TCHVP_AUTOTUNE_CACHE")
    if env == "0":
        return None
    return env or _DEFAULT_PATH


def _load() -> Dict[str, dict]:
    global _cache, _cache_path
    path = cache_path()
    with _lock:
        if _cache is not None and path == _cache_path:
            return _cache
        _cache_path = path
        _cache = {}
        _resolved.clear()
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    _cache = data
            except (OSError, ValueError):
                pass  # an unreadable cache is an empty cache
        return _cache


def reload() -> None:
    """Drop the in-memory cache (tests; after another process's tune)."""
    global _cache
    with _lock:
        _cache = None
        _resolved.clear()


def _device_kind(device=None) -> str:
    """The card's name with spaces as ``_``; ``cpu`` for the CPU."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return device.type
    kind = _device_kinds.get(device.index)
    if kind is None:
        try:
            kind = torch.cuda.get_device_name(device).replace(" ", "_")
        except (RuntimeError, AssertionError):
            kind = "unknown"
        _device_kinds[device.index] = kind
    return kind


def dtype_name(dtype) -> str:
    """JAX's name of a dtype: ``bfloat16``, ``float32`` (strings pass)."""
    return dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")


def _key(kernel: str, shape: Sequence[int], window: int, dtype, device=None) -> str:
    b, h, s, dh = shape
    return f"{_device_kind(device)}|{kernel}|{b}x{h}x{s}x{dh}|w{window}|{dtype_name(dtype)}"


def lookup(kernel: str, shape: Sequence[int], window: int, dtype, device=None) -> Optional[dict]:
    """Tuned params for (kernel, shape, window, dtype) or None."""
    if cache_path() is None:
        return None
    entry = _load().get(_key(kernel, shape, window, dtype, device))
    return dict(entry["params"]) if entry else None


def record(kernel: str, shape: Sequence[int], window: int, dtype, params: dict, ms: float, mode: str,
           device=None) -> None:
    """Persist a measured winner (overwrites any previous entry), written to
    a temporary file and renamed into place."""
    path = cache_path()
    if path is None:
        return
    key = _key(kernel, shape, window, dtype, device)
    cache = _load()
    with _lock:
        cache[key] = {"params": params, "ms": round(ms, 4), "mode": mode}
        _resolved.clear()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Host-side resolution, once a call (the kernel wrappers)
# ---------------------------------------------------------------------------


def _resolve(memo: tuple, resolve):
    """The memoised ``resolve()`` of ``memo`` (a call's kernel, shape, window,
    dtype, device and explicit blocks): a wrapper's host cost a call is one
    dict lookup. A symbolic shape (under ``torch.export``) does not hash; it
    resolves without the cache, whose keys are concrete shapes."""
    try:
        hit = _resolved.get(memo)
    except TypeError:
        return resolve(cached=False)
    if hit is None:
        hit = _resolved[memo] = resolve(cached=True)
    return hit


def flash_blocks(shape: Sequence[int], dtype, block_q: Optional[int], block_k: Optional[int],
                 device=None) -> Tuple[int, int]:
    """(block_q, block_k) of the flash kernels: explicit args win, then the
    tuned cache, then the shipped defaults. A pair outside the candidates
    raises ``ValueError``. After changing ``TCHVP_AUTOTUNE_CACHE`` in a
    running process, call :func:`reload`."""
    def resolve(cached: bool) -> Tuple[int, int]:
        from tchvp_tpu_torch.kernels import flash_attention as fa

        tuned = (lookup("flash", shape, 0, dtype, device) if cached and (block_q is None or block_k is None)
                 else None) or {}
        blocks = (block_q or tuned.get("block_q", fa.DEFAULT_BLOCK_Q),
                  block_k or tuned.get("block_k", fa.DEFAULT_BLOCK_K))
        if blocks not in fa.FLASH_BLOCKS:
            raise ValueError(f"flash blocks (block_q, block_k) = {blocks} are not instantiated; "
                             f"the kernels take {fa.FLASH_BLOCKS}")
        return blocks

    return _resolve(("flash", shape, dtype, device, block_q, block_k), resolve)


def band_rows(kernel: str, shape: Sequence[int], window: int, dtype, block_rows: Optional[int],
              device=None) -> int:
    """block_rows of the banded or halo kernels (``kernel`` "band" or
    "halo"): explicit arg, tuned cache, shipped default; a value outside
    the candidates raises ``ValueError``."""
    def resolve(cached: bool) -> int:
        from tchvp_tpu_torch.kernels import flash_attention as fa

        rows = block_rows
        if rows is None:
            tuned = (lookup(kernel, shape, window, dtype, device) if cached else None) or {}
            rows = tuned.get("block_rows", fa.DEFAULT_BAND_ROWS)
        if rows not in fa.WIN_BLOCKS:
            raise ValueError(f"{kernel} block_rows {rows} is not instantiated; the kernels take {fa.WIN_BLOCKS}")
        return rows

    return _resolve((kernel, shape, window, dtype, device, block_rows), resolve)


# ---------------------------------------------------------------------------
# Tuners
# ---------------------------------------------------------------------------


def _measure(fn, *args, mode: str, iters: int) -> float:
    """Device ms per call of ``fn`` (fwd) or of its forward and the gradients
    of every input (fwdbwd)."""
    from tchvp_tpu_torch.utils.timing import timeit

    if mode == "fwdbwd":
        def run(*a):
            out = fn(*a).float().mean()
            grads = torch.autograd.grad(out, a)
            return out + sum(g.float().mean() for g in grads)
    else:
        def run(*a):
            with torch.no_grad():
                return fn(*a)
    ms, _ = timeit(run, *args, iters=iters)
    return ms


def _rand_qkv(shape, dtype, extra_k: int = 0, device="cuda"):
    """Seeded q, k, v of ``shape`` (k and v ``extra_k`` rows longer), leaves
    that require a gradient."""
    b, h, s, dh = shape
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype_name(dtype))

    def make(rows):
        return torch.from_numpy(rng.normal(size=(b, h, rows, dh)).astype(np.float32)).to(
            device=device, dtype=dt).requires_grad_()

    return make(s), make(s + extra_k), make(s + extra_k)


def tune_flash(shape: Sequence[int], dtype="bfloat16", *, mode: str = "fwdbwd", iters: int = 20,
               candidates: Optional[Iterable[Tuple[int, int]]] = None, verbose: bool = True,
               device="cuda") -> Tuple[dict, float]:
    """Sweep (block_q, block_k) of the flash kernels at ``shape`` on the card;
    persist and return the winner. A candidate that raises (a shape the
    card cannot launch) is skipped and printed as failed."""
    from tchvp_tpu_torch.kernels import flash_attention as fa

    q, k, v = _rand_qkv(shape, dtype, device=device)
    best: Optional[Tuple[float, dict]] = None
    for bq, bk in (candidates or fa.FLASH_BLOCKS):
        if bq > shape[2] and bk > shape[2] and best is not None:
            continue  # both past S: the same work as an earlier point
        try:
            ms = _measure(lambda a, b_, c, bq=bq, bk=bk: fa.mha(a, b_, c, block_q=bq, block_k=bk),
                          q, k, v, mode=mode, iters=iters)
        except Exception as e:  # a block the card cannot run at this shape
            if verbose:
                print(f"  ({bq},{bk}): FAILED {type(e).__name__}: {e}", flush=True)
            continue
        if verbose:
            print(f"  ({bq},{bk}): {ms:.4f} ms", flush=True)
        if best is None or ms < best[0]:
            best = (ms, {"block_q": bq, "block_k": bk})
    if best is None:
        raise RuntimeError("every flash candidate failed")
    record("flash", shape, 0, dtype, best[1], best[0], mode, q.device)
    return best[1], best[0]


def tune_banded(shape: Sequence[int], window: int, dtype="bfloat16", *, halo: bool = False,
                mode: str = "fwdbwd", iters: int = 20, candidates: Optional[Iterable[int]] = None,
                verbose: bool = True, device="cuda") -> Tuple[dict, float]:
    """Sweep block_rows of the banded (or, ``halo``, the per-shard halo)
    kernels at ``shape`` and ``window``; as :func:`tune_flash`."""
    from tchvp_tpu_torch.kernels import flash_attention as fa

    kernel = "halo" if halo else "band"
    q, k, v = _rand_qkv(shape, dtype, extra_k=window if halo else 0, device=device)
    best: Optional[Tuple[float, dict]] = None
    for br in (candidates or fa.WIN_BLOCKS):
        if br > shape[2] and best is not None:
            continue
        if halo:
            fn = lambda a, b_, c, br=br: fa.windowed_mha_halo(  # noqa: E731
                a, b_, c, window_size=window, has_prev=1, block_rows=br)
        else:
            fn = lambda a, b_, c, br=br: fa.windowed_mha(a, b_, c, window_size=window, block_rows=br)  # noqa: E731
        try:
            ms = _measure(fn, q, k, v, mode=mode, iters=iters)
        except Exception as e:
            if verbose:
                print(f"  block_rows {br}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        if verbose:
            print(f"  block_rows {br}: {ms:.4f} ms", flush=True)
        if best is None or ms < best[0]:
            best = (ms, {"block_rows": br})
    if best is None:
        raise RuntimeError(f"every {kernel} candidate failed")
    record(kernel, shape, window, dtype, best[1], best[0], mode, q.device)
    return best[1], best[0]
