"""ClipPack: packed clip storage and the native prefetching loader.

Counterpart of ``tchvp_tpu/data/clippack.py``, with the same file format,
the same shuffle and the same batches. Clips are decoded once (offline,
:func:`pack_clips` / :func:`pack_from_manifest`) into one mmap-able uint8
file; at train time the C++ loader of ``native/clippack.cc`` assembles
shuffled batches on worker threads into a bounded ring, off the GIL, so
host IO overlaps the card's work. :class:`ClipPackDataset` yields ``(B, T,
H, W, C)`` uint8 numpy batches, the contract of
:class:`tchvp_tpu_torch.data.manifest.ClipDataset`.

The library is built with ``g++`` at first use into
``tchvp_tpu_torch/_build/`` (``kernels/build.py::load_host``). Nothing falls
back: with ``prefer_native=True`` (the default) a failed build or load
raises; the numpy reader runs only when the caller passes
``prefer_native=False``.

Deterministic: epoch ``e`` is shuffled with seed ``seed + e`` on both paths
(the same mt19937_64 Fisher-Yates), so their batches match bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from tchvp_tpu_torch.kernels import build

_MAGIC = 0x4B504C43  # 'CLPK'
_VERSION = 1
_HEADER_INTS = 8

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "clippack.cc"


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def pack_clips(path: str, clips: np.ndarray) -> None:
    """Write (N, T, H, W, C) uint8 clips to a clippack file."""
    clips = np.ascontiguousarray(clips, dtype=np.uint8)
    if clips.ndim != 5:
        raise ValueError(f"expected (N, T, H, W, C), got {clips.shape}")
    header = np.array([_MAGIC, _VERSION, *clips.shape, 0], dtype="<i8")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(clips.tobytes())


def pack_from_manifest(
    csv_file: str,
    out_path: str,
    image_size: int = 256,
    clip_len: Optional[int] = None,
) -> Tuple[int, int]:
    """Decode a clip CSV manifest (one row = one clip of frame paths) into
    a clippack file; returns (n_clips, clip_len). One-time offline cost."""
    from tchvp_tpu_torch.data.manifest import ClipDataset

    ds = ClipDataset(
        csv_file, batch_size=1, image_size=image_size, clip_len=clip_len,
        shuffle=False,
    )
    clips = [batch[0] for batch in ds]
    if not clips:
        raise ValueError(f"no complete clips in {csv_file}")
    arr = np.stack(clips)
    pack_clips(out_path, arr)
    return arr.shape[0], arr.shape[1]


# ---------------------------------------------------------------------------
# Native library
# ---------------------------------------------------------------------------


def load_native() -> ctypes.CDLL:
    """Build (once per content hash) and bind ``native/clippack.cc``; raises
    if it cannot be built or loaded."""
    lib = build.load_host("clippack", NATIVE_SRC)
    lib.clippack_open.restype = ctypes.c_void_p
    lib.clippack_open.argtypes = [ctypes.c_char_p]
    lib.clippack_info.restype = ctypes.c_int
    lib.clippack_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.clippack_read.restype = ctypes.c_int
    lib.clippack_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.clippack_close.restype = None
    lib.clippack_close.argtypes = [ctypes.c_void_p]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int64
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


# ---------------------------------------------------------------------------
# Shuffle parity with the C++ runtime
# ---------------------------------------------------------------------------


class _MT19937_64:
    """Minimal std::mt19937_64 (for bit-exact shuffle parity with C++)."""

    N, M = 312, 156
    MATRIX_A = 0xB5026F5AA96619E9
    UPPER = 0xFFFFFFFF80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int):
        self.mt = [0] * self.N
        self.mt[0] = seed & 0xFFFFFFFFFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (
                6364136223846793005 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 62)) + i
            ) & 0xFFFFFFFFFFFFFFFF
        self.mti = self.N

    def next(self) -> int:
        if self.mti >= self.N:
            for i in range(self.N):
                x = (self.mt[i] & self.UPPER) | (self.mt[(i + 1) % self.N] & self.LOWER)
                xa = (x >> 1) ^ (self.MATRIX_A if x & 1 else 0)
                self.mt[i] = self.mt[(i + self.M) % self.N] ^ xa
            self.mti = 0
        y = self.mt[self.mti]
        self.mti += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y


def _uniform_int(rng: _MT19937_64, b: int) -> int:
    """libstdc++ std::uniform_int_distribution<int64>(0, b) draw."""
    # Range = b + 1; libstdc++ downscales a 64-bit draw by rejection.
    rng_range = 0xFFFFFFFFFFFFFFFF  # mt19937_64 max - min = 2^64 - 1
    if b == rng_range:
        return rng.next()
    uerange = b + 1
    scaling = rng_range // uerange
    limit = uerange * scaling
    while True:
        v = rng.next()
        if v < limit:
            return v // scaling


def epoch_permutation(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    """The exact permutation the C++ loader uses for ``epoch``."""
    perm = np.arange(n, dtype=np.int64)
    if shuffle:
        rng = _MT19937_64((seed + epoch) & 0xFFFFFFFFFFFFFFFF)
        for i in range(n - 1, 0, -1):
            j = _uniform_int(rng, i)
            perm[i], perm[j] = perm[j], perm[i]
    return perm


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class ClipPackDataset:
    """Iterate shuffled (B, T, H, W, C) uint8 batches from a clippack file.

    The native threaded loader by default; ``prefer_native=False`` takes
    the numpy mmap reader, which gives the same batches. Iterating again
    continues to the next epoch (fresh shuffle).

    Multi-host input sharding (``shard_id``/``num_shards``): every host
    shares (seed, shuffle) so all see the same epoch permutation; host i
    assembles only slice i of each *global* batch (``batch_size *
    num_shards`` clips). Concatenating the shards reproduces the
    single-host batch exactly.
    """

    def __init__(
        self,
        path: str,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_threads: int = 4,
        prefer_native: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.path = path
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._epoch = 0
        self._consumed = 0  # batches taken from the native ring this epoch
        self._seeked = False  # _consumed is a seek target, not abandonment
        self._native = prefer_native
        self._loader = self._reader = None

        if self._native:
            self._lib = load_native()
            self._reader = self._lib.clippack_open(path.encode())
            if not self._reader:
                raise OSError(f"not a clippack file: {path}")
            info = (ctypes.c_int64 * 5)()
            self._lib.clippack_info(self._reader, info)
            self.n, self.t, self.h, self.w, self.c = (int(v) for v in info)
            if batch_size * num_shards > self.n:
                self.close()
                raise ValueError(f"global batch {batch_size * num_shards} > {self.n} clips")
            self._loader = self._create_loader(seed)
        else:
            header = np.fromfile(path, dtype="<i8", count=_HEADER_INTS)
            if header.size != _HEADER_INTS or header[0] != _MAGIC or header[1] != _VERSION:
                raise OSError(f"not a clippack file: {path}")
            self.n, self.t, self.h, self.w, self.c = (int(v) for v in header[2:7])
            self._mm = np.memmap(
                path,
                dtype=np.uint8,
                mode="r",
                offset=_HEADER_INTS * 8,
                shape=(self.n, self.t, self.h, self.w, self.c),
            )
            if batch_size * num_shards > self.n:
                raise ValueError(f"global batch {batch_size * num_shards} > {self.n} clips")

    def _create_loader(self, seed: int):
        loader = self._lib.loader_create(
            self._reader, self.batch_size, int(self.shuffle), seed, self.num_threads, 0,
            self.shard_id, self.num_shards,
        )
        if not loader:
            raise RuntimeError("clippack native loader creation failed")
        return loader

    def _next_native(self, out: np.ndarray) -> None:
        """One batch from the ring into ``out``. After a failure the ring's
        position is unknown, so the loader is rebuilt at the next epoch
        (mt19937_64(seed + e) starts epoch e exactly) before raising: the
        broken epoch is abandoned, as an abandoned iterator's would be."""
        if self._lib.loader_next(self._loader, _ptr(out)) < 0:
            self._lib.loader_destroy(self._loader)
            self._epoch += 1
            self._consumed = 0
            self._loader = self._create_loader(self.seed + self._epoch)
            raise RuntimeError("clippack native loader failed")

    def _batch_buffer(self) -> np.ndarray:
        return np.empty((self.batch_size, self.t, self.h, self.w, self.c), np.uint8)

    def position(self) -> dict:
        """Checkpointable iteration position: the NEXT batch this dataset
        will serve is ``batch`` of (data-)epoch ``epoch``. Hand it to
        :meth:`seek` after a restore to resume mid-epoch without replaying
        or skipping batches."""
        if self._consumed >= len(self):
            # Transient state during the final batch's consumer body (the
            # generator's finally-roll has not run yet): the next batch is
            # the first of the next epoch.
            return {"epoch": self._epoch + 1, "batch": 0}
        return {"epoch": self._epoch, "batch": self._consumed}

    def seek(self, epoch: int, batch: int = 0) -> None:
        """Position the iterator at ``batch`` of (data-)epoch ``epoch``.

        Epoch e's permutation is mt19937_64(seed + e) whatever came before,
        on both paths. The native ring has no random access, so it is
        rebuilt at epoch e and drained ``batch`` batches."""
        if not 0 <= batch < max(len(self), 1):
            raise ValueError(f"batch {batch} not in [0, {len(self)})")
        if epoch < 0:
            raise ValueError(f"epoch {epoch} < 0")
        if self._native:
            self._lib.loader_destroy(self._loader)
            self._loader = self._create_loader(self.seed + epoch)
            self._epoch, self._consumed = epoch, 0
            scratch = self._batch_buffer()
            for _ in range(batch):
                self._next_native(scratch)
        self._epoch = epoch
        self._consumed = batch
        self._seeked = True

    @property
    def clip_shape(self) -> Tuple[int, int, int, int]:
        return (self.t, self.h, self.w, self.c)

    def __len__(self) -> int:
        return self.n // (self.batch_size * self.num_shards)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._native:
            if self._seeked:
                # seek() already positioned the ring at (_epoch, _consumed):
                # serve the remainder of that epoch.
                self._seeked = False
            elif self._consumed:
                # A previous iterator was abandoned mid-epoch. The ring has
                # no seek, so drain to the epoch boundary: the numpy reader
                # starts a fresh epoch, and the two paths stay bit-equal.
                scratch = self._batch_buffer()
                for _ in range(len(self) - self._consumed):
                    self._next_native(scratch)
                self._consumed = 0
                self._epoch += 1
            try:
                for _ in range(self._consumed, len(self)):
                    # A fresh buffer per batch: the loader copies straight
                    # into it and ownership passes to the caller.
                    out = self._batch_buffer()
                    self._next_native(out)
                    self._consumed += 1
                    yield out
            finally:
                if self._consumed == len(self):
                    self._consumed = 0
                    self._epoch += 1
        else:
            # The same accounting as the native path, batch for batch: a
            # seek serves the remainder of its epoch; an abandoned
            # mid-epoch iterator skips to the next epoch.
            if self._consumed and not self._seeked:
                self._consumed = 0
                self._epoch += 1
            start = self._consumed
            self._seeked = False
            perm = epoch_permutation(self.n, self.seed, self._epoch, self.shuffle)
            gb = self.batch_size * self.num_shards
            try:
                for b in range(start, len(self)):
                    off = b * gb + self.shard_id * self.batch_size
                    idx = perm[off : off + self.batch_size]
                    self._consumed = b + 1
                    yield np.stack([self._mm[i] for i in idx])
            finally:
                if self._consumed == len(self):
                    self._consumed = 0
                    self._epoch += 1

    def close(self) -> None:
        if self._native:
            if self._loader:
                self._lib.loader_destroy(self._loader)
            if self._reader:
                self._lib.clippack_close(self._reader)
            self._loader = self._reader = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
