"""CSV-manifest datasets.

Counterpart of ``tchvp_tpu/data/manifest.py``, with the same batches and
positions:

* :class:`ImageDataset` -- single-image rows (one path per row; decode to
  RGB, resize, uint8 batches).
* :class:`ImageMaskDataset` -- "img,mask" rows with grayscale masks.
* :class:`ClipDataset` -- each row is an ordered list of frame paths = one
  video clip.

Host work is file I/O and image decode only; resize, normalize and augment
run on the card (:mod:`tchvp_tpu_torch.data.pipeline`). Batches are
stacked numpy NHWC uint8.

* decode fans out over a shared thread pool (PIL releases the GIL inside
  libjpeg/zlib), ``TCHVP_DECODE_THREADS`` to override;
* decoded frames are cached in RAM up to ``TCHVP_DECODE_CACHE_MB``
  (default 2048), so repeat epochs are memcpy, not re-decode;
* JPEG downscaling uses draft mode (DCT-domain 1/2/4/8 pre-scale), so a
  large photo headed for 224px never fully decodes;
* host resize only happens when the decoded size differs from the target;
* with ``prefetch=True`` a background thread decodes the next batches
  while the consumer runs the current one.

A header row is detected and skipped, and batching drops the last partial
batch. PIL is optional: without it only decoding raises.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tchvp_tpu_torch.config import IngestConfig

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

_POOL: Optional[ThreadPoolExecutor] = None
_CACHE: Optional["_DecodeCache"] = None
_SHARED_LOCK = threading.Lock()  # guards both lazy singletons


def _ingest_config() -> IngestConfig:
    """:class:`IngestConfig`, with the TCHVP_DECODE_* environment
    variables over its first two fields."""
    cfg = IngestConfig()
    threads = os.environ.get("TCHVP_DECODE_THREADS")
    cache_mb = os.environ.get("TCHVP_DECODE_CACHE_MB")
    if threads is not None or cache_mb is not None:
        cfg = IngestConfig(
            decode_threads=int(threads) if threads else cfg.decode_threads,
            cache_mb=int(cache_mb) if cache_mb else cfg.cache_mb,
        )
    return cfg


def _pool() -> ThreadPoolExecutor:
    """Shared decode pool. PIL's decoders release the GIL, so threads
    overlap file I/O and decompression even on small hosts."""
    global _POOL
    with _SHARED_LOCK:
        if _POOL is None:
            cfg = _ingest_config()
            workers = cfg.decode_threads or min(8, os.cpu_count() or 1)
            _POOL = ThreadPoolExecutor(
                max_workers=max(1, workers), thread_name_prefix="tchvp-decode"
            )
    return _POOL


class _DecodeCache:
    """Byte-budgeted cache of decoded frames, keyed by (path, gray, size).

    For corpora that fit in RAM this turns epochs 2..N into array lookups. FIFO eviction
    (oldest insertion first) — epoch iteration revisits everything
    anyway, so LRU buys nothing.
    """

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._data: dict = {}
        self._used = 0
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def put(self, key, arr: np.ndarray) -> None:
        with self._lock:
            if key in self._data:
                return
            if self._used + arr.nbytes > self.budget:
                if arr.nbytes > self.budget:
                    return
                while self._used + arr.nbytes > self.budget and self._data:
                    oldest = next(iter(self._data))
                    self._used -= self._data.pop(oldest).nbytes
            self._data[key] = arr
            self._used += arr.nbytes


def _cache() -> _DecodeCache:
    global _CACHE
    with _SHARED_LOCK:
        if _CACHE is None:
            _CACHE = _DecodeCache(_ingest_config().cache_mb << 20)
    return _CACHE


def read_manifest(
    csv_file: str,
    data_fraction: float = 1.0,
    header: Optional[bool] = None,
) -> List[List[str]]:
    """Read a CSV manifest into rows of path strings.

    ``header``: True always skips the first row, False never does, and
    None (default) auto-detects — first row's first cell isn't an
    existing file AND has no extension dot. The auto-heuristic can
    misfire (a deleted first file, extensionless image paths); pass an
    explicit value for such manifests.
    """
    rows: List[List[str]] = []
    with open(csv_file, newline="") as f:
        for row in csv.reader(f):
            cells = [c.strip() for c in row if c.strip()]
            if cells:
                rows.append(cells)
    if header is None:
        header = bool(rows) and not os.path.exists(rows[0][0]) and (
            "." not in os.path.basename(rows[0][0])
        )
    if header and rows:
        rows = rows[1:]
    if data_fraction < 1.0:
        rows = rows[: max(1, int(len(rows) * data_fraction))]
    return rows


def _decode(path: str, size: Optional[int] = None) -> np.ndarray:
    """JPEG/PNG decode to HWC uint8 RGB on the host. ``size`` enables
    JPEG draft mode: libjpeg decodes at 1/2-1/8 scale straight from the
    DCT coefficients when the target is much smaller than the photo."""
    if Image is None:
        raise RuntimeError("PIL unavailable for image decoding")
    with Image.open(path) as img:
        if size is not None:
            img.draft("RGB", (size, size))
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def _decode_gray(path: str) -> np.ndarray:
    """Grayscale decode (PIL's 'L' convert) to (H, W, 1) uint8."""
    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.uint8)[..., None]


def _resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Host-side resize, skipped when the frame is already on-size
    (fixed-size corpora never pay it; ragged ones pay only per odd frame —
    the on-device pipeline handles the general resize)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    pil = Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img)
    out = np.asarray(pil.resize((size, size), Image.BILINEAR), dtype=np.uint8)
    return out[..., None] if img.shape[-1] == 1 else out


def _load_frame(path: str, size: int, gray: bool = False,
                host_resize: bool = True) -> np.ndarray:
    """Cached decode(+resize) of one frame.

    ``host_resize=False`` ships the TRUE native-size frame (no JPEG
    draft pre-scale either — draft output is size-dependent, and this
    key carries no size), for callers that resize on device."""
    key = (path, gray, size if host_resize else -1)
    c = _cache()
    hit = c.get(key)
    if hit is not None:
        return hit
    if gray:
        img = _decode_gray(path)
    else:
        img = _decode(path, size if host_resize else None)
    if host_resize:
        img = _resize_uint8(img, size)
    c.put(key, img)
    return img


def _load_many(paths: Sequence[str], size: int, gray: bool = False,
               host_resize: bool = True) -> List[np.ndarray]:
    """Thread-pool decode of a batch worth of frames, order-preserving."""
    if len(paths) <= 1:
        return [_load_frame(p, size, gray, host_resize) for p in paths]
    return list(
        _pool().map(lambda p: _load_frame(p, size, gray, host_resize), paths)
    )


class _Prefetcher:
    """Background prefetch: the next batch(es) decode while the consumer
    runs the current one (overlaps host ingest with device compute).
    Depth 2 so a drain-speed consumer doesn't ping-pong the GIL with the
    producer on every single batch."""

    def __init__(self, make_iter, depth: Optional[int] = None):
        self._make_iter = make_iter
        if depth is None:
            depth = IngestConfig().prefetch_depth
        self._depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        done = object()

        def offer(x) -> bool:
            """put() that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(x, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._make_iter():
                    if not offer(item):
                        return  # consumer abandoned the iterator
                offer(done)
            except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
                offer(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    # Decode errors must abort the epoch, exactly like the
                    # non-prefetching path — not truncate it silently.
                    raise item
                yield item
        finally:
            # Runs on normal exhaustion AND on early abandonment
            # (GeneratorExit): release the worker so it can't stay blocked
            # on a full queue holding decoded batches forever.
            stop.set()
            t.join()


class _Batcher:
    """Shuffling, drop-last batching over row indices.

    Positionable like :class:`tchvp_tpu_torch.data.clippack.ClipPackDataset`:
    epoch e's permutation is a pure function of (seed, e) — a fresh
    ``default_rng((seed, e))`` per epoch, the numpy analogue of the
    clippack loaders' ``mt19937_64(seed + e)`` — so :meth:`seek` is
    history-free: no replay, and an iterator abandoned before its first
    batch (e.g. a prefetch worker that shuffled eagerly but whose
    consumer crashed at batch 0) cannot desynchronize the stream a
    restored process reconstructs. Consumption is counted CONSUMER-side
    (:meth:`note_consumed`, called by the datasets' iterator wrappers)
    so a prefetch queue running ahead of training does not inflate
    :meth:`position` — a mid-epoch checkpoint must record the next batch
    the *trainer* will see, not the next one the decode worker will
    fetch."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.consumed = 0  # batches the CONSUMER took this epoch
        self._seeked = False

    def __len__(self) -> int:
        return self.n // self.batch_size

    def position(self) -> dict:
        return {"epoch": self.epoch, "batch": self.consumed}

    def seek(self, epoch: int, batch: int = 0) -> None:
        if not 0 <= batch < max(len(self), 1):
            raise ValueError(f"batch {batch} not in [0, {len(self)})")
        if epoch < 0:
            raise ValueError(f"epoch {epoch} < 0")
        self.epoch = epoch
        self.consumed = batch
        self._seeked = True

    def _perm(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def batches(self) -> Iterator[np.ndarray]:
        if self.consumed and not self._seeked:
            # Abandoned mid-epoch: skip the remainder (clippack semantics).
            self.epoch += 1
            self.consumed = 0
        start = self.consumed
        self._seeked = False
        idx = self._perm(self.epoch)
        for i in range(start, len(self)):
            yield idx[i * self.batch_size : (i + 1) * self.batch_size]

    def note_consumed(self) -> None:
        self.consumed += 1
        if self.consumed >= len(self):
            self.consumed = 0
            self.epoch += 1


def _counted(batcher: _Batcher, it) -> Iterator:
    """Consumer-side position accounting around a (possibly prefetched)
    batch iterator."""
    for x in it:
        batcher.note_consumed()
        yield x


class ImageDataset:
    """Unsupervised image dataset over a one-column CSV manifest."""

    def __init__(
        self,
        csv_file: str,
        batch_size: int,
        image_size: int = 256,
        shuffle: bool = True,
        seed: int = 0,
        data_fraction: float = 1.0,
        prefetch: bool = False,
    ):
        self.rows = read_manifest(csv_file, data_fraction)
        self.image_size = image_size
        self.prefetch = prefetch
        self.batcher = _Batcher(len(self.rows), batch_size, shuffle, seed)

    def __len__(self) -> int:
        return len(self.batcher)

    def position(self) -> dict:
        """Checkpointable iteration position (see ``_Batcher``)."""
        return self.batcher.position()

    def seek(self, epoch: int, batch: int = 0) -> None:
        self.batcher.seek(epoch, batch)

    def _gen(self) -> Iterator[np.ndarray]:
        for idx in self.batcher.batches():
            imgs = _load_many([self.rows[i][0] for i in idx], self.image_size)
            yield np.stack(imgs)  # (B, H, W, 3) uint8

    def __iter__(self) -> Iterator[np.ndarray]:
        it = iter(_Prefetcher(self._gen)) if self.prefetch else self._gen()
        return _counted(self.batcher, it)


class ImageMaskDataset:
    """Supervised (image, mask) dataset over a two-column CSV manifest."""

    def __init__(
        self,
        csv_file: str,
        batch_size: int,
        image_size: int = 256,
        shuffle: bool = True,
        seed: int = 0,
        data_fraction: float = 1.0,
        prefetch: bool = False,
    ):
        self.rows = read_manifest(csv_file, data_fraction)
        self.image_size = image_size
        self.prefetch = prefetch
        self.batcher = _Batcher(len(self.rows), batch_size, shuffle, seed)

    def __len__(self) -> int:
        return len(self.batcher)

    def position(self) -> dict:
        return self.batcher.position()

    def seek(self, epoch: int, batch: int = 0) -> None:
        self.batcher.seek(epoch, batch)

    def _gen(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for idx in self.batcher.batches():
            imgs = _load_many([self.rows[i][0] for i in idx], self.image_size)
            masks = _load_many(
                [self.rows[i][1] for i in idx], self.image_size, gray=True
            )
            yield np.stack(imgs), np.stack(masks)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        it = iter(_Prefetcher(self._gen)) if self.prefetch else self._gen()
        return _counted(self.batcher, it)


class ClipDataset:
    """Video-clip dataset: each CSV row is an ordered list of frame paths
    Yields (B, T, H, W, 3) uint8."""

    def __init__(
        self,
        csv_file: str,
        batch_size: int,
        image_size: int = 256,
        clip_len: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        data_fraction: float = 1.0,
        prefetch: bool = False,
    ):
        self.rows = read_manifest(csv_file, data_fraction)
        if clip_len is not None:
            self.rows = [r[:clip_len] for r in self.rows if len(r) >= clip_len]
        self.image_size = image_size
        self.prefetch = prefetch
        self.batcher = _Batcher(len(self.rows), batch_size, shuffle, seed)

    def __len__(self) -> int:
        return len(self.batcher)

    def position(self) -> dict:
        return self.batcher.position()

    def seek(self, epoch: int, batch: int = 0) -> None:
        self.batcher.seek(epoch, batch)

    def _gen(self) -> Iterator[np.ndarray]:
        for idx in self.batcher.batches():
            flat = [p for i in idx for p in self.rows[i]]
            frames = _load_many(flat, self.image_size)
            clips, off = [], 0
            for i in idx:
                t = len(self.rows[i])
                clips.append(np.stack(frames[off : off + t]))
                off += t
            yield np.stack(clips)  # (B, T, H, W, 3)

    def __iter__(self) -> Iterator[np.ndarray]:
        it = iter(_Prefetcher(self._gen)) if self.prefetch else self._gen()
        return _counted(self.batcher, it)


_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def write_manifest(image_dir: str, out_csv: str, recursive: bool = True) -> int:
    """Walk a directory of images and write a one-column path manifest,
    without a header row. Paths are sorted for determinism. Returns the
    number of rows."""
    rows = []
    if recursive:
        for root, _, files in sorted(os.walk(image_dir)):
            for f in sorted(files):
                if os.path.splitext(f)[1].lower() in _IMAGE_EXTS:
                    rows.append(os.path.join(root, f))
    else:
        for f in sorted(os.listdir(image_dir)):
            if os.path.splitext(f)[1].lower() in _IMAGE_EXTS:
                rows.append(os.path.join(image_dir, f))
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        for r in rows:
            w.writerow([r])
    return len(rows)


def write_clip_manifest(
    frame_dirs: Sequence[str], out_csv: str, clip_len: Optional[int] = None
) -> int:
    """One CSV row per directory = one clip of its (sorted) frame images.
    ``clip_len`` truncates/skips short clips. Returns clips written."""
    n = 0
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        for d in frame_dirs:
            frames = [
                os.path.join(d, f)
                for f in sorted(os.listdir(d))
                if os.path.splitext(f)[1].lower() in _IMAGE_EXTS
            ]
            if clip_len is not None:
                if len(frames) < clip_len:
                    continue
                frames = frames[:clip_len]
            if frames:
                w.writerow(frames)
                n += 1
    return n


def make_loaders(
    train_csv: str,
    val_csv: Optional[str],
    test_csv: Optional[str],
    batch_size: int,
    image_size: int = 256,
    seed: int = 0,
) -> Tuple[ImageDataset, Optional[ImageDataset], Optional[ImageDataset]]:
    """Three shuffled image loaders (train, val, test; ``None`` for a
    missing manifest), seeded ``seed``, ``seed + 1``, ``seed + 2``."""
    mk = lambda p, s: ImageDataset(p, batch_size, image_size, True, seed + s) if p else None  # noqa: E731
    return mk(train_csv, 0), mk(val_csv, 1), mk(test_csv, 2)
