"""Device-side input prefetch: overlap the host-to-device copy with compute.

Counterpart of ``tchvp_tpu/data/device_prefetch.py``. Without lookahead
the copy of batch i+1 starts only when the trainer asks for it, and a copy
from pageable host memory stalls the host until the card has drained the
work queued before it. :class:`DevicePrefetch` wraps a dataset and keeps
``size`` batches already placed on the device: by default each host batch
is pinned and copied with ``non_blocking=True`` on a dedicated copy
stream, so the copy of batch i+1 rides under the compute of batch i.

Position accounting: the wrapper pulls ahead of the trainer, and the inner
datasets count batches when pulled. ``position()`` therefore reports the
inner position minus the batches still held, normalized through the
absolute batch index, so a mid-epoch checkpoint records the next batch the
trainer will see.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, Optional

import torch


def _tree_map(fn: Callable, batch):
    """``fn`` on every leaf of nested tuples, lists and dicts."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


class DevicePrefetch:
    """Iterate ``data`` with ``size`` batches kept placed on ``device``.

    ``place``: host batch -> device batch. The default pins each leaf and
    copies it on a copy stream (CUDA) or wraps it as a tensor (CPU); the
    consumer's stream waits on the copy's event when the batch is yielded,
    and the device tensor is recorded on that stream, so the caching
    allocator cannot recycle it while the step still reads it. A caller's
    ``place`` runs as given, with no stream handling.

    Proxies ``len``/``position``/``seek`` so the wrapper can stand in for
    the dataset everywhere, including mid-epoch checkpointing. ``size``
    extra batches live in device memory: 2 suffices to hide the copy.
    """

    def __init__(self, data, size: int = 2, place: Optional[Callable] = None,
                 device="cuda"):
        if size < 1:
            raise ValueError(f"size {size} < 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DevicePrefetch: device {self.device} is not available")
        self.data = data
        self.size = size
        self.place = place
        self._stream = None
        self._buf: Optional[deque] = None

    def __len__(self) -> int:
        return len(self.data)

    def _place(self, batch):
        """(placed batch, copy event or None)."""
        if self.place is not None:
            return self.place(batch), None
        if self.device.type != "cuda":
            return _tree_map(lambda b: torch.as_tensor(b).to(self.device), batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            placed = _tree_map(lambda b: torch.as_tensor(b).pin_memory().to(self.device, non_blocking=True),
                              batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _hand_over(self, placed, event):
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            _tree_map(lambda t: t.record_stream(stream), placed)
        return placed

    def __iter__(self) -> Iterator:
        it = iter(self.data)
        buf: deque = deque()
        self._buf = buf
        try:
            for _ in range(self.size):
                try:
                    buf.append(self._place(next(it)))
                except StopIteration:
                    break
            while buf:
                out = buf.popleft()
                try:
                    buf.append(self._place(next(it)))
                except StopIteration:
                    pass
                yield self._hand_over(*out)
        finally:
            # Trainer break/exception: drop lookahead so a later
            # position() does not credit batches nobody consumed. The
            # inner iterator's own abandon semantics then apply.
            self._buf = None

    # -- positionable-dataset proxy -------------------------------------
    # position/seek surface through __getattr__ so hasattr() on the
    # wrapper mirrors the inner dataset: callers feature-detect
    # positionability with hasattr.

    def __getattr__(self, name: str):
        if name == "position" and hasattr(self.data, "position"):
            return self._position
        if name == "seek" and hasattr(self.data, "seek"):
            return self._seek
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def _held(self) -> int:
        return len(self._buf) if self._buf is not None else 0

    def _position(self) -> dict:
        """The NEXT batch the TRAINER will receive (inner position minus
        the held lookahead, normalized like the inner datasets: the
        epoch-final batch reports the next epoch's batch 0)."""
        pos = self.data.position()
        spe = len(self.data)
        if spe == 0:
            return pos
        abs_next = pos["epoch"] * spe + pos["batch"] - self._held()
        return {"epoch": abs_next // spe, "batch": abs_next % spe}

    def _seek(self, epoch: int, batch: int = 0) -> None:
        if self._buf is not None:
            raise RuntimeError("seek during iteration: abandon the "
                               "iterator first")
        self.data.seek(epoch, batch)
