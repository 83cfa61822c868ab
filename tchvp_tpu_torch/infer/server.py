"""HTTP serving daemon for exported ``.tchvp`` artifacts.

Counterpart of ``tchvp_tpu/infer/server.py``: ``export`` writes the
artifact (``infer/export.py``) and this daemon turns it into an endpoint
with no model code. The protocol is stdlib-only on both ends:

* ``GET /health`` -> JSON: status, the artifact's platforms and meta,
  request and frame counters, the last request's queue, infer and total
  latency, what is in flight, and the micro-batcher's coalesced calls and
  requests;
* ``POST /infer`` with an ``.npy`` body (``np.save``; uint8 clips (B, T,
  H, W, 3) or images (B, H, W, 3)) -> the ``.npy`` output, bfloat16 widened
  to float32 on the wire;
* for a streaming artifact, ``POST /stream/open`` -> a session id with
  the session's geometry, ``POST /stream/<id>`` with a chunk -> its
  reconstruction (the carry stays on the device), ``POST
  /stream/<id>/close``.

A client's fault (a malformed body, a wrong shape or dtype, an empty
batch) is answered with 400; a fault of the server (the device, memory)
with 500.

**Batch buckets.** Each request is padded up to the smallest configured
bucket, and batches beyond the largest are split into bucket-sized chunks;
every bucket runs once before the server takes traffic, so the allocator's
and cuDNN's first-call costs are paid at start. Padding is sound because
every artifact maps its rows independently (eval mode: running
BatchNorm stats, no cross-batch reduction); the pad rows are sliced off.
Requests serialize through a lock (one card, one program): concurrency
belongs in the batch dimension. ``batch_window_ms > 0`` coalesces
concurrent ``/infer`` requests arriving within the window into one device
batch (grouped by trailing shape and dtype, so a client with a wrong shape
fails alone), run through the same buckets and split back per request.
The output comes back to the host with one ``.cpu()`` per program call.

**Live pipelined serving** (``serve --mesh data=K,pipe=N``,
:func:`serve_live_pipelined`): an artifact cannot carry the pipeline, a
schedule over several processes, so the server runs the live flagship
(:class:`LivePipelinedModel`) from a checkpoint. Each rank is a process;
rank 0 owns the HTTP server, and every batch it runs (each bucket's) is
broadcast to the other ranks first, which follow it through the pipeline
until rank 0 broadcasts its stop.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

import numpy as np

import torch

from tchvp_tpu_torch.infer.export import ServingModel, load_artifact

_NPY_CONTENT_TYPE = "application/x-npy"


class _Stats:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.requests = 0
        self.frames = 0
        self.errors = 0
        self.inflight = 0
        self.last_latency_ms: Optional[float] = None
        self.last_queue_ms: Optional[float] = None
        self.last_infer_ms: Optional[float] = None
        self.coalesced_calls = 0
        self.coalesced_requests = 0

    def enter(self) -> None:
        with self.lock:
            self.inflight += 1

    def record(self, frames: int, queue_ms: float, infer_ms: float) -> None:
        with self.lock:
            self.inflight -= 1
            self.requests += 1
            self.frames += frames
            self.last_queue_ms = queue_ms
            self.last_infer_ms = infer_ms
            self.last_latency_ms = queue_ms + infer_ms

    def record_error(self, inflight: bool = False) -> None:
        with self.lock:
            self.errors += 1
            if inflight:
                self.inflight -= 1

    def record_coalesced(self, n_requests: int) -> None:
        with self.lock:
            self.coalesced_calls += 1
            self.coalesced_requests += n_requests

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "requests": self.requests,
                "frames": self.frames,
                "errors": self.errors,
                "inflight": self.inflight,
                "last_latency_ms": self.last_latency_ms,
                "last_queue_ms": self.last_queue_ms,
                "last_infer_ms": self.last_infer_ms,
                "coalesced_calls": self.coalesced_calls,
                "coalesced_requests": self.coalesced_requests,
            }


def _normalize_buckets(
    buckets: Optional[Tuple[int, ...]],
) -> Optional[Tuple[int, ...]]:
    """Sorted unique buckets, validated up front (before any warmup)."""
    if not buckets:
        return None
    norm = tuple(sorted(set(int(b) for b in buckets)))
    if norm[0] < 1:
        raise ValueError(f"buckets must be >= 1, got {norm}")
    return norm


def _to_numpy(out: torch.Tensor) -> np.ndarray:
    """A program's output on the host, with one ``.cpu()``; bfloat16 (which
    numpy lacks) widened to float32 on the device first, losslessly."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


def _bucketed_call(model: ServingModel, batch: np.ndarray,
                   buckets: Tuple[int, ...]) -> np.ndarray:
    """Run ``batch`` through the program at bucket batch sizes only.

    Pads up to the smallest bucket >= B; batches beyond the largest
    bucket are split into largest-bucket chunks (remainder padded). Pad
    rows are zeros and are sliced off the output — sound because the
    artifact maps clips independently along the batch dim.
    """
    b = int(batch.shape[0])
    cap = buckets[-1]
    outs = []
    for start in range(0, b, cap):
        chunk = batch[start:start + cap]
        n = int(chunk.shape[0])
        size = next(s for s in buckets if s >= n)
        if size > n:
            pad = np.zeros((size - n,) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        outs.append(_to_numpy(model(chunk))[:n])
    return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)


class _Request:
    __slots__ = ("batch", "event", "out", "error")

    def __init__(self, batch: np.ndarray):
        self.batch = batch
        self.event = threading.Event()
        self.out: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None


class _MicroBatcher:
    """Dynamic request batching: coalesce concurrent ``/infer`` bodies
    into one device batch.

    A dedicated worker wakes on the first pending request, sleeps out the
    remaining ``window_ms``, drains everything queued, groups by
    (trailing shape, dtype) — a client with the wrong clip shape fails
    alone, not the whole window — concatenates each group along the
    batch dim, runs ONE model call (through the bucket machinery when
    configured), and scatters the rows back to their requests.
    """

    def __init__(self, model: ServingModel, stats: _Stats,
                 infer_lock: threading.Lock,
                 buckets: Optional[Tuple[int, ...]],
                 window_ms: float):
        self._model = model
        self._stats = stats
        self._lock = infer_lock
        self._buckets = buckets
        self._window = window_ms / 1e3
        self._cv = threading.Condition()
        self._pending: list = []
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, batch: np.ndarray) -> np.ndarray:
        req = _Request(batch)
        with self._cv:
            if self._closed:
                raise RuntimeError("server shutting down")
            self._pending.append(req)
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.out

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                # First arrival opens the window; collect what lands in it.
                deadline = time.monotonic() + self._window
                while not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                reqs, self._pending = self._pending, []
            self._serve(reqs)

    def _serve(self, reqs: list) -> None:
        groups: dict = {}
        for r in reqs:
            groups.setdefault(
                (r.batch.shape[1:], r.batch.dtype.str), []
            ).append(r)
        for group in groups.values():
            batch = (group[0].batch if len(group) == 1 else
                     np.concatenate([r.batch for r in group], axis=0))
            try:
                with self._lock:
                    if self._buckets:
                        out = _bucketed_call(self._model, batch, self._buckets)
                    else:
                        out = _to_numpy(self._model(batch))
            except Exception as e:  # noqa: BLE001 — delivered per request
                for r in group:
                    r.error = e
                    r.event.set()
                continue
            if len(group) > 1:
                self._stats.record_coalesced(len(group))
            row = 0
            for r in group:
                n = int(r.batch.shape[0])
                r.out = out[row:row + n]
                row += n
                r.event.set()


class _Sessions:
    """Per-session carry state for STREAMING artifacts.

    A session is one live video: ``open()`` mints an id with a fresh
    zero carry, each chunk step swaps the carry in place, ``close()``
    frees it. Idle sessions are pruned after ``ttl_s`` (checked on
    open) so abandoned clients can't pin device memory forever.
    """

    def __init__(self, model, max_sessions: int = 64, ttl_s: float = 3600.0):
        self._model = model
        self._lock = threading.Lock()
        self._carry: dict = {}
        self._last_used: dict = {}
        self._max = max_sessions
        self._ttl = ttl_s

    def open(self) -> str:
        import secrets

        with self._lock:
            now = time.monotonic()
            for sid in [s for s, t in self._last_used.items()
                        if now - t > self._ttl]:
                self._carry.pop(sid, None)
                self._last_used.pop(sid, None)
            if len(self._carry) >= self._max:
                raise RuntimeError(
                    f"too many live streams ({self._max}); close some"
                )
            sid = secrets.token_hex(8)
            self._carry[sid] = self._model.init_carry()
            self._last_used[sid] = now
            return sid

    def step(self, sid: str, chunk: np.ndarray) -> np.ndarray:
        with self._lock:
            if sid not in self._carry:
                raise KeyError(f"unknown or expired stream {sid!r}")
            carry = self._carry[sid]
        new_carry, recon = self._model.step(carry, chunk)
        with self._lock:
            # Re-check: a concurrent close() must win over a late step.
            if sid in self._carry:
                self._carry[sid] = new_carry
                self._last_used[sid] = time.monotonic()
        return _to_numpy(recon)

    def close(self, sid: str) -> bool:
        with self._lock:
            self._last_used.pop(sid, None)
            return self._carry.pop(sid, None) is not None

    def count(self) -> int:
        with self._lock:
            return len(self._carry)


def _make_handler(model: ServingModel, stats: _Stats,
                  infer_lock: threading.Lock,
                  buckets: Optional[Tuple[int, ...]],
                  batcher: Optional[_MicroBatcher] = None,
                  sessions: Optional[_Sessions] = None):
    class Handler(BaseHTTPRequestHandler):
        # Quiet by default; the CLI prints its own line per request.
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj: Any) -> None:
            self._reply(code, json.dumps(obj).encode("utf-8"), "application/json")

        def do_GET(self) -> None:  # noqa: N802
            if self.path != "/health":
                self._reply_json(404, {"error": f"unknown path {self.path}"})
                return
            self._reply_json(200, {
                "status": "ok",
                "platforms": list(model.platforms),
                "meta": model.meta,
                **({"streams": sessions.count()} if sessions else {}),
                **stats.snapshot(),
            })

        def _read_npy(self) -> Optional[np.ndarray]:
            try:
                n = int(self.headers.get("Content-Length", "0"))
                return np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
            except Exception as e:  # malformed body -> client error
                stats.record_error()
                self._reply_json(400, {"error": f"bad .npy body: {e}"})
                return None

        def _do_stream(self) -> None:
            if self.path == "/stream/open":
                try:
                    sid = sessions.open()
                except RuntimeError as e:
                    self._reply_json(429, {"error": str(e)})
                    return
                self._reply_json(200, {
                    "session": sid, **model.stream_meta
                })
                return
            rest = self.path[len("/stream/"):]
            if rest.endswith("/close"):
                sid = rest[: -len("/close")]
                ok = sessions.close(sid)
                self._reply_json(200 if ok else 404, {"closed": ok})
                return
            chunk = self._read_npy()
            if chunk is None:
                return
            stats.enter()
            try:
                t0 = time.perf_counter()
                with infer_lock:
                    t1 = time.perf_counter()
                    out = sessions.step(rest, chunk)
                t2 = time.perf_counter()
            except KeyError as e:
                stats.record_error(inflight=True)
                self._reply_json(404, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                stats.record_error(inflight=True)
                code = 400 if isinstance(e, (ValueError, TypeError)) else 500
                self._reply_json(code, {"error": str(e)})
                return
            stats.record(
                int(chunk.shape[0] * chunk.shape[1]),
                (t1 - t0) * 1e3, (t2 - t1) * 1e3,
            )
            buf = io.BytesIO()
            np.save(buf, out, allow_pickle=False)
            self._reply(200, buf.getvalue(), _NPY_CONTENT_TYPE)

        def do_POST(self) -> None:  # noqa: N802
            if sessions is not None and self.path.startswith("/stream"):
                self._do_stream()
                return
            if self.path != "/infer":
                self._reply_json(404, {"error": f"unknown path {self.path}"})
                return
            if sessions is not None:
                self._reply_json(400, {
                    "error": "streaming artifact: open a session at "
                             "/stream/open and POST chunks to "
                             "/stream/<session>"
                })
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                batch = np.load(io.BytesIO(self.rfile.read(n)),
                                allow_pickle=False)
            except Exception as e:  # malformed body -> client error
                stats.record_error()
                self._reply_json(400, {"error": f"bad .npy body: {e}"})
                return
            if batch.ndim == 0 or batch.shape[0] == 0:
                stats.record_error()
                self._reply_json(400, {"error": "empty batch"})
                return
            stats.enter()
            try:
                t0 = time.perf_counter()
                if batcher is not None:
                    # Queue time and device time merge under coalescing;
                    # report the whole wait as infer so latency stays
                    # truthful in /health.
                    t1 = t0
                    out = batcher.submit(batch)
                else:
                    with infer_lock:
                        t1 = time.perf_counter()
                        if buckets:
                            out = _bucketed_call(model, batch, buckets)
                        else:
                            out = _to_numpy(model(batch))
                t2 = time.perf_counter()
            except Exception as e:
                stats.record_error(inflight=True)
                # Shape/dtype mismatches against the program are the
                # client's fault (400); anything else (device lost, OOM,
                # backend error) is a server fault and must read as 500
                # so monitoring can tell a broken daemon from bad input.
                code = 400 if isinstance(e, (ValueError, TypeError)) else 500
                self._reply_json(code, {"error": str(e)})
                return
            # Frames served: B*T for 5-D clips, B for 4-D images.
            frames = int(batch.shape[0] * batch.shape[1]) if batch.ndim == 5 \
                else int(batch.shape[0])
            stats.record(frames, (t1 - t0) * 1e3, (t2 - t1) * 1e3)
            buf = io.BytesIO()
            np.save(buf, out, allow_pickle=False)
            self._reply(200, buf.getvalue(), _NPY_CONTENT_TYPE)

    return Handler


class ArtifactServer:
    """A running HTTP endpoint around one loaded artifact.

    ``port=0`` binds an ephemeral port (read it back from ``.port``) —
    the test/bench-friendly default. ``start()`` runs the accept loop on
    a daemon thread; ``serve_forever()`` blocks (the CLI path).
    """

    def __init__(self, model: ServingModel, host: str = "127.0.0.1",
                 port: int = 0,
                 buckets: Optional[Tuple[int, ...]] = None,
                 batch_window_ms: float = 0.0):
        self.model = model
        self.stats = _Stats()
        self.buckets = _normalize_buckets(buckets)
        self._infer_lock = threading.Lock()
        streaming = bool(getattr(model, "stream_meta", None))
        self.sessions = _Sessions(model) if streaming else None
        self.batcher = (
            _MicroBatcher(model, self.stats, self._infer_lock,
                          self.buckets, batch_window_ms)
            if batch_window_ms > 0 and not streaming else None
        )
        self._httpd = ThreadingHTTPServer(
            (host, port),
            _make_handler(model, self.stats, self._infer_lock, self.buckets,
                          self.batcher, self.sessions),
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    def start(self) -> "ArtifactServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.batcher is not None:
            self.batcher.close()


def serve_artifact(path: str, host: str = "127.0.0.1", port: int = 0,
                   warmup: bool = True,
                   buckets: Optional[Tuple[int, ...]] = (1,),
                   data_parallel: bool = False,
                   batch_window_ms: float = 0.0,
                   device=None) -> ArtifactServer:
    """Load a ``.tchvp`` artifact onto its platform's device (``device``)
    and bind (but not start) a server.

    ``buckets`` is the set of batch sizes the program runs at (default
    ``(1,)``: every request splits into batch-1 calls); ``None`` runs each
    request at its own size. ``warmup=True`` runs every bucket once before
    the server takes traffic. ``batch_window_ms > 0`` turns on dynamic
    micro-batching (``_MicroBatcher``). A streaming artifact gets the
    /stream endpoints and no buckets (a session has one geometry).

    ``data_parallel=True`` serves over every visible card of the platform
    (``ServingModel.over_mesh``): each request batch splits over the
    replicas. Buckets must then be multiples of their number; the ``(1,)``
    default becomes one row per replica. A streaming artifact's stateful
    carry does not split, and is refused.
    """
    norm = _normalize_buckets(buckets)  # validate BEFORE any warmup work
    model = load_artifact(path, device)
    if getattr(model, "stream_meta", None):
        if data_parallel:
            raise ValueError("streaming artifacts don't support data-parallel serving (stateful carry)")
        if warmup:
            sm = model.stream_meta
            chunk = np.zeros(
                (sm["batch"], sm["chunk_len"], sm["image_size"],
                 sm["image_size"], 3), np.uint8,
            )
            _to_numpy(model.step(model.init_carry(), chunk)[1])
        return ArtifactServer(model, host, port, buckets=None)
    if data_parallel:
        model = model.over_mesh()
        n = model.n_devices
        if norm == (1,):  # the padding-only default: one row per replica
            norm = (n,)
        bad = [b for b in (norm or ()) if b % n]
        if bad:
            raise ValueError(f"data-parallel serving over {n} devices needs buckets that are "
                             f"multiples of {n}, got {bad}")
    if warmup:
        # The input's shape and dtype come from the program's own batch
        # aval (``example_input``).
        for b in (norm or (getattr(model, "n_devices", 1),)):
            _to_numpy(model(model.example_input(b)))
    return ArtifactServer(model, host, port, buckets=norm,
                          batch_window_ms=batch_window_ms)


class LivePipelinedModel:
    """The serving model of ``serve --mesh data=K,pipe=N``: uint8 clips ->
    ``preprocess_clip`` (bf16) -> ``parallel/pipeline.py::pipelined_video_infer``
    over the mesh -> the reconstruction, exactly ``infer --mesh pipe=N``'s
    compute. ``model``: the bf16 ``VideoHybridNet``, the same on every rank,
    whose stage of the temporal layers this rank copies. Rank 0 calls it (the
    server's side: each call is broadcast to the other ranks first and the
    reconstruction of the whole batch comes back there); every other rank
    runs :meth:`follow` until rank 0 calls :meth:`stop`. ``meta`` is what
    ``/health`` reports: ``"kind": "live_pipelined"`` and the mesh."""

    def __init__(self, model, mesh, *, axis: str = "pipe", batch_axis: Optional[str] = None,
                 image_size: int = 256, clip_len: int = 8):
        from tchvp_tpu_torch.parallel.pipeline import PipelinedVideoNet

        self.mesh = mesh
        self.axis = axis
        self.batch_axis = batch_axis
        self.image_size = int(image_size)
        self.clip_len = int(clip_len)
        self.net = PipelinedVideoNet(model, mesh, axis).eval()
        self.device = next(self.net.parameters()).device
        self.platforms = (self.device.type,)
        self.meta = {"kind": "live_pipelined", "model": "hybrid", "image_size": self.image_size,
                     "clip_len": self.clip_len,
                     "mesh": {k: int(v) for k, v in zip(mesh.mesh_dim_names, mesh.mesh.shape)}}

    @property
    def n_devices(self) -> int:
        return int(self.mesh.mesh.numel())

    def example_input(self, batch: int) -> np.ndarray:
        return np.zeros((batch, self.clip_len, self.image_size, self.image_size, 3), np.uint8)

    def _run(self, raw: torch.Tensor) -> torch.Tensor:
        """This rank's part of one batch (the whole uint8 batch on every
        rank): the reconstruction of the whole batch."""
        from tchvp_tpu_torch.data.pipeline import preprocess_clip
        from tchvp_tpu_torch.parallel import activate_mesh, axis_group, shard_batch
        from tchvp_tpu_torch.parallel.collectives import all_gather_cat
        from tchvp_tpu_torch.parallel.pipeline import pipelined_video_infer

        with activate_mesh(self.mesh), torch.inference_mode():
            local = shard_batch(raw, self.mesh, batch_axis=self.batch_axis) if self.batch_axis else raw
            clip = preprocess_clip(local, self.image_size, dtype=torch.bfloat16)
            _, recon = pipelined_video_infer(self.net, clip, mesh=self.mesh, axis=self.axis,
                                             batch_axis=self.batch_axis)
            if self.batch_axis is not None:
                recon = all_gather_cat(recon, axis_group(self.mesh, self.batch_axis), dim=0)
        return recon

    def _header(self, shape=None) -> torch.Tensor:
        h = torch.zeros(6, dtype=torch.int64)
        if shape is not None:
            h[0] = 1
            h[1:] = torch.tensor(shape, dtype=torch.int64)
        return h

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        from tchvp_tpu_torch.parallel.collectives import broadcast_

        if batch.ndim != 5 or batch.shape[-1] != 3:
            raise ValueError(f"live pipelined serving takes uint8 clips (B, T, H, W, 3), got {batch.shape}")
        raw = torch.as_tensor(np.ascontiguousarray(batch, dtype=np.uint8)).to(self.device)
        broadcast_([self._header(tuple(raw.shape))], 0)
        broadcast_([raw], 0)
        return self._run(raw)

    def follow(self) -> int:
        """Every rank but 0: run each batch rank 0 broadcasts until its
        stop; returns the batches run."""
        from tchvp_tpu_torch.parallel.collectives import broadcast_

        n = 0
        while True:
            header = self._header()
            broadcast_([header], 0)
            if int(header[0]) == 0:
                return n
            raw = torch.empty(tuple(int(v) for v in header[1:]), dtype=torch.uint8, device=self.device)
            broadcast_([raw], 0)
            self._run(raw)
            n += 1

    def stop(self) -> None:
        """Rank 0: release the followers."""
        from tchvp_tpu_torch.parallel.collectives import broadcast_

        broadcast_([self._header()], 0)


def serve_live_pipelined(model, mesh, *, axis: str = "pipe", batch_axis: Optional[str] = None,
                         image_size: int = 256, clip_len: int = 8, host: str = "127.0.0.1", port: int = 0,
                         warmup: bool = True, buckets: Optional[Tuple[int, ...]] = (1,),
                         batch_window_ms: float = 0.0) -> Optional[ArtifactServer]:
    """What ``serve --mesh data=K,pipe=N`` runs. On rank 0: bind (not start)
    a server around a :class:`LivePipelinedModel`, buckets as
    :func:`serve_artifact`'s (with a data axis of d > 1 the ``(1,)``
    default becomes ``(d,)``, and every bucket must divide over it), each
    run once first; its ``model.stop()`` releases the other ranks. On every
    other rank: follow rank 0's batches until it stops, then return None."""
    import torch.distributed as dist

    live = LivePipelinedModel(model, mesh, axis=axis, batch_axis=batch_axis, image_size=image_size,
                              clip_len=clip_len)
    if dist.get_rank() != 0:
        live.follow()
        return None
    norm = _normalize_buckets(buckets)
    d = live.meta["mesh"].get(batch_axis, 1) if batch_axis else 1
    if d > 1:
        if norm == (1,):
            norm = (d,)
        bad = [b for b in (norm or ()) if b % d]
        if bad:
            live.stop()
            raise ValueError(f"pipelined serving with a {d}-wide '{batch_axis}' data axis needs buckets "
                             f"that are multiples of {d}, got {bad}")
    if norm is None:
        live.stop()
        raise ValueError("pipelined serving requires buckets (each batch size runs its own schedule)")
    if warmup:
        for b in norm:
            _to_numpy(live(live.example_input(b)))
    return ArtifactServer(live, host, port, buckets=norm, batch_window_ms=batch_window_ms)


def post_npy(url: str, array: np.ndarray, timeout: float = 600.0) -> np.ndarray:
    """Stdlib client helper: POST an array to ``url`` (``/infer`` or a
    ``/stream/<session>``), return the output array (what ``infer --url``
    and ``stream --url`` use)."""
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, array, allow_pickle=False)
    req = urllib.request.Request(
        url, data=buf.getvalue(),
        headers={"Content-Type": _NPY_CONTENT_TYPE}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)
