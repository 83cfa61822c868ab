"""The port's HTTP server (``tchvp_tpu_torch/infer/server.py``) and the
serving commands of its CLI on the CPU, as ``tests/test_server.py`` holds
the JAX package's.

* One flagship artifact (32^2, one temporal layer) behind a localhost
  endpoint: .npy in, .npy out, bit-equal to the loaded artifact called
  directly; batches padded to buckets and split past the largest bucket
  equal to the exact batch; /health's counters and latency split;
  malformed bodies, wrong shapes and dtypes and empty batches answered 400
  and the server still serving, a fault of the program 500, an unknown
  path 404; bad buckets refused before warm-up.
* Dynamic micro-batching: 4 concurrent clients coalesce into fewer
  program calls and each gets its own rows; a client with a wrong shape
  fails alone; a lone request flushes after one window.
* Streaming sessions: /stream/open, chunks equal to the artifact's own
  ``step``, /health's stream count, /infer refused, a closed session 404.
* The CLI: ``export`` then ``serve`` as its own process, ``infer --url``
  and ``infer --exported`` against it (the PSNR of the live model);
  ``stream --url``; ``infer --int8``, ``infer --int8 --int8-dense`` and
  ``eval --int8``; ``serve --mesh pipe=2`` as two ranks against ``infer``;
  ``serve --data-parallel`` is ported (item 11c), and ``serve_artifact(data_parallel=
  True)`` serves one replica on the CPU.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch.infer import export as texport
from tchvp_tpu_torch.infer.server import ArtifactServer, post_npy, serve_artifact
from tchvp_tpu_torch.models import video as tvideo
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, CLIP_LEN = 32, 4
ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SMALL = ["--image-size", str(SIZE), "--layers", "1", "--batch-size", "2", "--clip-len", str(CLIP_LEN)]


def _batch(b, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, CLIP_LEN, SIZE, SIZE, 3), dtype=np.uint8)


def _model():
    return tvideo.VideoHybridNet(tcfg.flagship_video_config(SIZE, num_layers=1), device="cpu",
                                 generator=torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def artifact_path(tmp_path_factory):
    exported, record = texport.export_video_model(_model(), clip_len=CLIP_LEN, image_size=SIZE)
    path = str(tmp_path_factory.mktemp("srv") / "m.tchvp")
    texport.save_artifact(path, exported, record, meta={"model": "hybrid", "image_size": SIZE,
                                                        "clip_len": CLIP_LEN})
    return path


@pytest.fixture(scope="module")
def served(artifact_path):
    srv = serve_artifact(artifact_path, port=0, buckets=(1, 2), device="cpu").start()
    yield srv
    srv.shutdown()


def _health(srv):
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health", timeout=30).read())


def _post_raw(url, body):
    return urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=30)


def test_infer_round_trip_matches_direct_call(served):
    url = f"http://127.0.0.1:{served.port}/infer"
    batch = _batch(2, seed=3)
    got = post_npy(url, batch)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, served.model(batch).numpy())
    assert post_npy(url, _batch(1, seed=4)).shape[0] == 1


def test_bucketed_batches_match_exact_batch(served):
    url = f"http://127.0.0.1:{served.port}/infer"
    for b in (3, 5):  # split over the cap of 2, the last chunk padded
        batch = _batch(b, seed=10 + b)
        got = post_npy(url, batch)
        want = served.model(batch).numpy()  # the exact batch
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_health_reports_stats(served):
    before = _health(served)
    assert before["status"] == "ok" and before["platforms"] == ["cpu"]
    post_npy(f"http://127.0.0.1:{served.port}/infer", _batch(2, seed=5))
    after = _health(served)
    assert after["requests"] == before["requests"] + 1
    assert after["frames"] == before["frames"] + 2 * CLIP_LEN
    assert after["last_latency_ms"] == pytest.approx(after["last_queue_ms"] + after["last_infer_ms"])
    assert after["inflight"] == 0 and after["meta"]["meta"]["model"] == "hybrid"


def test_client_errors_read_as_400_and_the_server_lives(served):
    base = f"http://127.0.0.1:{served.port}"
    errors = _health(served)["errors"]
    bad = [b"not an npy"]
    for arr in (np.zeros((1, CLIP_LEN, SIZE + 4, SIZE, 3), np.uint8), _batch(1).astype(np.float32),
                np.zeros((0, CLIP_LEN, SIZE, SIZE, 3), np.uint8)):
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        bad.append(buf.getvalue())
    for body in bad:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_raw(f"{base}/infer", body)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
    assert e.value.code == 404
    assert _health(served)["errors"] == errors + len(bad)
    assert post_npy(f"{base}/infer", _batch(1, seed=6)).ndim == 5


def test_server_faults_read_as_500_client_errors_as_400():
    class Stub:
        platforms, meta, calls = ("cpu",), {}, 0

        def __call__(self, batch):
            Stub.calls += 1
            if Stub.calls == 1:
                raise ValueError("shape mismatch for the program")
            raise RuntimeError("device lost")

    srv = ArtifactServer(Stub(), port=0, buckets=None).start()
    try:
        buf = io.BytesIO()
        np.save(buf, np.ones((1, 2), np.float32), allow_pickle=False)
        for code in (400, 500):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_raw(f"http://127.0.0.1:{srv.port}/infer", buf.getvalue())
            assert e.value.code == code
    finally:
        srv.shutdown()


def test_bad_buckets_are_refused_before_warm_up(artifact_path):
    with pytest.raises(ValueError, match="buckets"):
        serve_artifact(artifact_path, buckets=(0, 2), device="cpu")


def _concurrently(url, arrays):
    outs = [None] * len(arrays)
    barrier = threading.Barrier(len(arrays))

    def post(i):
        barrier.wait()
        try:
            outs[i] = post_npy(url, arrays[i])
        except Exception as e:  # noqa: BLE001 (returned to the test)
            outs[i] = e

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(arrays))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def test_dynamic_microbatching_coalesces_and_matches(artifact_path):
    srv = serve_artifact(artifact_path, port=0, buckets=(1, 4), batch_window_ms=150.0, device="cpu").start()
    try:
        batches = [_batch(1, seed=20 + i) for i in range(4)]
        want = [srv.model(b).numpy() for b in batches]
        outs = _concurrently(f"http://127.0.0.1:{srv.port}/infer", batches)
        for got, w in zip(outs, want):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
        health = _health(srv)
        assert health["requests"] == 4 and health["coalesced_requests"] >= 2
        assert health["coalesced_calls"] < health["coalesced_requests"]
    finally:
        srv.shutdown()


def test_microbatcher_isolates_bad_shapes_and_flushes_a_lone_request(artifact_path):
    window_ms = 150.0
    srv = serve_artifact(artifact_path, port=0, buckets=(1, 2), batch_window_ms=window_ms, device="cpu").start()
    try:
        url = f"http://127.0.0.1:{srv.port}/infer"
        good, bad = _batch(1, seed=3), np.zeros((1, CLIP_LEN, SIZE // 2, SIZE, 3), np.uint8)
        got_good, got_bad = _concurrently(url, [good, bad])
        assert isinstance(got_bad, urllib.error.HTTPError) and got_bad.code == 400
        np.testing.assert_allclose(got_good, srv.model(good).numpy(), rtol=1e-5, atol=1e-5)
        t0 = time.perf_counter()
        post_npy(url, good)
        infer_ms = _health(srv)["last_infer_ms"]
        assert 1e3 * (time.perf_counter() - t0) < 2 * window_ms + max(10 * infer_ms, 500.0)
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def streaming_path(tmp_path_factory):
    geometry = dict(chunk_len=2, ctx_frames=1, image_size=SIZE, batch=1)
    exported, record = texport.export_streaming_step(_model(), **geometry)
    path = str(tmp_path_factory.mktemp("stream") / "s.tchvp")
    texport.save_artifact(path, exported, record, meta=texport.streaming_meta(tokens_per_frame=8, **geometry))
    return path


def test_streaming_sessions_end_to_end(streaming_path):
    srv = serve_artifact(streaming_path, port=0, device="cpu").start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        opened = json.loads(_post_raw(f"{url}/stream/open", b"").read())
        sid = opened["session"]
        assert opened["chunk_len"] == 2 and opened["carry_shape"] == [1, 8, (SIZE // 4) ** 2]
        clip = _batch(1, seed=1)
        ref = texport.load_artifact(streaming_path)
        carry = ref.init_carry()
        for start in range(0, CLIP_LEN, 2):
            chunk = clip[:, start:start + 2]
            got = post_npy(f"{url}/stream/{sid}", chunk)
            carry, want = ref.step(carry, chunk)
            np.testing.assert_array_equal(got, want.numpy())
        health = _health(srv)
        assert health["streams"] == 1 and health["requests"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            post_npy(f"{url}/infer", clip)
        assert e.value.code == 400
        assert json.loads(_post_raw(f"{url}/stream/{sid}/close", b"").read())["closed"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            post_npy(f"{url}/stream/{sid}", clip[:, :2])
        assert e.value.code == 404
    finally:
        srv.shutdown()


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def test_cli_stream_url_client(streaming_path):
    srv = serve_artifact(streaming_path, port=0, device="cpu").start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        text = _run(["stream", "--url", url, "--synthetic", "1", "--batch-size", "1", "--clip-len", "4",
                     "--height", str(SIZE), "--width", str(SIZE)])
        assert "stream session" in text and "streamed 4 frames" in text
        health = _health(srv)
        assert health["streams"] == 0 and health["requests"] == 2
    finally:
        srv.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_export_serve_and_infer(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = _run(["export", "--out", "m.tchvp", *SMALL, *CPU])
    assert "exported hybrid 32px x 4f -> m.tchvp" in text and "batch symbolic" in text
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "tchvp_tpu_torch.cli", "serve", "--exported", "m.tchvp",
                             "--port", str(port), "--buckets", "1,2", *CPU], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"{url}/health", timeout=5)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.2)
        served = _run(["infer", "--url", url, "--synthetic", "2", *SMALL])
        exported = _run(["infer", "--exported", "m.tchvp", "--synthetic", "2", *SMALL, *CPU])
        live = _run(["eval", "--synthetic", "2", *SMALL, *CPU])
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    psnr = [float(re.search(r"PSNR ([0-9.]+) dB", t).group(1)) for t in (served, exported, live)]
    assert "served 2 batches via" in served and "served 2 batches from m.tchvp" in exported
    assert psnr[0] == psnr[1] and abs(psnr[1] - psnr[2]) <= 0.011  # eval prints 2 decimals
    assert "serving m.tchvp on http://127.0.0.1" in proc.stdout.read()


@pytest.mark.parametrize("argv,pattern", [
    (["infer", "--int8"], r"int8: 35 layers quantized, ([0-9.]+) dB vs bf16"),
    (["infer", "--int8", "--int8-dense"], r"int8: 41 layers quantized, ([0-9.]+) dB vs bf16"),
    (["eval", "--int8"], r"\[int8 serving\]: reconstruction PSNR ([0-9.]+) dB"),
])
def test_cli_int8(tmp_path, monkeypatch, argv, pattern):
    monkeypatch.chdir(tmp_path)
    text = _run(argv + ["--synthetic", "2", *SMALL, *CPU])
    m = re.search(pattern, text)
    assert m is not None and np.isfinite(float(m.group(1))), text


@pytest.mark.parametrize("argv", [["serve", "--exported", "m.tchvp", "--data-parallel"],
                                  ["serve", "--exported", "m.tchvp", "--mesh", "pipe=2"]])
def test_serve_parallel_modes_name_item_11(argv):
    """Both modes are ported: ``--data-parallel`` (item 11c) exits only for
    the missing artifact; ``--mesh pipe=N`` (live pipelined serving, item
    11f) refuses an artifact, as JAX's does."""
    with pytest.raises(SystemExit) as err:
        cli.main(argv + CPU)
    assert "not ported" not in str(err.value.code)
    if "--data-parallel" in argv:
        assert "no such artifact" in str(err.value.code)
    else:
        assert "--exported and --mesh pipe=N don't compose" in str(err.value.code)


def test_serve_artifact_data_parallel_names_item_11(artifact_path):
    """Data-parallel serving (item 11c, ported): one replica on the CPU, the
    default bucket one row per replica, a request served through it."""
    srv = serve_artifact(artifact_path, port=0, data_parallel=True, device="cpu").start()
    try:
        assert srv.model.n_devices == 1 and srv.buckets == (1,)
        host, port = srv.address
        out = post_npy(f"http://{host}:{port}/infer", _batch(1))
        assert out.shape == (1, CLIP_LEN, SIZE, SIZE, 3) and np.isfinite(out).all()
    finally:
        srv.shutdown()


def test_serve_mesh_pipe_two_ranks_matches_infer(tmp_path):
    """``serve --mesh pipe=2`` as two gloo ranks (rank 0 serves HTTP, rank 1
    follows each bucket's batch): /health reports the live pipelined model
    and its mesh, a request's reconstruction equals the one-process bf16
    model's on the same checkpoint (``infer``'s compute), and SIGINT to rank
    0 stops both ranks."""
    import signal

    import torch.multiprocessing as mp

    import torch_dist
    from tchvp_tpu_torch.data.pipeline import preprocess_clip
    from tchvp_tpu_torch.train import checkpoint as tckpt

    model = tvideo.VideoHybridNet(tcfg.flagship_video_config(SIZE, num_layers=2), device="cpu",
                                  generator=torch.Generator().manual_seed(1))
    tckpt.save_state(str(tmp_path / "ckpt"), 1, model)
    port = _free_port()
    argv = ["serve", "--mesh", "pipe=2", "--checkpoint", str(tmp_path / "ckpt" / "step_1"), "--port", str(port),
            "--buckets", "1,2", "--image-size", str(SIZE), "--layers", "2", "--clip-len", str(CLIP_LEN), *CPU]
    ctx = mp.start_processes(torch_dist.run_cli, args=(2, str(tmp_path / "rendezvous"), str(tmp_path), argv),
                             nprocs=2, join=False, start_method="spawn")
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 240
        while True:
            try:
                health = json.loads(urllib.request.urlopen(f"{url}/health", timeout=5).read())
                break
            except OSError:
                assert all(p.is_alive() for p in ctx.processes) and time.monotonic() < deadline
                time.sleep(0.2)
        out = post_npy(f"{url}/infer", _batch(3, seed=4))
    finally:
        os.kill(ctx.processes[0].pid, signal.SIGINT)
        stop = time.monotonic() + 120
        while not ctx.join(timeout=5):
            if time.monotonic() > stop:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the ranks did not stop after rank 0's SIGINT")
    assert health["meta"]["kind"] == "live_pipelined" and health["meta"]["mesh"] == {"pipe": 2}
    assert health["platforms"] == ["cpu"]
    one = cli._serving_model(cli._build_parser()[0].parse_args(argv), SIZE, torch.device("cpu"))
    with torch.inference_mode():
        want = one(preprocess_clip(torch.from_numpy(_batch(3, seed=4)), SIZE, dtype=torch.bfloat16))[1].float()
    assert out.shape == (3, CLIP_LEN, SIZE, SIZE, 3)
    # bf16: the pipeline runs the temporal stack on microbatches (1 or 2
    # clips a bucket), the model on 3 at once.
    np.testing.assert_allclose(out, want.numpy(), rtol=0, atol=2e-2)
    for r in range(2):
        res = torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False)
        assert "pipeline_shard_map" in res["seen"] and not res["jax_loaded"]
