"""The port's checkpoint layer, event files, health monitor and run-time
helpers, against the JAX package where it has a counterpart.

* ``train/logging.py``: the same scalars at the same wall times give the
  same event-file and JSONL bytes as JAX's ``SummaryWriter``.
* ``train/checkpoint.py``: a save -> restore round trip (sync and async)
  is bit-equal in every tensor, moment, EMA entry, count and generator
  state; a restore refuses missing, extra, reshaped and retyped model
  entries, moments (keys, shapes, dtypes, missing, unknown), EMA entries
  and generator states, and leaves a stepped live state bit-equal when it
  does; an async writer's error is raised at the
  next join and only once; a save in flight is invisible to
  ``prune_step_dirs`` and ``latest_step_dir``; ``prune_step_dirs``,
  ``latest_step_dir`` and ``ensure_tag_scheme`` behave as JAX's on the
  same directories; a sharded save or restore raises naming item 11.
* ``train/health.py``: the monitor's verdicts equal JAX's on one loss
  stream; a flow poisoned with NaN restores its last checkpoint.
* ``with_ema_params``, ``utils/runrecord.py``, ``utils/profiling.py``.

The flows run at 32^2 with one temporal layer, input_dim 64, 4 heads (the
size of ``tests/test_flows.py``), on the CPU, torch on one thread.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tchvp_tpu.train import checkpoint as jckpt
from tchvp_tpu.train import health as jhealth
from tchvp_tpu.train import logging as jlogging
from tchvp_tpu.utils import profiling as jprofiling
from tchvp_tpu_torch.config import TrainConfig, TransformerConfig, VideoModelConfig
from tchvp_tpu_torch.data.synthetic import SyntheticClips
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import health
from tchvp_tpu_torch.train import logging as tlogging
from tchvp_tpu_torch.train.loops import VideoFlow
from tchvp_tpu_torch.train.state import with_ema_params
from tchvp_tpu_torch.utils import profiling, runrecord
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 32


def small_model(seed: int = 0) -> VideoHybridNet:
    cfg = VideoModelConfig(temporal=TransformerConfig(input_dim=64, hidden_dim=32, num_layers=1,
                                                      num_heads=4))
    return VideoHybridNet(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def small_flow(tmp_path, seed: int = 0, **cfg) -> VideoFlow:
    tc = TrainConfig(model_name="VID", loss="mse", lr=1e-3, checkpoint_dir=str(tmp_path / "ckpt"),
                     log_dir=str(tmp_path / "runs"), **cfg)
    return VideoFlow(small_model(seed), cfg=tc, image_size=SIZE)


def data(n: int = 2, seed: int = 0) -> SyntheticClips:
    return SyntheticClips(1, 4, SIZE, n, seed=seed)


def snapshot(state) -> dict:
    """Every tensor of the state, by name, cloned."""
    tx = state.tx
    names = {id(p): n for n, p in tx.named.items()}
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for p, st in tx.core.state.items():
        for k, v in st.items():
            out[f"moment.{names[id(p)]}.{k}"] = v.clone()
    for k, v in (tx.ema or {}).items():
        out[f"ema.{k}"] = v.clone()
    out["gen.noise"] = state.noise_generator.get_state()
    out["gen.dropout"] = state.dropout_generator.get_state()
    out["counts"] = torch.tensor([tx.count, tx.notfinite_count, state.step])
    return out


def snapshot_of_payload(raw: dict) -> dict:
    """:func:`snapshot`'s dict of a checkpoint payload."""
    opt = raw["opt_state"]
    out = {f"model.{k}": v for k, v in raw["model"].items()}
    for n, st in opt["moments"].items():
        out.update({f"moment.{n}.{k}": v for k, v in st.items()})
    out.update({f"ema.{k}": v for k, v in (opt["ema"] or {}).items()})
    out["gen.noise"], out["gen.dropout"] = raw["generators"]["noise"], raw["generators"]["dropout"]
    out["counts"] = torch.tensor([opt["count"], opt["notfinite_count"], raw["train_step"]])
    return out


def assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ------------------------------------------------------------------ logging


def test_summary_writer_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    scalars = [("Loss/Train", 0.4129, 1), ("PSNR/Train", 3.85, 1), ("Loss/Train", 1e-9, 12345),
               ("MoEAux/Train", -2.5, None)]
    files = {}
    for name, mod in (("jax", jlogging), ("torch", tlogging)):
        clock = iter(1792243162.0 + 0.125 * i for i in range(100))
        monkeypatch.setattr("time.time", lambda: next(clock))
        w = mod.SummaryWriter(str(tmp_path / name))
        for tag, value, step in scalars:
            w.add_scalar(tag, value, step)
        w.close()
        files[name] = {f: (tmp_path / name / f).read_bytes() for f in sorted(os.listdir(tmp_path / name))}
    assert list(files["torch"]) == list(files["jax"]) == ["events.out.tfevents.1792243162.host",
                                                          "metrics.jsonl"]
    assert files["torch"] == files["jax"]


# --------------------------------------------------------------- checkpoint


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A flow after 2 AdamW steps with an EMA, and its snapshot."""
    tmp = tmp_path_factory.mktemp("trained")
    flow = small_flow(tmp, ema_decay=0.9)
    flow.train(data(), epochs=1, clip_len=4, save_every=100)
    return flow, snapshot(flow.state)


@pytest.mark.parametrize("async_write", [False, True])
def test_round_trip_is_bit_equal(trained, tmp_path, async_write):
    flow, want = trained
    path = ckpt.save_state(str(tmp_path), 7, flow.state, extra={"train_epoch": 1},
                           async_write=async_write)
    assert path == str(tmp_path / "step_7")
    other = small_flow(tmp_path, seed=1, ema_decay=0.9)
    other.init_state(4)
    live = dict(other.state.model.named_parameters())
    state, raw = ckpt.restore_state_into(other.state, path)
    assert state is other.state and raw["step"] == 7 and raw["extra"] == {"train_epoch": 1}
    assert all(p is live[n] for n, p in state.model.named_parameters())  # copied in place
    assert_bit_equal(snapshot(state), want)
    assert sorted(os.listdir(tmp_path)) == ["step_7"]


def _refused(live, bad) -> str:
    """``load_payload(live, bad)`` raises ValueError and leaves every
    tensor, count and generator state of ``live`` bit-equal; the message."""
    before = snapshot(live)
    with pytest.raises(ValueError) as err:
        ckpt.load_payload(live, bad)
    assert_bit_equal(snapshot(live), before)
    return str(err.value)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """Another flow after one AdamW step with an EMA: every part of its
    state differs from ``trained``'s, so a partial write would show."""
    flow = small_flow(tmp_path_factory.mktemp("stepped"), seed=1, ema_decay=0.9)
    flow.train(data(1, seed=3), epochs=1, clip_len=4, save_every=100)
    return flow


def test_restore_refuses_mismatches_before_writing(trained, stepped, tmp_path):
    raw = ckpt.restore_state(ckpt.save_state(str(tmp_path), 1, trained[0].state))

    def model(fn):
        bad = {**raw, "model": dict(raw["model"])}
        fn(bad["model"])
        return _refused(stepped.state, bad)

    key = "encoder.stem_conv.weight"
    assert "lacks live keys" in model(lambda m: m.pop(key))
    assert "absent from the live state" in model(lambda m: m.update(extra=torch.zeros(1)))
    assert "shape" in model(lambda m: m.update({key: m[key][:1]}))
    assert "float64" in model(lambda m: m.update({key: m[key].double()}))
    no_ema = small_flow(tmp_path, seed=1)
    no_ema.train(data(1, seed=3), epochs=1, clip_len=4, save_every=100)
    assert "EMA" in _refused(no_ema.state, raw)


def _moment_variants():
    key = "encoder.stem_conv.weight"

    def retyped(m):
        m[key] = {**m[key], "exp_avg": m[key]["exp_avg"].double()}

    def reshaped(m):
        m[key] = {**m[key], "exp_avg_sq": m[key]["exp_avg_sq"][:1]}

    def rekeyed(m):
        m[key] = {**m[key], "momentum_buffer": m[key].pop("exp_avg")}

    def step_retyped(m):
        m[key] = {**m[key], "step": m[key]["step"].double()}

    return {"retyped": (retyped, "float64"), "reshaped": (reshaped, "shape"),
            "other_keys": (rekeyed, "momentum_buffer"), "step_retyped": (step_retyped, "step"),
            "missing": (lambda m: m.pop(key), "no moments for trainable"),
            "unknown": (lambda m: m.update(nope=m[key]), "absent from the live model")}


@pytest.mark.parametrize("variant", sorted(_moment_variants()))
def test_restore_refuses_bad_moments_before_writing(trained, stepped, tmp_path, variant):
    raw = ckpt.restore_state(ckpt.save_state(str(tmp_path), 1, trained[0].state))
    fn, msg = _moment_variants()[variant]
    moments = {n: dict(st) for n, st in raw["opt_state"]["moments"].items()}
    fn(moments)
    bad = {**raw, "opt_state": {**raw["opt_state"], "moments": moments}}
    assert msg in _refused(stepped.state, bad)


@pytest.mark.parametrize("variant", ["missing_key", "retyped", "generator"])
def test_restore_refuses_bad_ema_or_generator_before_writing(trained, stepped, tmp_path, variant):
    raw = ckpt.restore_state(ckpt.save_state(str(tmp_path), 1, trained[0].state))
    ema = dict(raw["opt_state"]["ema"])
    gens = dict(raw["generators"])
    key = "decoder.head_conv.bias"
    if variant == "missing_key":
        ema.pop(key)
    elif variant == "retyped":
        ema[key] = ema[key].half()
    else:
        gens["dropout"] = gens["dropout"][:8]
    bad = {**raw, "opt_state": {**raw["opt_state"], "ema": ema}, "generators": gens}
    assert ("generator" if variant == "generator" else "ema") in _refused(stepped.state, bad)


def test_restore_into_a_fresh_optimizer_takes_every_moment(trained, tmp_path):
    """A fresh live optimizer holds no moments yet; the checkpoint's are
    the ones its class keeps, and they are taken whole."""
    flow, want = trained
    assert set(flow.state.tx.core.state) == set(flow.state.tx.trainable)  # every trainable stepped
    other = small_flow(tmp_path, seed=1, ema_decay=0.9)
    other.init_state(4)
    ckpt.restore_state_into(other.state, ckpt.save_state(str(tmp_path), 1, flow.state))
    assert_bit_equal(snapshot(other.state), want)


def test_async_error_is_raised_at_the_next_join_once(trained, tmp_path):
    flow, _ = trained
    (tmp_path / "file").write_text("")
    ckpt.save_state(str(tmp_path / "file"), 1, flow.state, async_write=True)
    with pytest.raises(OSError):
        ckpt.wait_for_async_saves()
    ckpt.wait_for_async_saves()  # reported once, not again


def test_save_in_flight_is_invisible_to_prune_and_latest(trained, tmp_path, monkeypatch):
    flow, _ = trained
    ckpt.save_state(str(tmp_path), 1, flow.state)
    ckpt.save_state(str(tmp_path), 2, flow.state)
    release, started = threading.Event(), threading.Event()
    save = torch.save

    def slow_save(*a, **k):
        started.set()
        assert release.wait(30)
        return save(*a, **k)

    monkeypatch.setattr(torch, "save", slow_save)
    ckpt.save_state(str(tmp_path), 3, flow.state, async_write=True)
    assert started.wait(30)
    names = os.listdir(tmp_path)
    assert "step_3" not in names and any(n.startswith(".tmp-step_3") for n in names)
    assert ckpt.prune_step_dirs(str(tmp_path), 1) == 1  # step_1 only; the write is untouched
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("step_")) == ["step_2"]
    release.set()
    assert ckpt.latest_step_dir(str(tmp_path)) == str(tmp_path / "step_3")  # joins the writer
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]


def test_step_dir_helpers_match_jax(tmp_path):
    for name in ("jax", "torch"):
        for d in ("step_1", "step_10", "step_2", "step_x", "other", ".tmp-step_11-abcd"):
            (tmp_path / name / d).mkdir(parents=True)
    assert ckpt.latest_step_dir(str(tmp_path / "torch")) == str(tmp_path / "torch" / "step_10")
    assert jckpt.latest_step_dir(str(tmp_path / "jax")) == str(tmp_path / "jax" / "step_10")
    assert ckpt.prune_step_dirs(str(tmp_path / "torch"), 2) == jckpt.prune_step_dirs(
        str(tmp_path / "jax"), 2) == 1
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert ckpt.prune_step_dirs(str(tmp_path / "torch"), 0) == 0
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None
    errors = []
    for name, mod in (("jax", jckpt), ("torch", ckpt)):
        d = str(tmp_path / f"scheme_{name}")
        mod.ensure_tag_scheme(d, "epochs")
        mod.ensure_tag_scheme(d, "epochs")
        with pytest.raises(ValueError) as err:
            mod.ensure_tag_scheme(d, "steps")
        errors.append(str(err.value).replace(d, "DIR"))
    assert errors[0] == errors[1]


def test_sharded_checkpoints_raise_naming_item_11(trained, tmp_path):
    """``sharded=True`` (item 11d, ported): one process writes the
    shard-wise format (torch.distributed.checkpoint, no process group),
    reads it whole, and restores it bit for bit, also with ``sharded=True``
    on the restore; multi-rank cases are ``tests/test_torch_fsdp.py``'s."""
    flow, want = trained
    path = ckpt.save_state(str(tmp_path), 1, flow.state, extra={"train_epoch": 1}, sharded=True)
    assert ckpt.is_sharded_checkpoint(path) and not os.path.exists(os.path.join(path, ckpt.PAYLOAD))
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    for sharded in (None, True):
        other = small_flow(tmp_path / f"other_{sharded}", seed=1, ema_decay=0.9)
        other.init_state(4)
        state, raw = ckpt.restore_state_into(other.state, path, sharded=sharded)
        assert raw["step"] == 1 and raw["extra"] == {"train_epoch": 1}
        assert_bit_equal(snapshot(state), want)
    assert_bit_equal(snapshot_of_payload(ckpt.restore_state(path)), want)


def test_weights_only_and_subtree_restore(trained, tmp_path):
    flow, _ = trained
    path = ckpt.save_params(str(tmp_path), "best", flow.model)
    params = ckpt.restore_params(path)
    assert params.keys() == flow.model.state_dict().keys()
    fresh = small_model(seed=1)
    sub = ckpt.restore_subtree(path, ("encoder",))
    fresh.encoder.load_state_dict(sub["encoder"], strict=True)
    for k, v in fresh.encoder.state_dict().items():
        assert torch.equal(v, flow.model.encoder.state_dict()[k]), k
    with pytest.raises(KeyError):
        ckpt.restore_subtree(path, ("nope",))


def test_with_ema_params_swaps_a_copy(trained):
    flow, _ = trained
    ema_state = with_ema_params(flow.state)
    assert ema_state.model is not flow.state.model and ema_state.tx is flow.state.tx
    for n, p in ema_state.model.named_parameters():
        assert torch.equal(p, flow.state.tx.ema[n]), n
    assert not torch.equal(ema_state.model.encoder.stem_conv.weight,
                           flow.state.model.encoder.stem_conv.weight)
    for k, v in ema_state.model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, flow.state.model.state_dict()[k])


# ------------------------------------------------------------------- health


def test_health_monitor_verdicts_match_jax():
    stream = [1.0, 0.9, 50.0, float("nan"), 0.8, float("nan"), float("inf"), float("nan"), 0.7,
              0.6, 90.0, 0.5]
    ours, theirs = health.HealthMonitor(warmup_steps=2), jhealth.HealthMonitor(warmup_steps=2)
    assert [ours.check(x) for x in stream] == [theirs.check(x) for x in stream]
    assert ours.summary() == theirs.summary()


def test_video_flow_recovers_from_nan(tmp_path):
    """Sustained NaN loss: the flow restores the last step-tagged
    checkpoint, moments included, instead of continuing on garbage."""
    flow = small_flow(tmp_path)
    clean = [np.random.default_rng(0).integers(0, 255, (1, 4, SIZE, SIZE, 3), dtype=np.uint8)]
    flow.train(clean, epochs=1, clip_len=4, save_every=1)
    good = snapshot(flow.state)
    with torch.no_grad():
        for p in flow.model.parameters():
            p.fill_(float("nan"))
        for st in flow.state.tx.core.state.values():
            st["exp_avg"].fill_(float("nan"))
    mon = health.HealthMonitor(nan_tolerance=2, warmup_steps=0)
    flow.train(clean * 2, epochs=2, clip_len=4, start_epoch=1, save_every=100, health=mon)
    assert mon.nan_steps == 2 and not mon.diverged
    restored = {k: v for k, v in snapshot(flow.state).items() if k.startswith("model.")}
    assert all(torch.isfinite(v.float()).all() for v in restored.values())
    # Restored after the second NaN step: the saved state, not the poison.
    assert torch.equal(restored["model.decoder.head_conv.weight"], good["model.decoder.head_conv.weight"])

    fresh = small_flow(tmp_path / "none")
    fresh.init_state(4)
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.fill_(float("nan"))
    with pytest.raises(health.TrainingDiverged):
        fresh.train(clean * 2, epochs=1, clip_len=4, save_every=100,
                    health=health.HealthMonitor(nan_tolerance=2, warmup_steps=0))


# ------------------------------------------------------- run record, timing


def test_run_record_environment(tmp_path):
    import argparse

    args = argparse.Namespace(cmd="video", lr=1e-4, device="cpu", fn=print)
    path = runrecord.write_run_record(str(tmp_path), args, extra={"command": "video"})
    rec = json.loads(open(path).read())
    assert rec["command"] == "video" and rec["resolved_args"] == {"cmd": "video", "device": "cpu",
                                                                  "lr": 1e-4}
    env = rec["environment"]
    assert env["torch_version"] == torch.__version__ and env["device_name"] == "cpu"
    assert (env["rank"], env["world_size"]) == (0, 1) and "git_revision" in rec
    assert (env["host_index"], env["local_world"]) == (0, 1)


def test_step_timer_and_trace(tmp_path, monkeypatch):
    times = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 7.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(times))
    summaries = []
    for mod in (jprofiling, profiling):
        timer = mod.StepTimer(skip=1)
        for _ in range(4):
            with timer.step():
                pass
        summaries.append(timer.summary(items_per_step=8))
        times = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 7.5])
    assert summaries[0] == summaries[1]
    monkeypatch.undo()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("span"):
            torch.ones(4).sum()
    assert "span" in (tmp_path / "trace.json").read_text()
