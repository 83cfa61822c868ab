"""The port's FSDP (ZeRO-3) state sharding and its shard-wise checkpoints
against the JAX package, on 4 gloo ranks.

Counterpart of JAX's ``tests/test_fsdp.py`` and
``tests/test_sharded_checkpoint.py``. One ``torch.multiprocessing`` launch
of 4 ranks runs ``tests/torch_dist.py::run_fsdp`` (which imports no JAX):
FSDP over the ``data`` axis of a ("data", "rep") mesh of (2, 2), so two data
ranks each hold half of every large parameter, its moments and its EMA
("rep" is an axis nothing reads: the two rows are replicas); a save over
data=4 for the elastic restore onto data=2; a data x expert ``VideoFlow``;
and ``video --mesh data=2,expert=2 --fsdp`` through the CLI. Dropout and
input noise are off, SGD lr 1 where a step is compared, as in
``tests/test_torch_data_parallel.py``, whose tolerances hold here: metrics
rtol 1e-5, parameters 2e-2 x the largest gradient, BatchNorm stats 1e-5.
This process, which has no process group, reads the shard-wise checkpoints
whole, as ``eval``, ``infer`` and ``export`` do.
"""

import contextlib
import io
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_data_parallel as dp
import test_torch_plan
import torch_dist
from tchvp_tpu.parallel import fsdp as jfsdp
from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.parallel import fsdp
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from tchvp_tpu import config as jcfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD = 4
LAUNCH_DEADLINE_S = 900
CLIP = 0.05  # a global-norm limit every step here exceeds
CLI_ARGV = ["video", "--synthetic", "1", "--epochs", "1", "--save-every", "1", "--image-size", "32",
            "--layers", "1", "--batch-size", "4", "--clip-len", "2", "--num-experts", "4",
            "--device-prefetch", "0", "--device", "cpu", "--mesh", "data=2,expert=2", "--fsdp"]


def _moe_case():
    tc = dp._no_dropout(tcfg.flagship_video_config(image_size=dp.SIZE, num_heads=8, hidden_dim=32,
                                                   attn_impl="xla", num_experts=4, ep_axis="expert"))
    jc = dp._no_dropout(jcfg.flagship_video_config(image_size=dp.SIZE, num_heads=8, hidden_dim=32,
                                                   attn_impl="xla", num_experts=4))
    batch = np.random.default_rng(31).integers(0, 256, (4, dp.FRAMES, 48, 48, 3), dtype=np.uint8)
    return {"config": tc, "state": convert.from_flax(dp._seeded_variables(jc, 5)),
            "state2": convert.from_flax(dp._seeded_variables(jc, 6)), "size": dp.SIZE, "batch": batch}


@pytest.fixture(scope="module")
def video_case():
    inputs, want, metrics = dp._video_case({"attn_impl": "xla"}, {"attn_impl": "flash"}, 4, 0)
    jc = dp._no_dropout(jcfg.flagship_video_config(image_size=dp.SIZE, num_heads=8, hidden_dim=32))
    inputs["state2"] = convert.from_flax(dp._seeded_variables(jc, 7))
    return inputs, want, metrics


@pytest.fixture(scope="module")
def whole_checkpoint(tmp_path_factory, video_case):
    """A whole (one-process) checkpoint of a stepped state with the rich
    optimizer, written by this process."""
    inputs = video_case[0]
    model = VideoHybridNet(inputs["config"], device="cpu")
    model.load_state_dict(inputs["state"])
    state = tstate.create_train_state(model, torch_dist._rich_opt(), rng=3)
    state, _ = tsteps.make_video_train_step(inputs["size"], loss="mse", noise_std=0.0)(
        state, torch.from_numpy(inputs["batch"]))
    return ckpt.save_state(str(tmp_path_factory.mktemp("whole")), 5, state)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, video_case, whole_checkpoint):
    tmp = tmp_path_factory.mktemp("fsdp")
    video = dict(video_case[0], whole_path=whole_checkpoint)
    inputs = {"video": video, "moe": _moe_case(), "clip": CLIP,
              "cli": CLI_ARGV + ["--checkpoint-dir", str(tmp / "cli")]}
    ctx = mp.start_processes(torch_dist.run_fsdp, args=(WORLD, str(tmp / "rendezvous"), str(tmp), inputs),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    return tmp, [torch.load(tmp / f"fsdp_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _blocks_match(local: dict, whole: dict) -> list:
    """The keys of a rank's leaves (``_local_leaves``) that are not, bit for
    bit, their block of the whole tensors ``whole`` (by the same keys)."""
    bad = []
    for key, (t, where) in local.items():
        if key not in whole:
            continue
        w = whole[key]
        if where is not None:
            dim, n, i = where
            w = w.narrow(dim, i * (w.shape[dim] // n), w.shape[dim] // n)
        if not torch.equal(t, w):
            bad.append(key)
    return bad


def _flat(raw: dict) -> dict:
    """A payload's tensors by the shard-wise checkpoint's keys."""
    out = {f"model.{k}": v for k, v in raw["model"].items()}
    opt = raw.get("opt_state") or {}
    for n, st in opt.get("moments", {}).items():
        out.update({f"moment.{n}.{k}": v for k, v in st.items()})
    out.update({f"ema.{k}": v for k, v in (opt.get("ema") or {}).items()})
    out.update({f"generator.{k}": v for k, v in (raw.get("generators") or {}).items()})
    return out


# ------------------------------------------------------------ the placement


@pytest.mark.parametrize("shape,size,min_elems", [
    ((3, 3, 128, 256), 8, jfsdp.MIN_SHARD_ELEMS),   # cout largest and divisible
    ((3, 3, 384, 256), 8, jfsdp.MIN_SHARD_ELEMS),   # the largest divisible wins wherever it is
    ((512,), 8, jfsdp.MIN_SHARD_ELEMS),             # a BN vector: too small
    ((3, 3, 3, 100), 8, 1),                          # no divisible dim
    ((1024, 1024), 1, jfsdp.MIN_SHARD_ELEMS),       # axis size 1
    ((256, 256, 3, 3), 2, jfsdp.MIN_SHARD_ELEMS),   # equal sizes: the first
    ((4096, 2048), 2, jfsdp.MIN_SHARD_ELEMS),
    ((4, 4096, 2048), 4, jfsdp.MIN_SHARD_ELEMS),
    ((64, 64), 2, jfsdp.MIN_SHARD_ELEMS),           # exactly the threshold
    ((63, 64), 2, jfsdp.MIN_SHARD_ELEMS),           # one row under it
])
def test_fsdp_leaf_spec_picks_largest_divisible_dim(shape, size, min_elems):
    want = tuple(jfsdp.fsdp_leaf_spec(shape, "data", size, min_elems))
    got = fsdp.fsdp_leaf_spec(shape, "data", size, min_elems)
    assert got == want or (got == () and all(s is None for s in want)), (got, want)


def test_state_shardings_keep_buffers_and_experts_whole():
    model = VideoHybridNet(tcfg.flagship_video_config(image_size=32), device="cpu")

    class Mesh:
        mesh_dim_names = ("data",)

        def size(self, dim=None):
            return 2

    specs = fsdp.state_shardings(model, Mesh(), "data")
    assert specs.keys() == model.state_dict().keys()
    assert all(specs[k] == () for k in specs if "running" in k or "num_batches" in k)
    assert specs["temporal.layers.0.ffn1.weight"] == ("data", None)  # (2048, 64): hidden dim
    assert specs["encoder.stem_bn.weight"] == ()


# ------------------------------------------------------------ the step


def test_fsdp_step_matches_replicated_dp(ranks, video_case):
    """Two data ranks' FSDP step against JAX's step on the global batch and
    against the port's replicated data-parallel step; the marker, the state
    bytes a rank holds, and the parameters still in slices after the
    update."""
    _, results = ranks
    inputs, want, metrics = video_case
    got = [r["fsdp"] for r in results]
    dp._check_video(got, inputs, want, metrics)
    for r, rep in zip(got, (r["dp"] for r in results)):
        assert "fsdp_constrain" in r["seen"] and "fsdp_constrain" not in rep["seen"]
        local, whole = r["bytes"]
        assert local <= 0.55 * whole, (local, whole)
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(r["metrics"][k], rep["metrics"][k], rtol=1e-6)
        for k, v in rep["state"].items():
            torch.testing.assert_close(r["state"][k], v, atol=1e-6, rtol=0, msg=k)
    params = dict(VideoHybridNet(inputs["config"], device="cpu").named_parameters())
    big = [k for k in params if fsdp.leaf_dim(tuple(params[k].shape), 2) is not None]
    assert big and set(got[0]["sliced"]) == set(big)


def test_plan_is_the_live_fsdp_state_after_a_step(ranks, video_case):
    """``shards``' planner on the state of ``tests/torch_dist.py::_stepped``
    (AdamW with the EMA, FSDP over data of (data=2, rep=2)): every spec is
    ``state_shardings``'s and each rank holds the planned bytes, plus its
    generators' states."""
    from tchvp_tpu_torch.parallel import plan

    _, results = ranks
    with torch.device("meta"):
        model = VideoHybridNet(video_case[0]["config"], device="meta")
    got = plan.plan_state(plan.abstract_train_state(model, torch_dist._rich_opt()), {"data": 2, "rep": 2},
                          fsdp_axis="data")
    assert any(r.origin == "fsdp" for r in got.section("opt_state"))
    for r in results:
        test_torch_plan.assert_plan_is_live(got, r["planned"])


def test_fsdp_dormant_without_mesh(ranks):
    _, results = ranks
    d = results[0]["dormant"]
    assert "fsdp_constrain" not in d["data"]["seen"]
    assert np.isfinite(d["data"]["loss"]) and d["data"]["loss"] == d[None]["loss"]
    for k, v in d[None]["state"].items():
        assert torch.equal(d["data"]["state"][k], v), k


def test_fsdp_grad_clip_takes_the_global_norm(ranks, video_case):
    """``grad_clip_norm`` under FSDP clips by the norm of the whole
    gradient: each rank's squares of its slices summed over the data axis,
    the replicated leaves once. A rank's own norm would scale the update by
    another factor on each rank."""
    _, results = ranks
    inputs = video_case[0]
    one = results[0]["clip_one"]
    init = inputs["state"]
    grad_max = max((init[k] - one["state"][k]).abs().max().item() for k in init
                   if "running" not in k and "num_batches" not in k)
    for r in results:
        got = r["clip"]
        assert got["equal"]
        np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
        for k, v in one["state"].items():
            if "num_batches" in k:
                continue
            atol = 1e-5 if "running" in k else 2e-2 * grad_max
            torch.testing.assert_close(got["state"][k], v, atol=atol, rtol=0, msg=k)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sharded_roundtrip_no_gather(ranks, mode):
    tmp, results = ranks
    for r in results:
        got = r["roundtrip"][mode]
        assert r["roundtrip"]["sharded_state"] and got["sharded"]
        assert got["differ_before"] and not got["differ"], got["differ"]
        assert got["gathers"] == 0, "a shard-wise save or restore gathered whole parameters"
        assert got["step"] == 3 and got["extra"] == {"loss_history": [2.0, 1.0]}
        assert sum(f.endswith(".distcp") for f in got["files"]) == WORLD
    # Every rank's slices are the blocks of the whole the checkpoint holds.
    whole = _flat(ckpt.restore_state(str(tmp / f"roundtrip_{mode}" / "step_3")))
    for r in results:
        assert not _blocks_match(r["roundtrip"]["local"], whole)


def test_sharded_roundtrip_on_a_mesh_without_groups(ranks):
    """The DTensors of a checkpoint on a mesh of CUDA devices live on a CPU
    twin of it with no process groups (``checkpoint._cpu_mesh``): the twin
    has the mesh's coordinates, and a save and restore through it round
    trip."""
    _, results = ranks
    for r in results:
        got = r["twin"]
        assert got["twin_is_new"] and got["coordinate"][0] == got["coordinate"][1]
        assert not got["differ"], got["differ"]


def test_elastic_restore_onto_smaller_mesh(ranks):
    """Saved over data=4, restored onto data=2: each rank reads its half of
    each leaf (another dimension where the rule picks one), no gather."""
    tmp, results = ranks
    whole = _flat(ckpt.restore_state(str(tmp / "elastic" / "step_1")))
    assert any(w is not None and w[1] == 4 for _, w in results[0]["elastic_src"]["local"].values())
    for r in results:
        got = r["elastic"]
        assert got["gathers"] == 0 and got["step"] == 1
        assert any(w is not None and w[1] == 2 for _, w in got["local"].values())
        assert not _blocks_match(got["local"], whole)
        assert not _blocks_match(r["elastic_src"]["local"], whole)


def test_host_readers_handle_sharded_checkpoints(ranks, video_case):
    """This process, without a process group, reads a shard-wise checkpoint
    whole: ``restore_state`` (payload) and ``restore_params`` (model)."""
    tmp, results = ranks
    path = str(tmp / "roundtrip_sync" / "step_3")
    assert ckpt.is_sharded_checkpoint(path) and not torch.distributed.is_initialized()
    raw = ckpt.restore_state(path)
    params = ckpt.restore_params(path)
    shapes = {k: tuple(v.shape) for k, v in video_case[0]["state"].items()}
    assert {k: tuple(v.shape) for k, v in raw["model"].items()} == shapes
    assert params.keys() == raw["model"].keys()
    assert all(torch.equal(params[k], raw["model"][k]) for k in params)
    assert raw["step"] == 3 and raw["opt_state"]["count"] == 1 and raw["train_step"] == 1
    model = VideoHybridNet(video_case[0]["config"], device="cpu")
    model.load_state_dict(raw["model"])  # loadable whole
    state = tstate.create_train_state(model, torch_dist._rich_opt(), rng=3)
    ckpt.load_payload(state, raw)  # the whole optimizer state too


def test_host_checkpoint_restores_into_sharded_state(ranks, whole_checkpoint):
    _, results = ranks
    whole = _flat(ckpt.restore_state(whole_checkpoint))
    for r in results:
        got = r["whole_into_sharded"]
        assert got["sharded"] and got["step"] == 5
        assert any(w is not None for _, w in got["local"].values())
        assert not _blocks_match(got["local"], whole)


@pytest.mark.parametrize("case", ["flow", "flow_moe"])
def test_videoflow_fsdp_resume_sharded(ranks, case):
    """VideoFlow(fsdp_axis="data") shards at init (on a data x expert mesh
    beside the experts' own placement), trains with async shard-wise saves,
    resumes in a fresh flow bit for bit and trains on (the port restores the
    step count, which JAX's flow starts afresh)."""
    tmp, results = ranks
    whole = _flat(ckpt.restore_state(str(tmp / case / "ckpt" / "step_2")))
    for r in results:
        got = r[case]
        assert "FSDP over 'data' (2 ranks)" in got["printed"]
        assert got["start"] == 2 and not got["differ"], got["differ"]
        assert got["steps_after"] == 3  # the restored count of 2, then epoch 3's step
        assert not _blocks_match(got["local"], whole)
        big = [k for k, s in got["shapes"].items() if k in got["sliced"] and ".moe." not in k
               and fsdp.leaf_dim(s, 2) is not None]
        assert big and all(got["sliced"][k] for k in big)
    if case == "flow_moe":
        w1 = [k for k in whole if k.startswith("model.") and k.endswith("moe.w1")]
        assert w1 and all(whole[k].shape[0] == 4 for k in w1)  # every expert in the whole read


def test_videoflow_fsdp_integration(ranks):
    """The flow's FSDP line: a rank's state bytes about half the whole."""
    _, results = ranks
    line = results[0]["flow"]["printed"]
    local, whole = (int(x) for x in line.split("this rank ")[1].split(" of "))
    assert local <= 0.55 * whole


def test_video_fsdp_cli_ranks_and_whole_readers(ranks, tmp_path, monkeypatch):
    """``video --mesh data=2,expert=2 --num-experts 4 --fsdp`` as 4 ranks
    through the CLI; its shard-wise checkpoint read whole by ``eval``,
    ``infer`` and ``export`` here."""
    tmp, results = ranks
    for r in results:
        assert "fsdp_constrain" in r["cli"]["seen"] and "moe_ep_shard_map" in r["cli"]["seen"]
        assert "Video epoch 1" in r["cli"]["printed"]
        assert not r["jax_loaded"]
    path = str(tmp / "cli" / "step_1")
    assert ckpt.is_sharded_checkpoint(path)
    monkeypatch.chdir(tmp_path)
    flags = ["--image-size", "32", "--layers", "1", "--clip-len", "2", "--num-experts", "4",
             "--device", "cpu", "--checkpoint", path]
    for argv in (["eval", "--synthetic", "1", "--batch-size", "2"],
                 ["infer", "--synthetic", "1", "--batch-size", "2"]):
        text = _run(argv + flags)
        assert "PSNR" in text, text
    out = tmp_path / "m.tchvp"
    _run(["export", "--out", str(out), *flags])
    assert out.exists()


def _run(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def test_fsdp_without_a_data_mesh_refuses_naming_item_11d():
    with pytest.raises(SystemExit) as err:
        cli.main(["video", "--fsdp", "--synthetic", "1", "--device", "cpu"])
    assert "--fsdp requires" in str(err.value.code) and "item 11d" in str(err.value.code)


def test_fsdp_axis_needs_its_mesh():
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import VideoFlow

    model = VideoHybridNet(tcfg.flagship_video_config(image_size=32, hidden_dim=32), device="cpu")
    with pytest.raises(ValueError, match="fsdp_axis"):
        VideoFlow(model, cfg=TrainConfig(model_name="video"), image_size=32, fsdp_axis="data")
