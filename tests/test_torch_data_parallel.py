"""The port's data parallelism on 2 and 4 gloo ranks against the JAX
package's GSPMD step on the global batch.

One ``torch.multiprocessing`` launch per world size runs every rank through
``tests/torch_dist.py::run_data`` (a ``file://`` rendezvous, a 180 s
process-group timeout, and a deadline on the launch); the ranks import the
port only. With dropout and input noise off (a data rank draws from
generators of its own, as JAX's sharded draws differ per shard):

* (a) ``data=2``: one train step of the flagship, each rank given its block
  of the global batch, against JAX's single-device
  ``make_video_train_step`` on the whole batch from the same weights: the
  loss and PSNR (rtol 1e-5), the parameters and the BatchNorm running
  stats (atol 1e-5), which every rank holds bit for bit;
* remat "stages" and ``accum_steps=2`` under ``data=2`` against the port's
  one-process step on the global batch (each rank takes its share of every
  global microbatch, as JAX slices the global batch);
* (b) ``data=2 x seq=2`` (4 ranks, the windowed flash route) and ``data=2 x
  expert=2`` (4 experts, aux weight 0.01: ``moe_aux`` and
  ``moe_drop_frac`` of the global batch), against JAX's steps likewise;
* (c) ``segment``'s step (FCT) and the denoising step under ``data=2``
  against the port's one-process steps on the global batch (which
  ``test_torch_fct.py`` and ``test_torch_image_flows.py`` hold to JAX);
* (d) ``GlobalBatchLoader``'s and ``sharded_clippack_loader``'s slices,
  concatenated, equal to the single-process batches;
* (e) ``DataParallelServingModel`` over two CPU replicas equal to the single
  model, and its refusal of a batch they do not divide;
* (f) ``video --mesh data=2`` through the CLI as two processes against one;
* (g) ``make_streamer(mesh=)`` under ``data=2``: the two ranks' blocks of a
  B 8 clip, concatenated, against JAX's ``make_streamer(mesh=)`` over the
  8 CPU devices at ``tests/test_torch_streaming.py``'s tolerance; with an
  int8 engine calibrated on the global batch, the same scales on both
  ranks and one process's int8 output.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist
from tchvp_tpu import config as jcfg
from tchvp_tpu.models import streaming as jstream
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.parallel import make_mesh as jax_mesh
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.config import AugmentConfig
from tchvp_tpu_torch.data.clippack import ClipPackDataset, pack_clips
from tchvp_tpu_torch.infer import export as texport
from tchvp_tpu_torch.models.autoencoder import AutoEncoder
from tchvp_tpu_torch.models.fct import FCT
from tchvp_tpu_torch.models import streaming as tstream
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, FRAMES = 32, 4
CPU = ["--device", "cpu"]
LAUNCH_DEADLINE_S = 600


def _no_dropout(c):
    return dataclasses.replace(c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
                               temporal=dataclasses.replace(c.temporal, dropout_rate=0.0))


def _spawn(target, world: int, tmp, inputs) -> list:
    """Every rank's results of ``target`` over ``world`` gloo ranks; a rank
    that fails, or a launch past its deadline, fails the test."""
    ctx = mp.start_processes(target, args=(world, str(tmp / "rendezvous"), str(tmp), inputs), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    return [torch.load(tmp / f"data_rank{r}.pt", weights_only=False) for r in range(world)]


def _jax_step(jc, variables, batch, aux: float = 0.0):
    """JAX's single-device step (SGD lr 1, MSE, no noise) on the whole batch."""
    model = jvideo.VideoHybridNet(config=jc)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    new, metrics = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, moe_aux_weight=aux)(
        st, jnp.asarray(batch))
    want = convert.from_flax({"params": jax.tree.map(np.asarray, new.params),
                              "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    return want, {k: float(v) for k, v in metrics.items()}


def _seeded_variables(jc, seed: int):
    """Flax variables of the JAX model's shapes, filled from numpy."""
    model = jvideo.VideoHybridNet(config=jc)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("kernel", "router", "w1", "w2"):
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1 if name in ("bias", "b1", "b2") else 0.2, x.shape)

    return {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
            for c in ("params", "batch_stats")}


def _video_case(kw_jax: dict, kw_port: dict, batch_size: int, seed: int, aux: float = 0.0):
    jc = _no_dropout(jcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32, **kw_jax))
    tc = _no_dropout(tcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32, **kw_port))
    variables = _seeded_variables(jc, seed)
    batch = np.random.default_rng(seed + 10).integers(0, 256, (batch_size, FRAMES, 48, 48, 3), dtype=np.uint8)
    want, metrics = _jax_step(jc, variables, batch, aux)
    inputs = {"config": tc, "state": convert.from_flax(variables), "size": SIZE, "batch": batch, "aux": aux}
    return inputs, want, metrics


@pytest.fixture(scope="module")
def video_cases():
    return {
        "video": _video_case({"attn_impl": "xla"}, {"attn_impl": "flash"}, 4, 0),
        "data_seq": _video_case({"attn_impl": "windowed", "window_size": 2},
                                {"attn_impl": "flash", "window_size": 2, "seq_axis": "seq"}, 2, 1),
        "data_expert": _video_case({"attn_impl": "xla", "num_experts": 4},
                                   {"attn_impl": "xla", "num_experts": 4, "ep_axis": "expert"}, 2, 2, aux=0.01),
    }


FCT_CONFIG = tcfg.FCTConfig(filters=(4, 8, 8, 8, 8, 8, 8, 8, 4), dropout_rate=0.0, attn_impl="xla")
AE_CONFIG = tcfg.AutoEncoderConfig(filters=(4, 8), dropout_rate=0.0)


@pytest.fixture(scope="module")
def flow_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_flows")
    rng = np.random.default_rng(4)
    clips = rng.integers(0, 256, (8, 2, 8, 8, 3), dtype=np.uint8)
    pack_clips(str(tmp / "clips.pack"), clips)
    seg = FCT(FCT_CONFIG, device="cpu")
    ae = AutoEncoder(AE_CONFIG, device="cpu")
    return {
        "batches": [rng.integers(0, 256, (4, 3, 5), dtype=np.uint8) for _ in range(2)],
        "clippack": str(tmp / "clips.pack"), "clippack_batch": 4,
        "fct_config": FCT_CONFIG, "fct_state": seg.state_dict(), "fct_size": 32,
        "seg_batch": (rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
                      (rng.uniform(size=(4, 32, 32, 1)) > 0.5).astype(np.uint8) * 255),
        "ae_config": AE_CONFIG, "ae_state": ae.state_dict(), "ae_size": 32,
        "ae_batch": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
    }


# The streaming case: the tiny model of tests/test_torch_streaming.py, B 8
# clips of 30x44 frames in 16^2 tiles, chunk 2 with 1 frame of context.
STREAM = dict(tile=16, chunk_len=2, ctx_frames=1)
STREAM_SIZE = 16


@pytest.fixture(scope="module")
def stream_case():
    """The inputs of the ranks' streamer, and JAX's ``make_streamer`` over a
    data mesh of the 8 CPU devices on the same clip."""
    kw = dict(input_dim=(STREAM_SIZE // 4) ** 2, hidden_dim=16, num_layers=1, num_heads=4, attn_impl="xla")
    jc = jcfg.VideoModelConfig(encoder=jcfg.ResNetAEConfig(layers=(1, 1), token_latent=True),
                               temporal=jcfg.TransformerConfig(**kw))
    tc = tcfg.VideoModelConfig(encoder=tcfg.ResNetAEConfig(layers=(1, 1), token_latent=True),
                               temporal=tcfg.TransformerConfig(**kw))
    model = jvideo.VideoHybridNet(config=jc)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, STREAM_SIZE, STREAM_SIZE, 3)))
    rng = np.random.default_rng(5)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1, x.shape)

    variables = {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
                 for c in ("params", "batch_stats")}
    clip = np.random.default_rng(6).uniform(size=(8, 4, 30, 44, 3)).astype(np.float32)
    streamer = jstream.make_streamer(model, variables, jstream.StreamingConfig(**STREAM), mesh=jax_mesh(("data",)))
    want = np.asarray(streamer(jnp.asarray(clip)))
    return {"config": tc, "state": convert.from_flax(variables), "clip": clip, "stream": STREAM}, want


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, video_cases, flow_inputs, stream_case):
    tmp = tmp_path_factory.mktemp("dp2")
    return _spawn(torch_dist.run_data, 2, tmp, {"video": video_cases["video"][0], "flows": flow_inputs,
                                                "stream": stream_case[0]})


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, video_cases):
    tmp = tmp_path_factory.mktemp("dp4")
    return _spawn(torch_dist.run_data, 4, tmp, {k: video_cases[k][0] for k in ("data_seq", "data_expert")})


def _check_video(results, inputs, want, metrics, keys=("loss", "psnr")):
    """The metrics within rtol 1e-5 of JAX's; every parameter within 2e-2 of
    the largest gradient of JAX's (``tests/test_torch_train.py``'s limit:
    train-mode BatchNorm moves fp32 roundings across ReLUs in any two
    implementations, the port's one process and JAX's as well) and the
    BatchNorm stats within 1e-5."""
    for r in results:
        for key in keys:
            np.testing.assert_allclose(r["metrics"][key], metrics[key], rtol=1e-5, err_msg=key)
        assert r["equal"], "the ranks' parameters or BatchNorm stats differ"
    state, init = results[0]["state"], inputs["state"]
    assert set(want) <= set(state)
    grad_max = max((init[k] - want[k]).abs().max().item() for k in want if "running" not in k)
    for key, val in want.items():
        if "num_batches" in key:  # JAX keeps no count
            continue
        atol = 1e-5 if "running" in key else 2e-2 * grad_max
        np.testing.assert_allclose(state[key].numpy(), val.numpy(), atol=atol, rtol=0, err_msg=key)


# ------------------------------------------------------------ (a), (b) the step


def test_data_parallel_step_matches_jax_global_batch(two_ranks, video_cases):
    inputs, want, metrics = video_cases["video"]
    _check_video([r["video"] for r in two_ranks], inputs, want, metrics)
    assert all("flash_mha_plain" in r["video"]["seen"] for r in two_ranks)


@pytest.mark.parametrize("policy,accum", [("stages", 1), ("none", 2)], ids=["remat_stages", "accum2"])
def test_remat_and_accum_under_data_match_one_process(two_ranks, video_cases, policy, accum):
    """Under data=2 the remat policies and accum_steps give one process's
    step on the global batch: with accum_steps each rank takes its share of
    every global microbatch, as JAX's step slices the global batch."""
    inputs = video_cases["video"][0]
    model = tvideo.VideoHybridNet(inputs["config"], device="cpu")
    model.load_state_dict(inputs["state"], strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    _, m = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, remat_policy=policy,
                                        accum_steps=accum)(state, torch.from_numpy(inputs["batch"]))
    one = model.state_dict()
    grad_max = max((init[k] - one[k]).abs().max().item() for k in one if "running" not in k and "num_batches" not in k)
    for r in two_ranks:
        got = r["options"][(policy, accum)]
        assert got["equal"], "the ranks' parameters or BatchNorm stats differ"
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
        for key, val in one.items():
            atol = 1e-5 if "running" in key or "num_batches" in key else 2e-2 * grad_max
            torch.testing.assert_close(got["state"][key], val, atol=atol, rtol=0, msg=key)


def test_data_seq_step_matches_jax_global_batch(four_ranks, video_cases):
    inputs, want, metrics = video_cases["data_seq"]
    _check_video([r["data_seq"] for r in four_ranks], inputs, want, metrics)
    assert all("windowed_mha_halo" in r["data_seq"]["seen"] for r in four_ranks)


def test_data_expert_step_matches_jax_global_batch(four_ranks, video_cases):
    inputs, want, metrics = video_cases["data_expert"]
    got = [r["data_expert"] for r in four_ranks]
    assert all("moe_ep_shard_map" in r["seen"] for r in got)
    _check_video(got, inputs, {k: v for k, v in want.items() if k not in got[0]["expert_names"]}, metrics,
                 keys=("loss", "psnr", "moe_aux", "moe_drop_frac"))
    # Each expert rank holds its two experts, the same on both data ranks.
    init = inputs["state"]
    grad_max = max((init[k] - want[k]).abs().max().item() for k in want if "running" not in k)
    for name in got[0]["expert_names"]:
        for r, e in ((0, 0), (1, 1)):
            np.testing.assert_allclose(got[r]["state"][name].numpy(), want[name].numpy()[2 * e:2 * e + 2],
                                       atol=2e-2 * grad_max, rtol=0, err_msg=name)
        torch.testing.assert_close(got[2]["state"][name], got[0]["state"][name], atol=0, rtol=0)


def test_ranks_loaded_no_jax(two_ranks, four_ranks):
    assert not any(r["jax_loaded"] for r in two_ranks + four_ranks)


# ------------------------------------------------------------ (c) the image flows


def _one_process(model, step, batch):
    """The metrics and state after one step (SGD lr 1) of one process."""
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    _, m = step(state, batch)
    return {k: float(v) for k, v in m.items()}, model.state_dict()


@pytest.mark.parametrize("name", ["segment", "denoise"])
def test_image_flow_steps_under_data_match_one_process(two_ranks, flow_inputs, name):
    if name == "segment":
        model = FCT(FCT_CONFIG, device="cpu")
        model.load_state_dict(flow_inputs["fct_state"])
        step = tsteps.make_segmentation_train_step(flow_inputs["fct_size"])
        batch = tuple(torch.from_numpy(a) for a in flow_inputs["seg_batch"])
    else:
        model = AutoEncoder(AE_CONFIG, device="cpu")
        model.load_state_dict(flow_inputs["ae_state"])
        aug = AugmentConfig(hflip_prob=0.0, noise_prob=0.0, max_blackout_patches=0)
        step = tsteps.make_denoising_train_step(flow_inputs["ae_size"], aug, "mse")
        batch = torch.from_numpy(flow_inputs["ae_batch"])
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with torch_dist.keep_everything():
        metrics, state = _one_process(model, step, batch)
    # SGD lr 1: the update is the gradient, which the ranks sum in another
    # order (the dice's sums, the gradients' mean).
    atol = 1e-4 * max((init[k] - v).abs().max().item() for k, v in state.items() if "running" not in k)
    for r in two_ranks:
        got = r["flows"][name]
        for key, val in metrics.items():
            np.testing.assert_allclose(got["metrics"][key], val, rtol=1e-5, err_msg=key)
        for key, val in state.items():
            torch.testing.assert_close(got["state"][key], val, atol=atol if "running" not in key else 1e-5, rtol=0,
                                       msg=key)


# ------------------------------------------------------------ (d) the loaders


def test_loader_slices_concatenate_to_the_global_batch(two_ranks, flow_inputs):
    for b, batch in enumerate(flow_inputs["batches"]):
        np.testing.assert_array_equal(np.concatenate([r["flows"]["slices"][b] for r in two_ranks]), batch)
    single = [np.asarray(b) for b in ClipPackDataset(flow_inputs["clippack"], flow_inputs["clippack_batch"],
                                                     shuffle=True, seed=3, prefer_native=False)]
    assert len(single) == len(two_ranks[0]["flows"]["clippack"]) == 2
    for b, batch in enumerate(single):
        np.testing.assert_array_equal(np.concatenate([r["flows"]["clippack"][b] for r in two_ranks]), batch)
    assert [r["flows"]["host_slice"] for r in two_ranks] == [(0, 4), (4, 4)]


def test_replicate_and_the_hybrid_mesh(two_ranks):
    """``replicate`` puts rank 0's values on every rank; ``make_hybrid_mesh``
    with two slices puts the replica axis outermost, ranks grouped
    contiguously on one host; on one host its default is one slice, as
    JAX's is off a multi-slice pod, so an ICI shape short of the world is
    refused, as is a layout that is not the world
    (``tests/test_torch_hosts.py`` holds both to JAX)."""
    for r, rank in enumerate(two_ranks):
        torch.testing.assert_close(rank["flows"]["replicated"], torch.zeros(3))
        assert rank["flows"]["hybrid"] == (("replica", "data"), (2, 1), r)
        assert rank["flows"]["hybrid_default"] == "1 slices x (1,) ici = 1 ranks, have 2"
        assert rank["flows"]["hybrid_error"] == "3 slices x (1,) ici = 3 ranks, have 2"


def test_loaders_give_each_rank_its_share_of_every_microbatch(two_ranks, flow_inputs):
    """With 2 microbatches of a global batch of 4, rank r reads rows r and
    2 + r: its share of each microbatch, in order, from both loaders."""
    single = [np.asarray(b) for b in ClipPackDataset(flow_inputs["clippack"], flow_inputs["clippack_batch"],
                                                     shuffle=True, seed=3, prefer_native=False)]
    for key, batches in (("slices_mb2", flow_inputs["batches"]), ("clippack_mb2", single)):
        assert len(two_ranks[0]["flows"][key]) == len(batches) == 2
        for b, batch in enumerate(batches):
            for r, rank in enumerate(two_ranks):
                np.testing.assert_array_equal(rank["flows"][key][b], batch[[r, 2 + r]], err_msg=key)


# ------------------------------------------------------------ (e) serving


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = tvideo.VideoHybridNet(tcfg.flagship_video_config(SIZE, num_layers=1), device="cpu",
                                  generator=torch.Generator().manual_seed(0)).eval()
    exported, record = texport.export_video_model(model, clip_len=2, image_size=SIZE)
    path = str(tmp_path_factory.mktemp("dp_srv") / "m.tchvp")
    texport.save_artifact(path, exported, record, meta={"model": "hybrid", "image_size": SIZE, "clip_len": 2})
    return texport.load_artifact(path, "cpu")


def test_data_parallel_serving_equals_the_single_model(artifact):
    dp = artifact.over_mesh(devices=["cpu", "cpu"])
    batch = np.random.default_rng(9).integers(0, 256, (4, 2, SIZE, SIZE, 3), dtype=np.uint8)
    assert dp.n_devices == 2 and dp.example_input().shape[0] == 2
    torch.testing.assert_close(dp(batch), artifact(batch), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="batch % 2 == 0"):
        dp(batch[:3])
    with pytest.raises(ValueError, match="the artifact runs on cpu"):
        artifact.over_mesh(devices=["meta"])


# ------------------------------------------------------------ (f) the CLI


def test_cli_data_mesh_two_ranks_match_one_process(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcfg, "flagship_video_config", torch_dist.flagship_without_dropout)
    monkeypatch.setattr(tsteps, "make_video_train_step", tsteps.make_video_train_step)
    torch_dist.without_noise(tsteps)
    argv = ["video", "--synthetic", "1", "--epochs", "1", "--image-size", "32", "--layers", "1",
            "--batch-size", "2", "--clip-len", "4", "--attn-impl", "flash", "--optimizer", "sgd", "--lr", "1",
            "--device-prefetch", "0", *CPU]
    cli.main(argv + ["--checkpoint-dir", str(tmp_path / "one")])
    ctx = mp.start_processes(torch_dist.run_cli_quiet, nprocs=2, join=False, start_method="spawn",
                             args=(2, str(tmp_path / "rendezvous"), str(tmp_path),
                                   argv + ["--mesh", "data=2", "--checkpoint-dir", str(tmp_path / "two")]))
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        assert time.monotonic() < deadline, "the two ranks did not finish"
    for r in range(2):
        res = torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False)
        assert "flash_mha_plain" in res["seen"] and not res["jax_loaded"]
    one = ckpt.restore_state(str(tmp_path / "one" / "step_1"))["model"]
    two = ckpt.restore_state(str(tmp_path / "two" / "step_1"))["model"]
    # As tests/test_torch_cli.py holds the seq mesh: the parameters within 2e-2
    # of the largest gradient (train-mode BatchNorm moves fp32 roundings
    # across ReLUs), the BatchNorm stats within 1e-5.
    init = cli._video_model(cli._build_parser()[0].parse_args(argv), "cpu").state_dict()
    assert one.keys() == two.keys() == init.keys()
    grads = {k: (init[k] - one[k]) / 1.9 for k in one if "running" not in k and "num_batches" not in k}
    atol = 1.9 * 2e-2 * max(g.abs().max().item() for g in grads.values())
    for k in one:
        torch.testing.assert_close(two[k], one[k], atol=atol if k in grads else 1e-5, rtol=0, msg=k)


# ------------------------------------------------------------ (g) streaming


def test_streamer_over_data_mesh_matches_jax(two_ranks, stream_case):
    """Each rank streams its block of 4 clips with no collective; the blocks,
    concatenated, are JAX's streamer over the data mesh of 8 devices."""
    inputs, want = stream_case
    got = [r["stream"] for r in two_ranks]
    assert all(g["block"].shape == (4,) + want.shape[1:] for g in got)
    np.testing.assert_allclose(torch.cat([g["block"] for g in got]).numpy(), want, atol=1e-4, rtol=1e-4)
    assert all(g["seen"] == {"sdpa_xla"} for g in got)
    assert all(g["spec"] == ("data", None, None, None, None) for g in got)
    tiles = torch.cat([g["tiles"] for g in got])
    assert tiles.shape[0] == 8 * 6 and got[0]["tiles"].shape[0] == tiles.shape[0] // 2


def test_streamer_over_data_mesh_refusals(two_ranks):
    for g in (r["stream"] for r in two_ranks):
        assert "not a multiple of data=2" in g["odd"]
        assert "no 'data' axis" in g["no_axis"]


def test_int8_streamer_over_data_mesh_has_one_process_scales(two_ranks, stream_case):
    """The engine calibrated on the global batch's tiles holds the same
    scales on both ranks, and the ranks' int8 blocks are one process's int8
    streamer on the whole batch."""
    from tchvp_tpu_torch.infer.quant import Int8Engine
    from tchvp_tpu_torch.ops import tiling

    inputs = stream_case[0]
    got = [r["stream"] for r in two_ranks]
    assert got[0]["scales"] == got[1]["scales"] and got[0]["scales"]
    model = tvideo.VideoHybridNet(inputs["config"], device="cpu")
    model.load_state_dict(inputs["state"], strict=True)
    cfg = tstream.StreamingConfig(**STREAM)
    clip = torch.from_numpy(inputs["clip"])
    tiles, _ = tiling.tile_frames(tiling.pad_frames(clip, cfg.tile)[0], cfg.tile)
    engine = Int8Engine(model).calibrate([tiles[:4, :2]])
    assert engine.scales == got[0]["scales"]
    want = tstream.make_streamer(model, cfg, int8_engine=engine)(clip)
    torch.testing.assert_close(torch.cat([g["int8"] for g in got]), want, atol=1e-5, rtol=1e-5)
