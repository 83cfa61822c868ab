"""The port's GPipe pipeline over the ``pipe`` axis against the JAX
package's monolithic flagship, on 4 gloo ranks.

Counterpart of JAX's ``tests/test_parallel.py`` pipeline tests
(``pipeline_apply`` against the sequential composition, the pipelined step
against the monolithic one with the temporal dropout off, the pipelined
layout and its refusals) and ``tests/test_flow_parallel.py``'s pipelined
flows and layout-elastic resume. One ``torch.multiprocessing`` launch of 4
ranks runs ``tests/torch_dist.py::run_pipeline`` (which imports no JAX):
pipe=2 on a ("rep", "pipe") mesh of (2, 2) ("rep": two replicas), then
data=2 x pipe=2. Each rank holds one stage of the temporal layers and its
moments; the CNN runs on every rank. Steps run with dropout and input noise
off, SGD lr 1, and are held at ``tests/test_torch_data_parallel.py``'s
limits.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_data_parallel as dp
import test_torch_plan
import torch_dist
from tchvp_tpu import config as jcfg
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.parallel import pipeline as jppl
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import cli, convert
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch.config import TrainConfig
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.parallel import pipeline as ppl
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train.loops import VideoFlow
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD = 4
LAUNCH_DEADLINE_S = 900
CPU = ["--device", "cpu"]


def _jax_step(jc, variables, batch, accum: int = 1):
    """JAX's monolithic step (SGD lr 1, MSE, no noise) on the whole batch."""
    model = jvideo.VideoHybridNet(config=jc)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    new, metrics = jsteps.make_video_train_step(dp.SIZE, loss="mse", noise_std=0.0, accum_steps=accum)(
        st, jnp.asarray(batch))
    want = convert.from_flax({"params": jax.tree.map(np.asarray, new.params),
                              "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    return want, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def cases():
    jc = dp._no_dropout(jcfg.flagship_video_config(image_size=dp.SIZE, num_heads=8, hidden_dim=32, num_layers=2))
    tc = dp._no_dropout(tcfg.flagship_video_config(image_size=dp.SIZE, num_heads=8, hidden_dim=32, num_layers=2,
                                                   attn_impl="flash"))
    # tests/test_torch_data_parallel.py's "video" case (seed 0, batch 4),
    # which holds the data-parallel step to the same JAX step.
    variables = dp._seeded_variables(jc, 0)
    batch = np.random.default_rng(10).integers(0, 256, (4, dp.FRAMES, 48, 48, 3), dtype=np.uint8)
    video = {"config": tc, "state": convert.from_flax(variables), "size": dp.SIZE, "batch": batch,
             "clip": tpipe.preprocess_clip(torch.from_numpy(batch), dp.SIZE).numpy()}
    rng = np.random.default_rng(3)
    apply = {"w": (rng.standard_normal((2, 6, 6)) / np.sqrt(6)).astype(np.float64),
             "x": rng.standard_normal((8, 6)), "m": 4}
    composed = {"moe_config": dp._no_dropout(tcfg.flagship_video_config(
        image_size=dp.SIZE, num_heads=8, hidden_dim=32, num_layers=2, attn_impl="flash", num_experts=2)),
        "size": dp.SIZE, "moe_batch": np.random.default_rng(18).integers(0, 256, (8, 2, 48, 48, 3), dtype=np.uint8)}
    return {"video": video, "accum": video, "apply": apply, "composed": composed, "variables": variables, "jc": jc,
            "want": _jax_step(jc, variables, batch), "want_accum": _jax_step(jc, variables, batch, accum=2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cases):
    tmp = tmp_path_factory.mktemp("pipe")
    inputs = {k: cases[k] for k in ("video", "accum", "apply", "composed")}
    ctx = mp.start_processes(torch_dist.run_pipeline, args=(WORLD, str(tmp / "rendezvous"), str(tmp), inputs),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    return tmp, [torch.load(tmp / f"pipe_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_schedule_and_microbatches_are_jax_s():
    assert ppl.schedule_ticks(8, 2) == jppl.schedule_ticks(8, 2) == 9
    for args in ((16, 2, 1), (8, 4, 2), (6, 2, 3), (4, 2, 1)):
        assert ppl.pick_microbatches(*args) == jppl.pick_microbatches(*args)
    with pytest.raises(ValueError, match="cannot split into microbatches"):
        ppl.pick_microbatches(4, 2, 8)


def test_stacking_grouping_and_layouts_are_jax_s(cases):
    """The pipelined layout's helpers against JAX's on one draw of weights:
    the stacked and grouped stages, and ``convert.from_flax`` of JAX's
    pipelined layout equal to that of its monolithic one."""
    jc, variables = cases["jc"], cases["variables"]
    rest, stacked = jppl.split_video_params(variables["params"], 2)
    grouped = jppl.group_stages(stacked, 1)
    want = convert.from_flax(variables)
    for pipelined in ({"rest": rest, "stages": stacked}, {"rest": rest, "stages": grouped}):
        got = convert.from_flax({"params": pipelined, "batch_stats": variables["batch_stats"]})
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for n_stages, shape in ((2, (2, 64)), (1, (1, 2, 64))):
        port = ppl.pipelined_layout(want, 2, n_stages)
        assert ppl.is_pipelined_params(port) and not ppl.is_pipelined_params(want)
        assert tuple(port["stages.norm.weight"].shape) == shape
        assert torch.equal(port["stages.attention.q_linear.weight"].reshape(2, 64, 64)[1],
                           want["temporal.layers.1.attention.q_linear.weight"])
        merged = ppl.merge_pipelined_params(port)
        assert merged.keys() == want.keys() and all(torch.equal(merged[k], want[k]) for k in want)
    del jc


def test_chain_stage_fn_applies_a_stage_s_layers_in_order():
    """``chain_stage_fn`` over a stage of ``group_stages``' layout: the
    layers in order, each given a generator folded from the stage's, and
    the layers' extras summed; the same with or without the grouping."""
    rng = np.random.default_rng(5)
    stacked = {"w": torch.from_numpy(rng.standard_normal((4, 3, 3)))}
    x = torch.from_numpy(rng.standard_normal((2, 3)))
    layer = lambda p, h: torch.tanh(h @ p["w"])  # noqa: E731
    want = x
    for i in range(4):
        want = layer({"w": stacked["w"][i]}, want)
    grouped = ppl.group_stages(stacked, 2)
    h = x
    for stage in range(2):
        h = ppl.chain_stage_fn(layer, 2)({k: v[stage] for k, v in grouped.items()}, h)
    torch.testing.assert_close(h, want, rtol=0, atol=0)
    noisy = lambda p, h, g: h + torch.rand(h.shape, generator=g, dtype=h.dtype)  # noqa: E731
    gen = torch.Generator().manual_seed(3)
    stage0 = {k: v[0] for k, v in grouped.items()}
    a = ppl.chain_stage_fn(noisy, 2, with_rng=True)(stage0, x, gen)
    b = ppl.chain_stage_fn(noisy, 2, with_rng=True)(stage0, x, gen)
    assert torch.equal(a, b) and not torch.equal(a, x)  # folding draws nothing from ``gen``
    counted = lambda p, h: (layer(p, h), torch.ones(2))  # noqa: E731
    _, ext = ppl.chain_stage_fn(counted, 2, with_extras=True)(stage0, x)
    assert ext.tolist() == [2.0, 2.0]


@pytest.mark.parametrize("key", ["apply", "data_apply"], ids=["pipe2", "data2_pipe2"])
def test_pipeline_apply_equals_the_sequential_composition(ranks, cases, key):
    """Forward and backward of a 2-stage tanh stack through the GPipe
    schedule (4 microbatches, 5 ticks) equal the sequential composition;
    each stage's weight gets its own row of the gradient; the stages'
    extras count only the 4 x 2 valid (stage, microbatch) pairs."""
    _, results = ranks
    inp = cases["apply"]
    w = torch.from_numpy(inp["w"]).requires_grad_()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    h = x
    for i in range(2):
        h = torch.tanh(h @ w[i])
    (h ** 2).sum().backward()
    for rank, r in enumerate(results):
        got = r[key]
        assert "pipeline_shard_map" in got["seen"]
        stage = rank % 2
        rows = slice(None) if key == "apply" else slice((rank // 2) * 4, (rank // 2 + 1) * 4)
        torch.testing.assert_close(got["y"], h.detach()[rows], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["y2"], h.detach()[rows], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["x_grad"], x.grad[rows], rtol=1e-12, atol=1e-12)
        if key == "apply":
            torch.testing.assert_close(got["w_grad"][stage], w.grad[stage], rtol=1e-12, atol=1e-12)
            assert float(got["w_grad"][1 - stage].abs().max()) == 0.0
        assert float(got["ext"][0]) == 2 * inp["m"]  # bubble ticks masked: (M + P - 1) * P calls made
        assert "2 stacked stages" not in got["stages_error"] and "4 stacked stages over a 2-device 'pipe' axis" \
            in got["stages_error"]
        assert "not divisible into 2 microbatches" in got["batch_error"] or "does not split" in got["batch_error"]


@pytest.mark.parametrize("case", ["pipe2", "data_pipe", "data_pipe_fsdp", "accum2", "remat"])
def test_pipelined_step_matches_jax_monolithic(ranks, cases, case):
    """pipe=2, data=2 x pipe=2, with the rest ZeRO-sharded over data, with
    accum_steps=2 (outside the pipeline) and with the stage body
    checkpointed: one step equals JAX's monolithic step on the global batch;
    the stages are (1, d) on each rank; the flash kernels' plain versions
    run in the stages."""
    _, results = ranks
    inputs = cases["video"]
    want, metrics = cases["want_accum"] if case == "accum2" else cases["want"]
    got = [r[case] for r in results]
    dp._check_video(got, inputs, want, metrics)
    # The schedule is an execution strategy: against the port's own
    # unpipelined step on the same mesh (one process, or data=2) the
    # pipelined step is exact to fp32 roundings of the microbatched GEMMs.
    mono = results[0]["mono" if case in ("pipe2", "accum2", "remat") else "data_mono"]
    if case == "accum2":
        mono = results[0]["mono_accum2"]
    init = inputs["state"]
    gmax = max((init[k] - mono["state"][k]).abs().max().item() for k in init if "running" not in k
               and "num_batches" not in k)
    for k, v in mono["state"].items():
        torch.testing.assert_close(got[0]["state"][k], v, rtol=0, atol=1e-4 * gmax if "running" not in k else 1e-6,
                                   msg=k)
    for r in got:
        assert {"pipeline_shard_map", "pp_constrain", "flash_mha_plain"} <= r["seen"], sorted(r["seen"])
        assert r["stage_shape"] == (1, (dp.SIZE // 4) ** 2)
        if case == "data_pipe_fsdp":
            assert "fsdp_constrain" in r["seen"]


def test_cnn_dropout_is_the_monolithic_draw_and_stages_decorrelate(ranks):
    """With the CNN's dropout on and the temporal's off, the pipelined
    forward's reconstruction is the monolithic model's on the same
    generator; with the temporal dropout on, two data ranks given the same
    tokens draw different stage masks (a (tick, stage) fold of each data
    rank's generator), the pipe ranks of one data rank the same."""
    _, results = ranks
    for r in results:
        got, want = r["dropout"]["cnn"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    tokens = [r["dropout"]["tokens"] for r in results]  # ranks (data, pipe) row-major
    assert torch.equal(tokens[0], tokens[1]) and torch.equal(tokens[2], tokens[3])
    assert not torch.allclose(tokens[0], tokens[2])


def test_pipelined_step_full_composition(ranks):
    """JAX's full composition in one step: data=2 x pipe=2, the rest
    ZeRO-sharded over data, accum_steps=2 outside the pipeline and a routed
    MoE stack (2 experts) with the per-microbatch aux estimator: two steps
    finite and moving, the markers, the MoE metrics in JAX's ranges, the
    stages on ``pipe`` and the largest rest parameter on ``data``."""
    _, results = ranks
    for r in results:
        got = r["composed"]
        assert {"pipeline_shard_map", "pp_constrain", "fsdp_constrain"} <= got["seen"], sorted(got["seen"])
        for m in got["metrics"]:
            assert np.isfinite(m["loss"]) and 2.0 <= m["moe_aux"] <= 4.0 and 0.0 <= m["moe_drop_frac"] <= 1.0, m
        assert got["metrics"][0]["loss"] != got["metrics"][1]["loss"]
        assert got["rest_placed"] and got["stage_placed"]
    assert len({r["composed"]["metrics"][1]["loss"] for r in results}) == 1


def test_restored_params_merge_a_pipelined_ema_payload(cases):
    """``--ema`` serving of a pipelined run: its EMA is in the pipelined
    layout too, and the checkpoint consumers merge it (and check its depth)
    as they merge the parameters."""
    state = cases["video"]["state"]
    pipelined = ppl.pipelined_layout(state, 2, 2)
    ema = {k: v + 1.0 for k, v in pipelined.items() if "running" not in k and "num_batches" not in k}
    merged = cli._restored_params({"model": pipelined, "opt_state": {"ema": ema}}, ema=True, expect_layers=2)
    want = {k: v if "running" in k or "num_batches" in k else v + 1.0 for k, v in state.items()}
    assert merged.keys() == state.keys()
    for k in state:
        assert torch.equal(merged[k], want[k]), k
    with pytest.raises(SystemExit, match="temporal depth"):
        cli._restored_params({"model": pipelined, "opt_state": {"ema": ema}}, ema=True, expect_layers=4)


def test_pipelined_flow_resumes_bit_equal_and_converts_layouts(ranks, cases, tmp_path, monkeypatch, capsys):
    """VideoFlow(pipe_axis): a shard-wise checkpoint of the pipelined layout,
    resumed bit for bit in its own layout; a monolithic checkpoint resumed
    into the pipelined layout (parameters, stats and AdamW moments
    converted); and the pipelined checkpoint read into the monolithic
    layout by one process, which then trains on."""
    tmp, results = ranks
    for r in results:
        flow = r["flow"]
        assert flow["same_layout"] == [] and flow["start"] == 1 and flow["sharded_ckpt"]
        assert "pipeline_shard_map" in flow["seen"] and "Video epoch 1" in flow["printed"]
        assert "[resume] checkpoint layout monolithic -> live pipelined" in flow["mono_printed"]
        assert "1 parts converted, 0 reset" in flow["mono_printed"]
        mono = results[0]["flow"]["mono_state"]
        assert flow["mono_into_pp"].keys() == mono.keys()
        for k in mono:
            assert torch.equal(flow["mono_into_pp"][k], mono[k]), k
    for rank, r in enumerate(results):
        want = results[0]["flow"]["mono_moments"][f"temporal.layers.{rank % 2}.ffn1.weight"]["exp_avg"]
        assert torch.equal(r["flow"]["mono_into_pp_moment"][0], want)
    # The pipelined checkpoint, whole, into one process's monolithic flow.
    inp = cases["video"]
    monkeypatch.chdir(tmp_path)
    model = VideoHybridNet(inp["config"], device="cpu")
    tc = TrainConfig(model_name="video", loss="mse", lr=1e-3, checkpoint_dir=str(tmp / "pp_flow"),
                     log_dir=str(tmp_path / "runs"), sample_dir=str(tmp_path / "samples"))
    flow = VideoFlow(model, cfg=tc, image_size=inp["size"])
    assert flow.resume(inp["batch"].shape[1]) == 1
    assert "[resume] checkpoint layout pipelined -> live monolithic" in capsys.readouterr().out
    whole = ckpt.restore_state(str(tmp / "pp_flow" / "step_1"))
    assert ppl.is_pipelined_params(whole["model"])
    merged = ppl.merge_pipelined_params(whole["model"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, merged[k]), k
    flow.train([inp["batch"]], epochs=2, clip_len=inp["batch"].shape[1], start_epoch=1, save_every=100)
    assert flow.state.step == 2


def test_pipelined_state_shardings_and_refusals(ranks, cases):
    """The specs of the pipelined layout on data=2 x pipe=2: every stacked
    stage leaf's leading dim on ``pipe``, every rest parameter by JAX's own
    ``fsdp_leaf_spec`` over ``data``, buffers replicated; and JAX's
    refusals of a stack it cannot pipeline."""
    from tchvp_tpu.parallel.fsdp import fsdp_leaf_spec as jfsdp_leaf_spec

    _, results = ranks
    got, shapes = results[0]["specs"], results[0]["shapes"]
    params = dict(VideoHybridNet(cases["video"]["config"], device="cpu").named_parameters())
    for k, spec in got.items():
        if k.startswith("stages."):
            assert spec == ("pipe",) + (None,) * (len(shapes[k]) - 1), k
        elif k[len("rest."):] in params:
            assert spec == tuple(jfsdp_leaf_spec(shapes[k], "data", 2)), k
        else:
            assert spec == (), k
    temporal = cases["video"]["config"].temporal
    with pytest.raises(ValueError, match="num_layers must be a multiple of the stage count"):
        ppl._check_stack(dataclasses.replace(temporal, num_layers=3), 2, "pipe")
    for field, value, match in (("seq_axis", "seq", "pp x sp inside a stage"),
                                ("ep_axis", "expert", "pp x ep inside a stage")):
        with pytest.raises(ValueError, match=match):
            ppl._check_stack(dataclasses.replace(temporal, num_experts=2, **{field: value}), 2, "pipe")


def test_plan_is_the_live_pipelined_state_after_a_step(ranks, cases):
    """``shards --mesh data=2,pipe=2 --fsdp``'s planner on the pipelined
    state after one step (SGD): every spec is ``pipeline_state_shardings``'s
    and each rank holds the planned bytes (its stage's rows, its slices of
    the rest), plus its generators' states."""
    from tchvp_tpu_torch.parallel import plan
    from tchvp_tpu_torch.train.state import make_optimizer

    _, results = ranks
    with torch.device("meta"):
        model = VideoHybridNet(cases["video"]["config"], device="meta")
    state = plan.abstract_pipelined_train_state(model, make_optimizer(1.0, optimizer="sgd"), 2)
    got = plan.plan_state(state, {"data": 2, "pipe": 2}, fsdp_axis="data", pipe_axis="pipe")
    assert {r.origin for r in got.section("opt_state")} >= {"pipe", "fsdp"}
    for r in results:
        test_torch_plan.assert_plan_is_live(got, r["planned"])


@pytest.mark.parametrize("argv,message", [
    (["video", "--mesh", "pipe=2,seq=2"], "video: --mesh pipe=N composes with data= only (got ['seq'])"),
    (["video", "--mesh", "pipe=2", "--qat"], "does not compose with --qat, and only --remat-policy full"),
    (["video", "--mesh", "pipe=2", "--remat-policy", "stages"], "only --remat-policy full"),
    (["video", "--mesh", "pipe=2", "--model", "ae32k"], "video: --mesh pipe=N needs --model hybrid"),
    (["video", "--mesh", "pipe=2", "--layers", "3"], "video: --layers 3 must be a multiple of pipe=2"),
    (["infer", "--mesh", "pipe=2", "--microbatch", "2"], "infer: --microbatch and --mesh pipe=N don't compose"),
    (["infer", "--mesh", "pipe=2", "--int8", "--int8-dense"], "infer: --int8-dense and --mesh pipe=N don't compose"),
    (["infer", "--mesh", "model=2"], "infer: unsupported mesh axes ['model'] (infer supports data= and pipe=)"),
    (["serve", "--mesh", "pipe=2"], "serve: --mesh pipe=N serves the weights of --checkpoint"),
    (["serve", "--mesh", "pipe=2", "--exported", "m.tchvp"], "serve: --exported and --mesh pipe=N don't compose"),
    (["serve", "--mesh", "data=2"], "serve: --mesh supports data=K,pipe=N"),
], ids=lambda x: "_".join(x) if isinstance(x, list) else "")
def test_pipeline_rejections_read_as_jax(tmp_path, monkeypatch, argv, message):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as err:
        cli.main(argv + ["--synthetic", "1", "--image-size", "32"] * (argv[0] != "serve") + CPU)
    assert message in str(err.value.code)


def test_ranks_loaded_no_jax(ranks):
    _, results = ranks
    for r in results:
        assert not r["jax_loaded"], r["jax_loaded"]


def test_weights_only_pipelined_checkpoint_counts_its_fresh_optimizer(cases, tmp_path, monkeypatch, capsys):
    """A weights-only checkpoint in the pipelined layout, resumed into a
    monolithic flow that keeps an EMA: the weights converted, the missing
    moments and EMA counted as resets (a deliberate difference from JAX's
    ``_overlay_opt_state``, which leaves a missing subtree uncounted), the
    EMA started from the converted weights."""
    inp = cases["video"]
    monkeypatch.chdir(tmp_path)
    pipelined = ppl.pipelined_layout(inp["state"], 2, 2)
    ckpt.save_payload(str(tmp_path / "w"), 1, {"format": ckpt.FORMAT, "step": 1, "model": pipelined,
                                               "extra": {"train_epoch": 1}})
    model = VideoHybridNet(inp["config"], device="cpu")
    tc = TrainConfig(model_name="video", loss="mse", lr=1e-3, ema_decay=0.9, checkpoint_dir=str(tmp_path / "w"),
                     log_dir=str(tmp_path / "runs"), sample_dir=str(tmp_path / "samples"))
    flow = VideoFlow(model, cfg=tc, image_size=inp["size"])
    assert flow.resume(inp["batch"].shape[1]) == 1
    assert "optimizer state: 0 parts converted, 2 reset" in capsys.readouterr().out  # moments, EMA
    live = model.state_dict()
    for k, v in inp["state"].items():
        assert torch.equal(live[k], v), k
    for n, e in flow.state.tx.ema.items():
        assert torch.equal(e, inp["state"][n]), n
