"""Every mesh that JAX's ``video`` trains, on the port's gloo ranks, against
the JAX package's unsharded step: several model-side axes at once, and
``--fsdp`` beside each.

Counterpart of JAX's ``tests/test_flow_parallel.py`` meshes of two and
three model-side axes (JAX runs ``(data, seq, expert)``, ``(data, model,
expert)``, ``(data, seq, spatial)`` and ``(data, seq, model, expert)``;
its flow needs a ``data`` axis even of size 1, the port's drops an axis of
size 1 and needs none). One ``torch.multiprocessing`` launch of 4 ranks
runs ``tests/torch_dist.py::run_composed`` (which imports no JAX): one
step each under ``seq x expert``, ``model x expert``, ``spatial x
expert`` and ``seq x spatial`` (2 x 2), and ``data=2`` beside ``model``,
``seq`` and ``spatial`` with the state ZeRO-sharded over ``data``; each
held to JAX's single-device step on the whole batch at
``tests/test_torch_data_parallel.py``'s limits (metrics rtol 1e-5;
parameters 2e-2 x the largest update, since train-mode BatchNorm moves
fp32 roundings across ReLUs in any two implementations; BatchNorm stats
1e-5), each rank's experts against JAX's rows of the stack, and each
axis's dispatch markers. ``seq x expert`` again in float64 equals the
port's own one-process step within 1e-9 x the largest update, which shows
the fp32 distances are roundings, not a fault. Then what a rank holds of a
stepped FSDP state beside ``model`` and beside ``expert`` against the
``shards`` planner, a shard-wise resume under ``data x model --fsdp``
bit-equal to the uninterrupted run, and ``video --mesh seq=2,expert=2``
through ``cli.main``. One launch of 8 ranks runs ``seq x model x
expert``. ``cli.mesh_refusal``, a pure function, is held to JAX's
``cmd_video`` on every subset of the axes.
"""

import argparse
import itertools
import math
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_data_parallel as dp
import test_torch_plan
import torch_dist
from tchvp_tpu import cli as jcli
from tchvp_tpu import config as jcfg
from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, FRAMES, BATCH = dp.SIZE, dp.FRAMES, 2
LAUNCH_DEADLINE_S = 900
AUX = 0.01
WINDOW = {"attn_impl": "windowed", "window_size": 2}
EXPERTS = {"num_experts": 4}
FLASH_WINDOW = {"attn_impl": "flash", "window_size": 2}
CLI_ARGV = ["video", "--synthetic", "1", "--epochs", "1", "--save-every", "1", "--image-size", str(SIZE),
            "--clip-len", str(FRAMES), "--batch-size", str(BATCH), "--layers", "1", "--attn-impl", "flash",
            "--window", "2", "--num-experts", "4", "--mesh", "seq=2,expert=2", "--device", "cpu"]


# JAX's four unsharded steps: (config, seed, aux weight).
JAX_CASES = {"win_moe": ({**WINDOW, **EXPERTS}, 11, AUX), "xla_moe": ({"attn_impl": "xla", **EXPERTS}, 12, AUX),
             "win": (WINDOW, 13, 0.0), "xla": ({"attn_impl": "xla"}, 14, 0.0)}


def _jax_config(kw_jax: dict):
    return dp._no_dropout(jcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32, **kw_jax))


@pytest.fixture(scope="module")
def seeded():
    """Each JAX case's seeded weights (flax variables of its shapes, from
    numpy) and batch."""
    return {name: (dp._seeded_variables(_jax_config(kw), seed),
                   np.random.default_rng(seed + 10).integers(0, 256, (BATCH, FRAMES, 48, 48, 3), dtype=np.uint8))
            for name, (kw, seed, _) in JAX_CASES.items()}


def _inputs(case, aux: float = 0.0, **kw_port) -> dict:
    variables, batch = case
    tc = dp._no_dropout(tcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32, **kw_port))
    return {"config": tc, "state": convert.from_flax(variables), "size": SIZE, "batch": batch, "aux": aux}


# case -> (JAX's step, the port's config beyond the flash route).
CASES = {
    "seq_expert": ("win_moe", dict(FLASH_WINDOW, seq_axis="seq", ep_axis="expert", **EXPERTS)),
    "model_expert": ("xla_moe", dict(attn_impl="flash", tp_axis="model", ep_axis="expert", **EXPERTS)),
    "spatial_expert": ("xla_moe", dict(attn_impl="flash", sp_axis="spatial", ep_axis="expert", **EXPERTS)),
    "seq_spatial": ("win", dict(FLASH_WINDOW, seq_axis="seq", sp_axis="spatial")),
    "data_model_fsdp": ("xla", dict(attn_impl="flash", tp_axis="model")),
    "data_seq_fsdp": ("win", dict(FLASH_WINDOW, seq_axis="seq")),
    "data_spatial_fsdp": ("xla", dict(attn_impl="flash", sp_axis="spatial")),
    "seq_model_expert": ("win_moe", dict(FLASH_WINDOW, seq_axis="seq", tp_axis="model", ep_axis="expert", **EXPERTS)),
}


@pytest.fixture(scope="module")
def inputs(seeded):
    """The ranks' inputs of each case."""
    got = {key: _inputs(seeded[j], AUX if "expert" in key else 0.0, **kw) for key, (j, kw) in CASES.items()}
    f64 = _inputs(seeded["win_moe"], AUX, **dict(CASES["seq_expert"][1], attn_impl="windowed"))
    f64["state"] = {k: v.double() if v.is_floating_point() else v for k, v in f64["state"].items()}
    got["seq_expert_f64"] = f64
    got["data_expert"] = _inputs(seeded["xla_moe"], AUX, attn_impl="flash", ep_axis="expert", **EXPERTS)
    resume = dict(got["data_model_fsdp"])
    resume["state2"] = {k: v * 0.5 if v.is_floating_point() else v for k, v in resume["state"].items()}
    got["resume"] = resume
    got["cli"] = CLI_ARGV
    return got


def _start(world: int, tmp, inputs):
    return tmp, mp.start_processes(torch_dist.run_composed, args=(world, str(tmp / "rendezvous"), str(tmp), inputs),
                                   nprocs=world, join=False, start_method="spawn")


def _join(world: int, started) -> list:
    tmp, ctx = started
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    return [torch.load(tmp / f"composed{world}_rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def launched(tmp_path_factory, inputs):
    """The launch of 4 ranks, started: JAX's steps run here meanwhile."""
    keys = [k for k, *_ in torch_dist.COMPOSED_CASES] + ["seq_expert_f64", "data_expert", "resume", "cli"]
    return _start(4, tmp_path_factory.mktemp("composed4"), {k: inputs[k] for k in keys})


@pytest.fixture(scope="module")
def cases(seeded, inputs, launched):
    """case -> (the ranks' inputs, JAX's state after its step, its
    metrics), JAX's steps computed while the ranks run."""
    steps = {name: dp._jax_step(_jax_config(kw), seeded[name][0], seeded[name][1], aux)
             for name, (kw, _, aux) in JAX_CASES.items()}
    return {key: (inputs[key],) + steps[j] for key, (j, _) in CASES.items()}


@pytest.fixture(scope="module")
def ranks(launched, cases):
    return _join(4, launched)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory, inputs, ranks):
    return _join(8, _start(8, tmp_path_factory.mktemp("composed8"), {"seq_model_expert": inputs["seq_model_expert"]}))


def _check_composed(got: list, inputs, want, metrics, axes) -> None:
    """:func:`dp._check_video` on the replicated parameters, each rank's
    experts against JAX's rows of the stack, and each axis's markers."""
    for r in got:
        need = set().union(*(torch_dist.AXIS_MARKERS.get(a, set()) for a in axes))
        assert need <= r["seen"], (axes, sorted(need - r["seen"]))
    names = got[0]["expert_names"]
    keys = ("loss", "psnr") + (("moe_aux", "moe_drop_frac") if names else ())
    dp._check_video(got, inputs, {k: v for k, v in want.items() if k not in names}, metrics, keys=keys)
    init = inputs["state"]
    grad_max = max((init[k] - want[k]).abs().max().item() for k in want if "running" not in k)
    for name in names:
        for r in got:
            e = r["expert_index"]
            np.testing.assert_allclose(r["state"][name].numpy(), want[name].numpy()[2 * e:2 * e + 2],
                                       atol=2e-2 * grad_max, rtol=0, err_msg=name)


@pytest.mark.parametrize("key", [k for k, *_ in torch_dist.COMPOSED_CASES])
def test_composed_step_matches_jax(ranks, cases, key):
    """One step under two mesh axes equals JAX's unsharded step on the
    global batch; with FSDP beside model, seq or spatial each rank held its
    slices of the large parameters between steps."""
    inputs, want, metrics = cases[key]
    got = [r[key] for r in ranks]
    axes = dict((k, names) for k, names, *_ in torch_dist.COMPOSED_CASES)[key]
    _check_composed(got, inputs, want, metrics, axes)
    if key.endswith("_fsdp"):
        assert all("fsdp_constrain" in r["seen"] and r["sliced"] for r in got)


def test_seq_model_expert_step_matches_jax(eight_ranks, cases):
    """Three model-side axes at once: (seq 2, model 2, expert 2) on 8 ranks,
    the halo kernels' plain versions on 4 of 8 heads a rank, 2 of 4 experts
    a rank."""
    inputs, want, metrics = cases["seq_model_expert"]
    _check_composed([r["seq_model_expert"] for r in eight_ranks], inputs, want, metrics, ("seq", "model", "expert"))


def test_seq_expert_float64_equals_one_process(ranks, inputs):
    """``seq x expert`` in float64 equals the port's one-process step on the
    global batch within 1e-9 x the largest update: every gradient is summed
    over ``seq`` once (each rank's rows of the routed output carry its
    cotangent; the gathered routing's aux loss is averaged over the seq
    ranks that all computed it) and over no axis whose ranks computed the
    same thing; the BatchNorm stats to fp32's precision of the statistics.
    The attention is the dense band ("windowed"), whose fp32 logits (JAX's
    ``preferred_element_type``) are the same numbers per window with and
    without the halo; the flash route's plain halo and band versions sum
    theirs in other orders, which a float64 run reads at fp32's precision."""
    inputs = inputs["seq_expert_f64"]
    model = VideoHybridNet(inputs["config"], device="cpu").to(torch.float64)
    model.load_state_dict(inputs["state"], strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    with torch_dist.float64_clips():
        _, m = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, moe_aux_weight=AUX)(
            state, torch.from_numpy(inputs["batch"]))
    one, init = model.state_dict(), inputs["state"]
    gmax = max((init[k] - one[k]).abs().max().item() for k in one if "running" not in k and "num_batches" not in k)
    for r in ranks:
        got = r["seq_expert_f64"]
        assert got["equal"] and {"seq_sharded_shard_map", "moe_ep_shard_map"} <= got["seen"]
        for k in ("loss", "moe_aux", "moe_drop_frac"):
            np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=1e-7, err_msg=k)
        e = got["expert_index"]
        for k, v in one.items():
            if k in got["expert_names"]:
                v = v[2 * e:2 * e + 2]
            atol = 1e-6 if "running" in k or "num_batches" in k else 1e-9 * gmax
            torch.testing.assert_close(got["state"][k], v, atol=atol, rtol=1e-6 if "running" in k else 0, msg=k)


@pytest.mark.parametrize("axis", ["model", "expert"])
def test_plan_is_the_live_fsdp_state_beside_another_axis(ranks, inputs, axis):
    """``shards``' planner on a stepped FSDP state (AdamW with clipping and
    the EMA) beside ``model`` and beside ``expert``: every spec is the
    run-time's and each rank holds the planned bytes. JAX's planner has no
    rule for ``model`` (ROADMAP §3, gaps of the reference), so the leaves
    that tensor parallelism slices at use are planned whole over ``model``,
    as a rank holds them between steps."""
    from tchvp_tpu_torch.parallel import plan

    inputs = inputs["data_model_fsdp" if axis == "model" else "data_expert"]
    with torch.device("meta"):
        model = VideoHybridNet(inputs["config"], device="meta")
    got = plan.plan_state(plan.abstract_train_state(model, torch_dist._rich_opt()), {"data": 2, axis: 2},
                          fsdp_axis="data", ep_axis="expert" if axis == "expert" else None,
                          num_experts=4 if axis == "expert" else 0)
    origins = {r.origin for r in got.section("params")}
    assert {"fsdp", "ep"} <= origins if axis == "expert" else "fsdp" in origins
    for r in ranks:
        test_torch_plan.assert_plan_is_live(got, r[f"planned_{axis}"])


def test_fsdp_beside_model_resumes_bit_equal(ranks):
    """Under ``data=2, model=2 --fsdp``: epoch 1 saved shard-wise, a fresh
    flow of other weights resumed from it, and its epoch 2 bit-equal to the
    uninterrupted run's, parameters, moments and EMA; the last checkpoint
    read whole by one process (no process group) holds the run's
    parameters."""
    for r in ranks:
        got = r["resume"]
        assert got["start"] == 1 and got["steps"] == (2, 2) and got["sliced"] > 0
        assert got["differ"] == [], got["differ"][:4]
    restored = ckpt.restore_state(ranks[0]["resume"]["path"])["model"]
    assert restored.keys() == ranks[0]["resume"]["params"].keys()
    for k, v in ranks[0]["resume"]["params"].items():
        torch.testing.assert_close(restored[k], v, atol=0, rtol=0, msg=k)


def test_cli_seq_expert_mesh(ranks):
    """``video --mesh seq=2,expert=2 --window 2 --num-experts 4`` through
    ``cli.main`` as four ranks: the halo path and the expert dispatch, a
    finite loss printed; its checkpoint, each expert rank's slice written
    by its own rank, read whole by one process with all 4 experts and
    their moments."""
    for r in ranks:
        seen, printed = r["cli"]["seen"], r["cli"]["printed"]
        assert {"seq_sharded_shard_map", "windowed_mha_halo", "moe_ep_shard_map"} <= seen, sorted(seen)
        assert np.isfinite(float(printed.split("loss ")[1].split()[0])), printed
    whole = ckpt.restore_state(ranks[0]["cli"]["path"])
    name = "temporal.layers.0.moe.w1"
    assert whole["model"][name].shape[0] == 4 and whole["opt_state"]["moments"][name]["exp_avg"].shape[0] == 4


def test_ranks_loaded_no_jax(ranks, eight_ranks):
    for r in ranks + eight_ranks:
        assert not r["jax_loaded"], r["jax_loaded"]


# ------------------------------------------------------------ the mesh rule


class _Accepted(Exception):
    pass


def _jax_video_refusal(monkeypatch, axes: dict, flags: list):
    """JAX's ``cmd_video`` on ``--mesh`` of ``axes`` and ``flags``: its
    SystemExit message, or None where it goes on to build its flow (the
    device count, the model and the flow stubbed)."""
    from tchvp_tpu.train import loops as jloops

    def mesh(args):
        if not axes:
            return None
        return types.SimpleNamespace(axis_names=tuple(axes), devices=np.empty(tuple(axes.values())))

    def accepted(*a, **k):
        raise _Accepted()

    monkeypatch.setattr(jcli, "_mesh", mesh)
    monkeypatch.setattr(jcli, "_video_model", lambda args: None)
    monkeypatch.setattr(jloops, "VideoFlow", accepted)
    spec = ",".join(f"{k}={v}" for k, v in axes.items())
    try:
        jcli.main(["video", "--synthetic", "1"] + (["--mesh", spec] if spec else []) + flags)
    except _Accepted:
        return None
    except SystemExit as e:
        return str(e.code)
    raise AssertionError("JAX's cmd_video neither refused nor built its flow")


def _port_args(cmd: str, flags: list = ()) -> argparse.Namespace:
    """``cmd``'s arguments as the port's CLI parses them."""
    return cli._build_parser()[0].parse_args([cmd, *flags])


FLAG_SETS = (["--window", "2", "--num-experts", "4"], ["--num-experts", "4"], ["--window", "2"],
             ["--attn-impl", "ring", "--num-experts", "4"], ["--window", "2", "--num-experts", "4", "--fsdp"],
             ["--fsdp", "--layers", "3"])
MODEL_SIDE = ("seq", "model", "expert", "spatial", "pipe")


@pytest.mark.parametrize("subset", [s for n in range(len(MODEL_SIDE) + 1) for s in itertools.combinations(MODEL_SIDE, n)],
                         ids=lambda s: "+".join(s) or "none")
def test_mesh_refusal_is_jax_video_rule(monkeypatch, subset):
    """For a subset of the model-side axes, with and without ``data``, under
    each set of flags: ``mesh_refusal`` accepts what JAX's ``cmd_video``
    accepts and refuses the rest with JAX's message; the one difference is
    ``--fsdp`` on a mesh without ``data``, which the port refuses (JAX's CLI
    passes it to a flow that needs the axis)."""
    for data, flags in itertools.product((False, True), FLAG_SETS):
        axes = dict({"data": 2} if data else {}, **{a: 2 for a in subset})
        want = _jax_video_refusal(monkeypatch, axes, flags)
        got = cli.mesh_refusal(_port_args("video", flags), axes, world=math.prod(axes.values()))
        if want is None and "--fsdp" in flags and axes and not data:
            assert got is not None and "data=" in got, (axes, flags, got)
        elif want is not None and want.startswith("--fsdp"):  # JAX's words, then the port's item
            assert got == f"{want} [ROADMAP.md, item 11d]", (axes, flags, got)
        else:
            assert got == want, (axes, flags)


@pytest.mark.parametrize("flags,axes", [(["--data-parallel", "--fsdp"], {}), (["--fsdp"], {"data": 2})],
                         ids=["data-parallel", "mesh-data"])
def test_fsdp_needs_more_than_one_process(flags, axes):
    """``--fsdp`` over one process's data axis (``--data-parallel`` or
    ``--mesh data=2`` launched once): the mesh is dropped, so JAX's refusal
    of ``--fsdp`` without a mesh; over two processes it runs."""
    args = _port_args("video", flags)
    assert cli.mesh_refusal(args, axes, world=1) == cli.FSDP_NEEDS_A_MESH
    assert cli.mesh_refusal(args, axes, world=2) is None


@pytest.mark.parametrize("cmd,axes", [("segment", ("spatial",)), ("infer", ("pipe",)), ("serve", ("pipe",)),
                                      ("eval", ("seq",)), ("stream", ()), ("denoise", ()), ("transfer", ())])
def test_other_commands_keep_their_axes(cmd, axes):
    """Every command but ``video`` runs ``data`` and its own axes, and
    refuses the others by name."""
    for axis in MODEL_SIDE:
        got = cli.mesh_refusal(_port_args(cmd), {"data": 2, axis: 2}, world=4)
        assert (got is None) == (axis in axes), (cmd, axis, got)
        if got is not None:
            assert got.startswith(f"{cmd}: unsupported mesh axes ['{axis}'] ({cmd} supports data="), got
