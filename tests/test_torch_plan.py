"""The port's sharding planner (``tchvp_tpu_torch/parallel/plan.py``)
against the JAX package's (``tchvp_tpu/parallel/plan.py``).

Counterpart of ``tests/test_plan.py``, on the same tiny flagship (32^2,
D 64, hidden 32, 4 heads):

* per section, the global and per-device bytes of both planners for
  ``data=8 --fsdp``, ``data=2,expert=2`` with 4 experts, ``data=4,pipe=2
  --fsdp`` (the pipelined layout) and ``data=1``, and leaf by leaf (through
  ``convert``'s name map) the bytes and whether the leaf is sharded. Two
  differences are exact and stated: torch's AdamW keeps a float32 ``step``
  per parameter (4 bytes each) where optax keeps one int32 ``count`` (4
  bytes), and the port's BatchNorm keeps an int64 ``num_batches_tracked``
  (8 bytes each) that flax does not;
* the bytes accounting, the expert rule, and no parallelism;
* the optimizer state the planner reckons against what the port's
  ``Optimizer`` holds after a step, for each optimizer and the EMA, to the
  byte (the rank tests of ``test_torch_fsdp.py`` and
  ``test_torch_pipeline.py`` hold the plan to a live sharded state with
  :func:`assert_plan_is_live`);
* the flagship at full width (256^2, D 4096) planned on the meta device:
  nothing allocated, in under 5 s;
* the ``shards`` command.
"""

import contextlib
import io
import math
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.models import VideoHybridNet as JVideo
from tchvp_tpu.parallel import plan as jplan
from tchvp_tpu.train import make_optimizer as jmake_optimizer
from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import moe
from tchvp_tpu_torch.parallel import fsdp
from tchvp_tpu_torch.parallel import plan
from tchvp_tpu_torch.train import state as tstate
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

IMAGE = 32
BATCH = (8, 2, IMAGE, IMAGE, 3)


def _temporal(module, num_layers: int, num_experts: int):
    return module.TransformerConfig(input_dim=(IMAGE // 4) ** 2, hidden_dim=32, num_layers=num_layers,
                                    num_heads=4, dropout_rate=0.0, num_experts=num_experts)


def _meta_model(num_layers: int = 1, num_experts: int = 0) -> VideoHybridNet:
    with torch.device("meta"):
        return VideoHybridNet(tcfg.VideoModelConfig(temporal=_temporal(tcfg, num_layers, num_experts)),
                              device="meta")


# mesh id: (axes, fsdp, num_experts, n_stages)
MESHES = {
    "data8_fsdp": ({"data": 8}, True, 0, 0),
    "data2_expert2": ({"data": 2, "expert": 2}, False, 4, 0),
    "data4_pipe2_fsdp": ({"data": 4, "pipe": 2}, True, 0, 2),
    "data1": ({"data": 1}, False, 0, 0),
}


def _plans(case: str):
    """JAX's plan and the port's of the same config and mesh."""
    axes, use_fsdp, experts, stages = MESHES[case]
    kw = dict(fsdp_axis="data" if use_fsdp else None, ep_axis="expert" if "expert" in axes else None,
              num_experts=experts, batch_axis="data", pipe_axis="pipe" if stages else None)
    layers = max(stages, 1)
    jmodel = JVideo(config=jcfg.VideoModelConfig(temporal=_temporal(jcfg, layers, experts)))
    example, jtx = jnp.zeros((1, 2, IMAGE, IMAGE, 3)), jmake_optimizer(1e-3)
    jstate = (jplan.abstract_pipelined_train_state(jmodel, example, jtx, stages) if stages
              else jplan.abstract_train_state(jmodel, example, jtx))
    want = jplan.plan_state(jstate, axes, batch_example={"clip": jax.ShapeDtypeStruct(BATCH, jnp.float32)}, **kw)
    model, tx = _meta_model(layers, experts), tstate.make_optimizer(1e-3)
    state = plan.abstract_pipelined_train_state(model, tx, stages) if stages else plan.abstract_train_state(model, tx)
    got = plan.plan_state(state, axes, batch_example={"clip": torch.empty(BATCH, device="meta")}, **kw)
    return want, got


def _port_name(path: str) -> str:
    """A JAX plan path (``encoder/stem_bn/scale``, ``rest/...``,
    ``stages/attention/q_linear/kernel``) -> the port's name, by
    ``convert``'s maps."""
    parts = path.split("/")
    prefix = ""
    if parts[0] in ("rest", "stages"):
        prefix, parts = parts[0] + ".", parts[1:]
        if prefix == "stages.":  # a stacked layer: map it as layer 0, then drop the layer
            parts = ["temporal", f"{parts[0]}_0"] + parts[1:]
    module, kind = convert._module_name(tuple(parts[:-1]))
    leaf = parts[-1]
    if kind != convert.MOE:
        leaf = "weight" if leaf == "kernel" else convert._LEAF[leaf]
    name = f"{module}.{leaf}"
    return prefix + (name.replace("temporal.layers.0.", "") if prefix == "stages." else name)


def _jax_rows(want, section: str, pipelined: bool) -> dict:
    """JAX's rows of a section by the port's path; the optimizer's moments
    as ``exp_avg.<name>`` / ``exp_avg_sq.<name>``, its scalars left out.
    JAX's pipelined state keeps its BatchNorm stats in the monolithic tree,
    the port's under ``rest.`` with the modules that hold them."""
    out = {}
    for r in want.section(section):
        if section == "opt_state":
            parts = r.path.split("/")
            moment = next((p for p in parts if p in ("mu", "nu")), None)
            if moment is None:
                continue
            rest = "/".join(parts[parts.index(moment) + 1:])
            out[f"{'exp_avg' if moment == 'mu' else 'exp_avg_sq'}.{_port_name(rest)}"] = r
        else:
            out[("rest." if pipelined and section == "batch_stats" else "") + _port_name(r.path)] = r
    return out


@pytest.mark.parametrize("case", list(MESHES))
def test_plan_matches_jax_per_section_and_leaf(case):
    want, got = _plans(case)
    wt, gt = want.totals(), got.totals()
    assert wt.keys() == gt.keys()
    for section in ("params", "grads", "batch"):
        assert gt[section] == wt[section], section
    # AdamW's step: a float32 per parameter in torch, one int32 count in optax.
    n_params = len(got.section("params"))
    jax_scalars = sum(r.bytes_global for r in want.section("opt_state") if not r.shape)
    assert jax_scalars == 4
    assert all(r.path.startswith("step.") for r in got.section("opt_state") if not r.shape)
    for i in range(2):
        assert gt["opt_state"][i] - wt["opt_state"][i] == 4 * n_params - jax_scalars
    # BatchNorm's num_batches_tracked: an int64 in the port, none in flax.
    n_bn = sum(r.path.endswith("num_batches_tracked") for r in got.section("batch_stats"))
    assert n_bn > 0
    for i in range(2):
        assert gt["batch_stats"][i] - wt["batch_stats"][i] == 8 * n_bn
    assert got.device_total() - want.device_total() == 4 * n_params - jax_scalars + 8 * n_bn
    # Leaf by leaf: bytes, and sharded or not (a conv kernel's dims are
    # ordered otherwise in the two layouts, so the dim may differ).
    for section in ("params", "grads", "opt_state", "batch_stats"):
        mine = {r.path: r for r in got.section(section) if r.shape}
        theirs = _jax_rows(want, section, pipelined=MESHES[case][3] > 0)
        assert mine.keys() == theirs.keys(), (section, sorted(set(mine) ^ set(theirs))[:4])
        for path, r in mine.items():
            w = theirs[path]
            assert (r.bytes_global, r.bytes_device, any(r.spec)) == (w.bytes_global, w.bytes_device, any(w.spec)), \
                (section, path)
            assert r.origin == w.origin, (section, path)
    assert len(got.notes) == len(want.notes)


def test_plan_bytes_accounting():
    model = _meta_model()
    got = plan.plan_state(plan.abstract_train_state(model, tstate.make_optimizer(1e-3)), {"data": 8},
                          fsdp_axis="data", batch_axis="data",
                          batch_example={"clip": torch.empty(BATCH, device="meta")})
    for r in got.rows:
        factor = 1
        for s, dim in zip(r.spec, r.shape):
            if s is not None:
                factor *= got.axes[s]
                assert dim % got.axes[s] == 0, r.path
        assert r.bytes_device * factor == r.bytes_global, r.path
    totals = got.totals()
    assert totals["grads"] == totals["params"]
    assert got.device_total() == sum(d for _, d in totals.values())
    assert totals["params"][1] < totals["params"][0]
    assert totals["batch"][1] * 8 == totals["batch"][0]
    assert all(not any(r.spec) for r in got.section("batch_stats"))


def test_plan_ep_leaves_follow_shard_experts():
    got = plan.plan_state(plan.abstract_train_state(_meta_model(num_experts=4), tstate.make_optimizer(1e-3)),
                          {"data": 2, "expert": 2}, ep_axis="expert", num_experts=4)
    ep = [r for r in got.section("params") if r.origin == "ep"]
    assert {r.path.rsplit(".", 1)[-1] for r in ep} == set(moe.EXPERT_PARAMS)
    for r in ep:
        assert r.spec[0] == "expert" and not any(r.spec[1:]) and r.shape[0] == 4
        assert r.bytes_device * 2 == r.bytes_global
    router = [r for r in got.section("params") if r.path.endswith("router")]
    assert router and all(r.origin != "ep" for r in router)
    assert all(r.origin == "ep" for r in got.section("opt_state") if r.path.rsplit(".", 1)[-1] in moe.EXPERT_PARAMS
               and r.shape)


def test_plan_without_parallelism_is_fully_replicated():
    got = plan.plan_state(plan.abstract_train_state(_meta_model(), tstate.make_optimizer(1e-3)), {"data": 1})
    assert all(not any(r.spec) for r in got.rows)
    assert all(g == d for g, d in got.totals().values())


def test_abstract_pipelined_state_refuses_an_uneven_stage_count():
    with pytest.raises(ValueError, match="multiple of the stage count"):
        plan.abstract_pipelined_train_state(_meta_model(num_layers=2), tstate.make_optimizer(1e-3), 3)
    with pytest.raises(ValueError, match="multiple of the stage count"):
        jplan.abstract_pipelined_train_state(JVideo(config=jcfg.VideoModelConfig(temporal=_temporal(jcfg, 2, 0))),
                                             jnp.zeros((1, 2, IMAGE, IMAGE, 3)), jmake_optimizer(1e-3), 3)


def _itemsize(dtype: str) -> int:
    return torch.empty(0, dtype=getattr(torch, dtype)).element_size()


def assert_plan_is_live(got, live: dict) -> None:
    """A plan against what a rank holds of the same state after a step
    (``tests/torch_dist.py::live_view``): every parameter's and buffer's
    spec is the run-time's, a moment's and the EMA's their parameter's;
    the plan's leaves are the state's, each at the bytes the rank holds;
    and its per-device bytes plus the generators' states are
    ``fsdp.sharded_size_bytes``."""
    def norm(spec, n):
        return tuple(spec) + (None,) * (n - len(spec))

    specs, leaves = live["specs"], live["leaves"]
    expect = {}
    for section in ("params", "batch_stats"):
        for r in got.section(section):
            assert norm(r.spec, len(r.shape)) == norm(specs[r.path], len(r.shape)), (section, r.path)
            expect[f"model.{r.path}"] = r
    for r in got.section("opt_state"):
        moment, _, name = r.path.partition(".")
        if r.shape:
            assert norm(r.spec, len(r.shape)) == norm(specs[name], len(r.shape)), r.path
        expect[f"ema.{name}" if moment == "ema" else f"moment.{name}.{moment}"] = r
    generators = {k for k in leaves if k.startswith("generator.")}
    assert generators == {"generator.noise", "generator.dropout"}
    assert expect.keys() == leaves.keys() - generators, sorted(set(expect) ^ (leaves.keys() - generators))[:4]
    for key, r in expect.items():
        shape, dtype = leaves[key]
        assert (math.prod(shape) * _itemsize(dtype), dtype) == (r.bytes_device, r.dtype), key
    gen_bytes = sum(math.prod(leaves[k][0]) * _itemsize(leaves[k][1]) for k in generators)
    assert sum(r.bytes_device for r in expect.values()) + gen_bytes == live["bytes"]


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd", "lion", "adamw_ema"])
def test_planned_optimizer_state_is_the_optimizer_s_after_a_step(opt):
    """One update of the port's ``Optimizer`` on a real (CPU) model: the
    moments torch made are the ones the planner reckoned, to the byte."""
    name, ema = opt.split("_")[0], opt.endswith("_ema")
    spec = tstate.make_optimizer(1e-3, optimizer=name, ema_decay=0.9 if ema else 0.0)
    cfg = tcfg.VideoModelConfig(temporal=_temporal(tcfg, 1, 0))
    model = VideoHybridNet(cfg, device="cpu")
    state = tstate.create_train_state(model, spec)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    state.tx.step()
    specs = {k: () for k in model.state_dict()}
    live = {"specs": specs, "bytes": fsdp.sharded_size_bytes(state),
            "leaves": {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                       for k, (t, _) in fsdp.state_leaves(state).items()}}
    assert_plan_is_live(plan.plan_state(plan.abstract_train_state(_meta_model(), spec), {"data": 1}), live)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_full_width_flagship_plans_on_meta_without_allocating():
    """The flagship at 256^2 (D 4096, 171 M parameters: 2.6 GB of fp32
    state with AdamW) planned over data=8 with FSDP: every leaf on the meta
    device, the process no larger, in under 5 s."""
    before, t0 = _rss_bytes(), time.perf_counter()
    with torch.device("meta"):
        model = VideoHybridNet(tcfg.flagship_video_config(256), device="meta")
    state = plan.abstract_train_state(model, tstate.make_optimizer(1e-4))
    got = plan.plan_state(state, {"data": 8}, fsdp_axis="data", batch_axis="data",
                          batch_example={"clip": torch.empty((8, 8, 256, 256, 3), device="meta")})
    text = got.table()
    seconds, grown = time.perf_counter() - t0, _rss_bytes() - before
    assert seconds < 5.0
    assert all(t.is_meta for tree in (state.params, state.opt_state, state.batch_stats) for t in tree.values())
    assert grown < 64 << 20, grown
    assert got.totals()["params"][0] == 4 * sum(p.numel() for p in model.parameters())
    assert "P(data, None)" in text and "temporal.layers.0.attention.q_linear.weight" in text


def _shards(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["shards", *argv])
    return out.getvalue()


def test_cli_shards_smoke():
    out = _shards(["--model", "hybrid", "--image-size", "32", "--clip-len", "2", "--mesh", "data=8", "--fsdp",
                   "--batch-size", "8"])
    assert "Sharding plan" in out and "data=8" in out
    assert "fsdp" in out and "reduce-scatter" in out
    assert f"of {plan.CARD_MEMORY_GIB:g} GiB HBM" in out


@pytest.mark.parametrize("model", ["fct", "unet", "ae", "combined", "ae32k", "ae4k"])
def test_cli_shards_other_families(model):
    out = _shards(["--model", model, "--image-size", "64", "--mesh", "data=4", "--fsdp", "--top", "3"])
    assert "Sharding plan — mesh {data=4} (4 devices)" in out and "fsdp" in out


def test_cli_shards_rejects_bad_mesh():
    with pytest.raises(SystemExit):
        cli.main(["shards", "--model", "hybrid", "--mesh", "data:8"])


def test_cli_shards_pipe_smoke():
    out = _shards(["--model", "hybrid", "--mesh", "data=4,pipe=2", "--layers", "2", "--image-size", str(IMAGE),
                   "--clip-len", "2", "--fsdp"])
    assert "pipeline-parallel over 'pipe'(2)" in out
    assert "ZeRO-shard over the data axis" in out
    assert "stages." in out and "P(pipe" in out
    with pytest.raises(SystemExit, match="multiple of pipe"):
        cli.main(["shards", "--model", "hybrid", "--mesh", "data=4,pipe=2", "--layers", "3",
                  "--image-size", str(IMAGE), "--clip-len", "2"])
    with pytest.raises(SystemExit, match="needs|plans --model hybrid"):
        cli.main(["shards", "--model", "ae32k", "--mesh", "pipe=2"])
