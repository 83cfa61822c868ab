"""The port's segmentation path against the JAX package's, on the CPU:
``sobel_edges``, the segment step, ``SegmentationFlow``, the converter on
a JAX FCT ``TrainState`` and the ``segment``/``eval --model fct``/``summary
--model fct`` commands.

The FCT is narrow (filters (4, 8, 8, 8, 8, 8, 8, 8, 4), 2 heads) at 32^2,
"xla" attention, its weights a seeded flax tree carried by
``convert.from_flax`` (``tests/test_torch_fct.py``). Tolerances:

* ``sobel_edges``: max abs 1e-6 (values in [0, 1]); a flat input gives
  zeros in both;
* one segment step, every dropout rate 0 in the port and JAX's gradient
  from ``model.apply(..., deterministic=True)`` (JAX's Wide-Focus dropout
  has no switch and its masks cannot be reproduced): the dice loss rtol
  1e-5; the gradients within 2e-2 x max|grad|, the repo's limit for two
  fp32 implementations (measured 6.7e-7: no BatchNorm here); the
  parameters after the port's AdamW (clipped at 1.0) against optax's update
  of the same parameters from the port's own gradients, atol 1e-6;
* the flow's restore and resume: JAX's contract (``tests/test_flows.py``),
  moments bit-equal;
* ``SegmentationFlow`` against JAX's, every dropout off, the same weights
  and batches: 2 epochs, then restore of the best checkpoint and training
  to epoch 3. The printed epochs and the best-loss tags equal, each
  epoch's summed loss (``loss_history``) rtol 1e-5, the printed mean IoU
  within 1e-2 as the step's;
* ``eval --model fct`` on a JAX checkpoint of ``FCT()`` converted by
  ``convert.from_flax_state``: JAX's printed dice loss (4 decimals) within
  1e-4, its IoU (3 decimals) within 1e-3.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tchvp_tpu import cli as jcli
from tchvp_tpu import config as jcfg
from tchvp_tpu import losses as jlosses
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.models import fct as jfct
from tchvp_tpu.ops import sobel as jsobel
from tchvp_tpu.train import checkpoint as jckpt
from tchvp_tpu.train import loops as jloops
from tchvp_tpu.train import state as jstate
from tchvp_tpu_torch import cli, convert
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch.data.synthetic import SyntheticImageMasks
from tchvp_tpu_torch.models import fct as tfct
from tchvp_tpu_torch.ops import conv_attention as tca
from tchvp_tpu_torch.ops import sobel as tsobel
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from tchvp_tpu_torch.train.loops import SegmentationFlow
from test_torch_fct import FILTERS, _flax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 32
LR = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- sobel


@pytest.mark.parametrize("kind", ["random", "flat", "zeros"])
def test_sobel_edges_match_jax(kind):
    rng = np.random.default_rng(0)
    x = {"random": rng.uniform(0, 1, (2, 16, 20, 3)),
         "flat": np.full((1, 8, 8, 1), 0.7),
         "zeros": np.zeros((1, 8, 8, 2))}[kind].astype(np.float32)
    ref = np.asarray(jsobel.sobel_edges(jnp.asarray(x)))
    got = tsobel.sobel_edges(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.min() >= 0 and got.max() <= 1
    if kind != "random":
        assert not got.any()


# ---------------------------------------------------------------- step


def _no_dropout(model: tfct.FCT) -> tfct.FCT:
    """Every dropout rate 0: the blocks' (config) and Wide-Focus's."""
    for m in model.modules():
        if isinstance(m, tca.WideFocus):
            m.dropout_rate = 0.0
    return model


def _port_model(params, dropout: bool = False) -> tfct.FCT:
    cfg = tcfg.FCTConfig(filters=FILTERS, attn_impl="xla", dropout_rate=0.3 if dropout else 0.0)
    model = tfct.FCT(cfg, device="cpu")
    model.load_state_dict(convert.from_flax({"params": params}), strict=True)
    return model if dropout else _no_dropout(model)


def _to_flax(named: dict) -> dict:
    """The port's tensors by name -> a flax tree (the converter's maps run
    backwards: OIHW -> HWIO, (out, in) -> (in, out), weight -> scale)."""
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        a = t.detach().numpy()
        if leaf == "weight":
            leaf, a = ("scale", a) if a.ndim == 1 else ("kernel", a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0))
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.fixture(scope="module")
def fct_params():
    model = jfct.FCT(config=jcfg.FCTConfig(filters=FILTERS, attn_impl="xla"))
    return _flax_params(model, jnp.zeros((1, SIZE, SIZE, 3)), seed=20)


@pytest.fixture(scope="module")
def step_run(fct_params):
    """JAX's dice loss and gradients (deterministic) and the port's step."""
    image_u8, mask_u8 = next(iter(SyntheticImageMasks(2, SIZE, 1, seed=3)))
    x, y = (jpipe.preprocess_images(jnp.asarray(t), SIZE) for t in (image_u8, mask_u8))
    jmodel = jfct.FCT(config=jcfg.FCTConfig(filters=FILTERS, attn_impl="xla"))

    def loss_of(p):
        pred = jmodel.apply({"params": p}, x, deterministic=True)
        return jlosses.dice_loss(pred, y), pred

    (jloss, jpred), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(fct_params)
    model = _port_model(fct_params)
    state = tstate.create_train_state(model, tstate.make_optimizer(LR, grad_clip_norm=1.0), rng=0)
    grads = {}

    def mark(name):
        if name == "backward":
            grads.update({n: p.grad.clone() for n, p in model.named_parameters()})

    _, metrics = tsteps.make_segmentation_train_step(SIZE)(
        state, (torch.from_numpy(image_u8), torch.from_numpy(mask_u8)), mark=mark)
    return {"jax_loss": float(jloss), "jax_iou": float(jlosses.jaccard_score(jpred > 0.5, y > 0.5)),
            "jax_grads": jgrads, "params": fct_params, "model": model, "grads": grads,
            "metrics": {k: float(v) for k, v in metrics.items()}, "state": state}


def test_step_loss_and_iou_match_jax(step_run):
    np.testing.assert_allclose(step_run["metrics"]["loss"], step_run["jax_loss"], rtol=1e-5)
    assert abs(step_run["metrics"]["iou"] - step_run["jax_iou"]) <= 1e-2


def test_step_gradients_match_jax(step_run):
    got = _to_flax(step_run["grads"])
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(step_run["jax_grads"]))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, step_run["jax_grads"]))
    assert _max_diff(got, step_run["jax_grads"]) <= 2e-2 * gmax


def test_step_adamw_update_matches_optax_from_the_same_gradients(step_run):
    tx = jstate.make_optimizer(LR, grad_clip_norm=1.0)
    params = jax.tree.map(jnp.asarray, step_run["params"])
    grads = jax.tree.map(jnp.asarray, _to_flax(step_run["grads"]))
    want = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(grads, params)
    got = _to_flax(dict(step_run["model"].named_parameters()))
    assert _max_diff(got, want) <= 1e-6
    assert _max_diff(got, params) > 1e-4  # the step moved them
    assert step_run["state"].step == 1 and step_run["state"].tx.count == 1


def test_to_flax_inverts_from_flax(fct_params):
    sd = convert.from_flax({"params": fct_params})
    back = convert.from_flax({"params": _to_flax(sd)})
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_step_carries_no_batch_stats_and_draws_dropout_from_the_state(fct_params):
    batch = tuple(torch.from_numpy(t) for t in next(iter(SyntheticImageMasks(2, SIZE, 1, seed=4))))
    losses = []
    for seed in (7, 7, 8):
        model = _port_model(fct_params, dropout=True)
        assert not list(model.buffers())
        state = tstate.create_train_state(model, tstate.make_optimizer(LR), rng=0)
        state.dropout_generator.manual_seed(seed)
        losses.append(float(tsteps.make_segmentation_train_step(SIZE)(state, batch)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_eval_step_matches_the_jax_loss(step_run, fct_params):
    image_u8, mask_u8 = next(iter(SyntheticImageMasks(2, SIZE, 1, seed=3)))
    state = tstate.create_train_state(_port_model(fct_params), tstate.make_optimizer(LR), rng=0)
    m = tsteps.make_segmentation_eval_step(SIZE)(state, (torch.from_numpy(image_u8),
                                                         torch.from_numpy(mask_u8)))
    np.testing.assert_allclose(float(m["loss"]), step_run["jax_loss"], rtol=1e-5)


def test_unported_step_options_raise_naming_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        tsteps.make_segmentation_train_step(SIZE, fsdp_axis="data")


def test_from_flax_state_carries_a_jax_fct_train_state(step_run, fct_params):
    jmodel = jfct.FCT(config=jcfg.FCTConfig(filters=FILTERS, attn_impl="xla"))
    tx = jstate.make_optimizer(LR, grad_clip_norm=1.0)
    js = jstate.TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, fct_params),
                                  tx=tx, rng=jax.random.PRNGKey(0))
    js = jax.jit(lambda s, g: s.apply_gradients(grads=g))(js, step_run["jax_grads"])
    payload = convert.from_flax_state(js)
    assert payload["opt_state"]["count"] == 1 and payload["train_step"] == 1
    state = tstate.create_train_state(_port_model(fct_params), tstate.make_optimizer(LR, grad_clip_norm=1.0))
    ckpt.load_payload(state, payload)
    assert _max_diff(_to_flax(dict(state.model.named_parameters())), js.params) == 0
    named = dict(state.model.named_parameters())
    mu = _to_flax({n: state.tx.core.state[p]["exp_avg"] for n, p in named.items()})
    adam = [s for s in jax.tree.leaves(js.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")][0]
    assert _max_diff(mu, adam.mu) == 0


# ---------------------------------------------------------------- flow


def _train_cfg(cls, tmp_path):
    """``cls`` (JAX's or the port's TrainConfig) writing under tmp_path."""
    return cls(model_name="seg", loss="dice", lr=LR, checkpoint_dir=str(tmp_path / "ck"),
               sample_dir=str(tmp_path / "samples"), log_dir=str(tmp_path / "logs"))


def _flow(tmp_path, params, dropout: bool = True) -> SegmentationFlow:
    return SegmentationFlow(_port_model(params, dropout=dropout), cfg=_train_cfg(tcfg.TrainConfig, tmp_path),
                            image_size=SIZE)


def _printed(fn) -> list:
    """(epoch, mean IoU) of each ``Epoch N: ...`` line ``fn`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return [(int(e), float(iou)) for e, iou in
            re.findall(r"Epoch (\d+): dice loss [0-9.]+ IoU ([0-9.]+)", out.getvalue())]


def _printed_epochs(fn) -> list:
    return [e for e, _ in _printed(fn)]


def test_flow_restore_resumes_epoch_numbering_and_history(tmp_path, fct_params):
    """JAX's contract (``tests/test_flows.py``): restore() + train()
    continues the epoch numbering, the best-loss checkpoint and the loss
    history; the optimizer moments come back bit for bit."""
    data = list(SyntheticImageMasks(2, SIZE, 2, seed=5))
    flow = _flow(tmp_path, fct_params)
    assert _printed_epochs(lambda: flow.train(data, epochs=2)) == [1, 2]
    assert len(flow.loss_history) == 2 and all(np.isfinite(flow.loss_history))
    assert len(list((tmp_path / "samples" / "seg").glob("*_predicted.jpg"))) == 2
    path = ckpt.latest_step_dir(str(tmp_path / "ck"))
    tag = int(os.path.basename(path)[5:])
    assert tag == 1 + int(flow.loss_history[1] < flow.loss_history[0])

    resumed = _flow(tmp_path, fct_params)
    resumed.restore(path)
    assert resumed.start_epoch == tag and resumed.loss_history == flow.loss_history[:tag]
    if tag == 2:
        live = {n: st for n, st in flow.state.tx.core.state.items()}
        for (p, st), (_, st2) in zip(live.items(), resumed.state.tx.core.state.items()):
            assert all(torch.equal(st[k], st2[k]) for k in st)
    assert _printed_epochs(lambda: resumed.train(data, epochs=3)) == list(range(tag + 1, 4))
    assert len(resumed.loss_history) == 3


def test_flow_evaluate_and_infer_with_sobel_dumps(tmp_path, fct_params):
    flow = _flow(tmp_path, fct_params)
    flow.init_state()
    m = flow.evaluate(SyntheticImageMasks(2, SIZE, 2, seed=6))
    assert set(m) == {"loss", "iou"} and all(np.isfinite(list(m.values())))
    batch = np.random.default_rng(0).integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    masks = flow.infer(batch, out_dir=str(tmp_path / "inferred"))
    assert masks.shape == (2, SIZE, SIZE, 1) and masks.min() >= 0 and masks.max() <= 1
    assert len(list((tmp_path / "inferred").glob("image_*.jpg"))) == 2


class _JaxFCT:
    """JAX's FCT of ``config`` whose ``init`` returns the given weights (an
    eager flax init of ``FCT()`` takes tens of seconds on the CPU) and
    whose ``apply`` always runs deterministic, every dropout off (JAX's
    Wide-Focus rate has no switch). ``apply`` is jitted once, for the
    flow's eager sneak peeks, and inlines into its jitted steps."""

    def __init__(self, params, config):
        self.params = params
        module = jfct.FCT(config=config)
        self._apply = jax.jit(lambda variables, x: module.apply(variables, x, deterministic=True))

    def init(self, rng, x):
        del rng, x
        return {"params": jax.tree.map(jnp.asarray, self.params)}

    def apply(self, variables, x, **kw):
        del kw  # a train step's deterministic=False and dropout rngs
        return self._apply(variables, x)


@pytest.fixture(scope="module")
def flow_runs(tmp_path_factory, fct_params):
    """JAX's and the port's SegmentationFlow, every dropout off, on the
    same weights and batches: 2 epochs, restore of the best checkpoint,
    training to epoch 3. JAX's restores into the same flow, whose step is
    then compiled once; the port's into a fresh one."""
    data = list(SyntheticImageMasks(2, SIZE, 2, seed=5))
    base = tmp_path_factory.mktemp("seg_flows")
    out = {}
    jmodel = _JaxFCT(fct_params, jcfg.FCTConfig(filters=FILTERS, attn_impl="xla", dropout_rate=0.0))
    jflow = jloops.SegmentationFlow(jmodel,
                                    cfg=_train_cfg(jcfg.TrainConfig, base / "jax"), image_size=SIZE)
    tflow = _flow(base / "torch", fct_params, dropout=False)
    for name, flow, latest in (("jax", jflow, jckpt.latest_step_dir), ("torch", tflow, ckpt.latest_step_dir)):
        first = _printed(lambda: flow.train(data, epochs=2))
        history = list(flow.loss_history)
        d = str(base / name / "ck")
        tags = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        if name == "torch":
            flow = _flow(base / name, fct_params, dropout=False)
        flow.restore(latest(d))
        restored = (flow.start_epoch, list(flow.loss_history))
        second = _printed(lambda: flow.train(data, epochs=3))
        out[name] = {"first": first, "history": history, "tags": tags, "restored": restored,
                     "second": second, "resumed_history": list(flow.loss_history)}
    return out


def test_flow_trains_as_jax_trains(flow_runs):
    jax_run, port = flow_runs["jax"], flow_runs["torch"]
    assert [e for e, _ in port["first"]] == [e for e, _ in jax_run["first"]] == [1, 2]
    np.testing.assert_allclose(port["history"], jax_run["history"], rtol=1e-5)
    np.testing.assert_allclose([i for _, i in port["first"]], [i for _, i in jax_run["first"]], rtol=0, atol=1e-2)
    assert port["tags"] == jax_run["tags"]


def test_flow_restore_and_resume_match_jax(flow_runs):
    jax_run, port = flow_runs["jax"], flow_runs["torch"]
    assert port["restored"][0] == jax_run["restored"][0]
    np.testing.assert_allclose(port["restored"][1], jax_run["restored"][1], rtol=1e-5)
    assert [e for e, _ in port["second"]] == [e for e, _ in jax_run["second"]]
    assert [e for e, _ in port["second"]] == list(range(jax_run["restored"][0] + 1, 4))
    np.testing.assert_allclose(port["resumed_history"], jax_run["resumed_history"], rtol=1e-5)
    assert len(port["resumed_history"]) == 3
    np.testing.assert_allclose([i for _, i in port["second"]], [i for _, i in jax_run["second"]],
                               rtol=0, atol=1e-2)


def test_flow_refuses_meshes_naming_item_11(fct_params):
    with pytest.raises(NotImplementedError, match="item 11"):
        SegmentationFlow(_port_model(fct_params), sp_axis="spatial")


# ---------------------------------------------------------------- CLI


CPU = ["--device", "cpu", "--image-size", str(SIZE), "--batch-size", "2"]


def _run(argv, main=cli.main) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _count(tree) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


def test_segment_eval_and_summary_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = _run(["segment", "--synthetic", "1", "--epochs", "1", *CPU])
    assert re.fullmatch(r"Epoch 1: dice loss [0-9.]+ IoU [0-9.]+\n", text), text
    assert os.path.isdir("checkpoints/step_1") and os.path.isfile("checkpoints/run.json")
    assert list((tmp_path / "runs" / "FCT").glob("events.out.tfevents.*"))
    text = _run(["eval", "--model", "fct", "--synthetic", "1", *CPU])
    assert re.fullmatch(r"eval fct: dice loss [0-9.]+, IoU [0-9.]+  \[ckpt .*step_1\]\n", text), text
    text = _run(["summary", "--model", "fct", "--image-size", str(SIZE), "--depth", "1"])
    shapes = jax.eval_shape(jfct.FCT().init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    for name in ("block_1", "block_5", "block_9", "ds"):
        row = re.search(rf"^{name}\s+\w+\s+([0-9,]+)$", text, re.M)
        assert int(row.group(1).replace(",", "")) == _count(shapes[name]), name
    total = int(re.search(r"FCT: \S+ parameters \(([0-9,]+)\)", text).group(1).replace(",", ""))
    assert total == _count(shapes)
    assert f"Input: (1, {SIZE}, {SIZE}, 3) float32" in text


def _eval_printed(text: str) -> tuple:
    m = re.search(r"eval fct: dice loss ([0-9.]+), IoU ([0-9.]+)", text)
    return float(m.group(1)), float(m.group(2))


def test_eval_of_a_converted_jax_checkpoint_prints_jax_loss_and_iou(tmp_path, monkeypatch):
    """JAX's ``eval --model fct`` on a checkpoint of ``FCT()`` with seeded
    weights, and the port's on that checkpoint carried by
    ``convert.from_flax_state``. JAX's eval builds its ``FCT()`` with zero
    weights, which the checkpoint's replace."""
    monkeypatch.chdir(tmp_path)
    jmodel = jfct.FCT()
    params = _flax_params(jmodel, jnp.zeros((1, SIZE, SIZE, 3)), seed=21)
    zeros = jax.tree.map(np.zeros_like, params)
    monkeypatch.setattr(jloops, "FCT", lambda: _JaxFCT(zeros, jcfg.FCTConfig()))
    js = jstate.TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
                                  tx=jstate.make_optimizer(LR, grad_clip_norm=1.0), rng=jax.random.PRNGKey(0))
    jpath = jckpt.save_state(str(tmp_path / "jax"), 1, js.params, js.opt_state)
    argv = ["eval", "--model", "fct", "--synthetic", "2", "--image-size", str(SIZE), "--batch-size", "2"]
    want = _eval_printed(_run([*argv, "--checkpoint", jpath], jcli.main))
    flow = SegmentationFlow(tfct.FCT(device="cpu"), cfg=tcfg.TrainConfig(model_name="FCT"), image_size=SIZE)
    flow.init_state()
    ckpt.load_payload(flow.state, convert.from_flax_state(jckpt.restore_state(jpath)))
    tpath = ckpt.save_state(str(tmp_path / "torch"), 1, flow.state)
    got = _eval_printed(_run([*argv, "--device", "cpu", "--checkpoint", tpath]))
    assert abs(got[0] - want[0]) <= 1e-4 and abs(got[1] - want[1]) <= 1e-3, (got, want)


def test_segment_without_a_card_exits_1(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-m", "tchvp_tpu_torch.cli", "segment", "--synthetic", "1"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr, proc.stderr


def test_segment_modules_import_no_jax():
    code = ("import sys; import tchvp_tpu_torch.models.fct, tchvp_tpu_torch.ops.conv_attention, "
            "tchvp_tpu_torch.ops.sobel, tchvp_tpu_torch.ops.basic, tchvp_tpu_torch.train.loops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'tchvp_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
