"""The port's ``VideoFlow`` against the JAX package's.

* Checkpoint schedules: for each (epochs, save_every, save_every_steps,
  keep_checkpoints, async) case both flows train on the same synthetic
  clips or clippack and must leave the same ``step_*`` tags, the same
  ``TAG_SCHEME``, the same ``extra`` (train_epoch, data_position) in every
  checkpoint, and, resumed from the newest (after dropping the clean-
  shutdown save where a case simulates a preemption), the same start epoch
  and the same seek position.
* Carried state: a JAX state saved by JAX's ``save_state`` after two AdamW
  steps with an EMA, carried over by ``convert.from_flax_state``: the
  port's eval PSNR equals JAX's within 1e-4; one AdamW update from it on
  the same gradients matches optax's (atol 3e-6, the limit of
  ``tests/test_torch_train.py``), EMA and count included; a port save ->
  restore of it is bit-equal.
* Resume: 2 epochs, then a fresh flow resumed for the third, is bit-equal
  to 3 straight epochs (dropout on, AdamW, EMA) on the CPU.

32^2, one temporal layer, input_dim 64, 4 heads (``tests/test_flows.py``);
the JAX flow is built and compiled once for the module.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tchvp_tpu.config import TrainConfig as JTrainConfig
from tchvp_tpu.config import TransformerConfig as JTransformerConfig
from tchvp_tpu.config import VideoModelConfig as JVideoModelConfig
from tchvp_tpu.data import clippack as jclippack
from tchvp_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from tchvp_tpu.models import VideoHybridNet as JVideoHybridNet
from tchvp_tpu.train import checkpoint as jckpt
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train.loops import VideoFlow as JVideoFlow
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.config import TrainConfig, TransformerConfig, VideoModelConfig
from tchvp_tpu_torch.data import clippack
from tchvp_tpu_torch.data.synthetic import SyntheticClips
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train.loops import VideoFlow
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, CLIP = 32, 4
CFG = dict(model_name="VID", loss="mse", lr=1e-3, ema_decay=0.9)


def port_flow(tmp, seed=0, **cfg) -> VideoFlow:
    model = VideoHybridNet(VideoModelConfig(temporal=TransformerConfig(
        input_dim=64, hidden_dim=32, num_layers=1, num_heads=4)), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    tc = TrainConfig(checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "runs"), **{**CFG, **cfg})
    return VideoFlow(model, cfg=tc, image_size=SIZE)


@pytest.fixture(scope="module")
def jax_flow(tmp_path_factory):
    """One JAX flow (its step compiled once) and a host copy of its
    step-0 state: a donated state cannot be reused, so each case places a
    fresh copy."""
    tmp = tmp_path_factory.mktemp("jax")
    model = JVideoHybridNet(config=JVideoModelConfig(temporal=JTransformerConfig(
        input_dim=64, hidden_dim=32, num_layers=1, num_heads=4)))
    cfg = JTrainConfig(checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "runs"), **CFG)
    flow = JVideoFlow(model, cfg=cfg, image_size=SIZE)
    # init_state's state, with the init jitted (eager, it takes ~30 s here).
    rng = jax.random.PRNGKey(cfg.seed)
    variables = jax.jit(model.init)(rng, jnp.zeros((1, CLIP, SIZE, SIZE, 3)))
    tx = jstate.make_optimizer(cfg.lr, cfg.weight_decay, grad_clip_norm=1.0, ema_decay=cfg.ema_decay,
                               optimizer=cfg.optimizer)
    state = jstate.TrainState.create(apply_fn=model.apply, params=variables["params"], tx=tx,
                                     batch_stats=variables["batch_stats"], rng=rng)
    state = state.replace(opt_state=jstate._dealias_opt_state(state.params, state.opt_state))
    return flow, jax.tree.map(np.asarray, state)


def fresh(state0):
    return jax.tree.map(lambda x: jnp.array(x), state0)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack") / "clips.cpk")
    clips = np.random.default_rng(0).integers(0, 256, (3, CLIP, SIZE, SIZE, 3), dtype=np.uint8)
    clippack.pack_clips(path, clips)
    return path


def datasets(kind, pack):
    if kind == "synthetic":
        return SyntheticClips(1, CLIP, SIZE, 2), JSyntheticClips(1, CLIP, SIZE, 2)
    # Batch 1, as the synthetic clips: one compiled JAX step serves every case.
    return (clippack.ClipPackDataset(pack, 1, seed=1, prefer_native=False),
            jclippack.ClipPackDataset(pack, batch_size=1, seed=1, prefer_native=False))


def extra_of(raw):
    extra = raw.get("extra") or {}
    out = {"train_epoch": int(extra["train_epoch"])}
    if "data_position" in extra:
        out["data_position"] = {k: int(v) for k, v in extra["data_position"].items()}
    return out


def tags(directory):
    return sorted(d for d in os.listdir(directory) if d.startswith("step_"))


# (epochs, save_every, save_every_steps, keep_checkpoints, async, data, drop the final save)
CASES = [
    (2, 1, 0, 0, False, "synthetic", False),
    (3, 2, 0, 0, True, "synthetic", False),
    (2, 10, 0, 1, False, "synthetic", False),
    (1, 10, 2, 0, False, "clippack", True),
    (2, 10, 2, 2, True, "clippack", True),
    (2, 1, 3, 0, False, "clippack", False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_checkpoint_schedule_matches_jax(jax_flow, pack, tmp_path, case):
    epochs, save_every, steps, keep, async_write, kind, drop = case
    jflow, state0 = jax_flow
    dirs = {k: tmp_path / k / "ckpt" for k in ("jax", "torch")}
    cfg = dict(keep_checkpoints=keep, async_checkpoint=async_write)
    jflow.cfg = dataclasses.replace(jflow.cfg, checkpoint_dir=str(dirs["jax"]), **cfg)
    jflow.state = fresh(state0)
    tflow = port_flow(tmp_path / "torch", **cfg)
    tdata, jdata = datasets(kind, pack)
    kw = dict(epochs=epochs, clip_len=CLIP, save_every=save_every, save_every_steps=steps)
    jflow.train(jdata, **kw)
    tflow.train(tdata, **kw)
    assert tags(dirs["torch"]) == tags(dirs["jax"]) and tags(dirs["jax"])
    assert (dirs["torch"] / "TAG_SCHEME").read_text() == (dirs["jax"] / "TAG_SCHEME").read_text()
    for tag in tags(dirs["jax"]):
        assert extra_of(ckpt.restore_state(str(dirs["torch"] / tag))) == \
            extra_of(jckpt.restore_state(str(dirs["jax"] / tag))), tag
    if drop:  # a preemption: the clean-shutdown save never happened
        for d in dirs.values():
            shutil.rmtree(d / tags(d)[-1])
    tdata, jdata = datasets(kind, pack)
    jflow.state = fresh(state0)
    tflow = port_flow(tmp_path / "torch", **cfg)
    assert tflow.resume(CLIP, data=tdata) == jflow.resume(CLIP, data=jdata)
    if kind == "clippack":
        assert tdata.position() == {k: int(v) for k, v in jdata.position().items()}


# ----------------------------------------------------------- carried state


@pytest.fixture(scope="module")
def carried(jax_flow, tmp_path_factory):
    """JAX's flow after 2 AdamW steps with an EMA, saved by JAX's
    save_state, and a port flow holding it through from_flax_state."""
    jflow, state0 = jax_flow
    tmp = tmp_path_factory.mktemp("carried")
    jflow.cfg = dataclasses.replace(jflow.cfg, checkpoint_dir=str(tmp / "jax"), keep_checkpoints=0,
                                    async_checkpoint=False)
    jflow.state = fresh(state0)
    jflow.train(JSyntheticClips(1, CLIP, SIZE, 2), epochs=1, clip_len=CLIP, save_every=1)
    raw = jckpt.restore_state(str(tmp / "jax" / "step_1"))
    payload = convert.from_flax_state(raw)
    tflow = port_flow(tmp)
    tflow.init_state(CLIP)
    ckpt.load_payload(tflow.state, payload)
    return jflow, tflow, raw, tmp


def test_carried_state_is_the_saved_one(carried):
    _, tflow, raw, _ = carried
    tx = tflow.state.tx
    assert tx.count == 2 and tx.notfinite_count == 0 and tflow.state.step == 1  # step = the tag
    mu = convert.from_flax({"params": convert._find(raw["opt_state"], lambda f: f == {
        "count", "mu", "nu"})["mu"]})
    for name, p in tx.named.items():
        st = tx.core.state[p]
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(p.detach().numpy(), convert.from_flax(
            {"params": raw["params"]})[name].numpy(), err_msg=name)


def test_carried_state_eval_psnr_matches_jax(carried):
    jflow, tflow, _, _ = carried
    data = JSyntheticClips(1, CLIP, SIZE, 2, seed=5)
    want = jflow.evaluate(data)
    got = tflow.evaluate(SyntheticClips(1, CLIP, SIZE, 2, seed=5))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_carried_state_adamw_update_matches_optax(carried):
    jflow, tflow, _, _ = carried
    st = jflow.state
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), st.params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = st.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    new_params, opt = update(grads, st.opt_state, st.params)
    want = convert.from_flax({"params": new_params})
    tg = convert.from_flax({"params": grads})
    for name, p in tflow.state.tx.named.items():
        p.grad = tg[name].clone()
    assert tflow.state.tx.step()
    for name, p in tflow.state.tx.named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=3e-6, rtol=0,
                                   err_msg=name)
    want_ema = convert.from_flax({"params": convert._find(opt, lambda f: f == {"ema"})["ema"]})
    for name, e in tflow.state.tx.ema.items():
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(), atol=3e-6, rtol=0, err_msg=name)
    assert tflow.state.tx.count == 3


def test_carried_state_port_round_trip(carried, tmp_path):
    _, tflow, _, _ = carried
    path = ckpt.save_state(str(tmp_path), 1, tflow.state)
    other = port_flow(tmp_path, seed=4)
    other.init_state(CLIP)
    ckpt.restore_state_into(other.state, path)
    a, b = other.state, tflow.state
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    for n in a.tx.named:
        sa, sb = a.tx.core.state[a.tx.named[n]], b.tx.core.state[b.tx.named[n]]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), n
        assert torch.equal(a.tx.ema[n], b.tx.ema[n]), n
    assert (a.tx.count, a.step) == (b.tx.count, b.step)
    assert torch.equal(a.noise_generator.get_state(), b.noise_generator.get_state())
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())


# ------------------------------------------------------------------ resume


def test_two_epochs_and_resume_equal_three_straight(tmp_path):
    data = SyntheticClips(1, CLIP, SIZE, 2)
    straight = port_flow(tmp_path / "a")
    straight.train(data, epochs=3, clip_len=CLIP, save_every=10)
    first = port_flow(tmp_path / "b")
    first.train(data, epochs=2, clip_len=CLIP, save_every=1)
    resumed = port_flow(tmp_path / "b", seed=9)  # other weights until the restore
    start = resumed.resume(CLIP, data=data)
    assert start == 2
    resumed.train(data, epochs=3, clip_len=CLIP, start_epoch=start, save_every=10)
    a, b = straight.state, resumed.state
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    for n in a.tx.named:
        assert torch.equal(a.tx.ema[n], b.tx.ema[n]), n
        sa, sb = a.tx.core.state[a.tx.named[n]], b.tx.core.state[b.tx.named[n]]
        assert all(torch.equal(sa[k], sb[k]) for k in sa), n
    assert (a.step, a.tx.count) == (b.step, b.tx.count) == (6, 6)
