"""The port's training path against the JAX package.

* Optimizers, schedules, clipping, frozen subtrees, non-finite skipping and
  the parameter EMA: the port's ``make_optimizer`` against the JAX
  package's (optax) from the same parameters and the same gradients, made
  with numpy from a seed. fp32, atol 1e-6 after three updates.
* One ``make_video_train_step`` against JAX's at 32^2 (the
  ``test_torch_video.py`` model: D 64, 8 heads, FFN 32), ``loss="mse"``,
  ``noise_std=0``, every dropout rate 0, attention ``"flash"`` (the JAX
  Pallas kernels in interpret mode, the port's plain versions), SGD with
  lr 1, whose update -1.9 g gives the JAX step's gradients back. Loss and
  psnr atol 1e-6, BatchNorm stats atol 1e-5. Gradients (and the updated
  parameters, 1.9 x) atol 2e-2 x the largest gradient: with train-mode
  BatchNorm every fp32 rounding moves a few pre-ReLU values across zero,
  and the gradient of the first encoder blocks moves with them. Against a
  float64 run of the port, the port's fp32 gradients lie up to 0.38 % of
  the largest gradient away and JAX's up to 0.84 %, both in
  ``encoder.stem_conv``; the decoder's and the transformer's agree with
  JAX to ~1e-4 absolute. Without and with ``accum_steps=2``.
* Port only: with dropout on and a fixed generator, the remat policies
  ``full``, ``stages`` and ``dots`` give the gradients and stats of
  ``none`` (atol 1e-6: the recompute runs the same ops on the same
  inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from tchvp_tpu import config as jcfg
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 32


# ---------------------------------------------------------------- optimizer


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = nn.Linear(3, 4)
        self.decoder = nn.Linear(4, 2)


def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {m: {"weight": rng.standard_normal(s, dtype=np.float32),
                "bias": rng.standard_normal(s[0], dtype=np.float32)}
            for m, s in (("encoder", (4, 3)), ("decoder", (2, 4)))}


def _run_both(kwargs, grads_per_step):
    """The port's and optax's parameters after one update per entry of
    ``grads_per_step`` (trees like ``_toy_params``)."""
    params = _toy_params()
    model = _Toy()
    with torch.no_grad():
        for name, p in model.named_parameters():
            m, leaf = name.split(".")
            p.copy_(torch.from_numpy(params[m][leaf]))
    opt = tstate.make_optimizer(**kwargs).init(model)
    tx = jstate.make_optimizer(**kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    applied = []
    for grads in grads_per_step:
        for name, p in model.named_parameters():
            m, leaf = name.split(".")
            p.grad = torch.from_numpy(grads[m][leaf].copy())
        applied.append(opt.step())
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
    got = {name: p.detach().numpy() for name, p in model.named_parameters()}
    want = {f"{m}.{leaf}": np.asarray(jp[m][leaf]) for m in jp for leaf in jp[m]}
    return got, want, opt, opt_state, applied


def _grads(n, seed=1, scale=1.0):
    return [jax.tree.map(lambda a: a * scale, _toy_params(seed + i)) for i in range(n)]


def _assert_same(got, want, atol=3e-6):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd", "lion"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_updates_match_optax(optimizer, clip):
    got, want, *_ = _run_both(dict(lr=0.05, weight_decay=0.1, optimizer=optimizer,
                                   grad_clip_norm=clip), _grads(3))
    _assert_same(got, want)


def test_schedule_and_ema_match_optax():
    kwargs = dict(lr=0.1, schedule="cosine", warmup_steps=2, total_steps=5, min_lr_ratio=0.1,
                  ema_decay=0.9)
    got, want, opt, opt_state, _ = _run_both(kwargs, _grads(4))
    _assert_same(got, want)
    want_ema = jstate.ema_params(opt_state)
    got_ema = opt.ema
    for name, val in got_ema.items():
        m, leaf = name.split(".")
        np.testing.assert_allclose(val.numpy(), np.asarray(want_ema[m][leaf]), atol=3e-6, rtol=0)


def test_frozen_prefixes_match_optax():
    got, want, *_ = _run_both(dict(lr=0.05, frozen_prefixes=("encoder",), grad_clip_norm=0.5),
                              _grads(2))
    _assert_same(got, want)
    np.testing.assert_array_equal(got["encoder.weight"], _toy_params()["encoder"]["weight"])


def test_nonfinite_updates_are_skipped_like_optax():
    grads = _grads(4)
    grads[1]["decoder"]["bias"][0] = np.nan
    grads[2]["encoder"]["weight"][1, 1] = np.inf
    got, want, opt, _, applied = _run_both(
        dict(lr=0.05, skip_nonfinite_updates=2, schedule="constant", warmup_steps=3), grads)
    _assert_same(got, want)
    assert applied == [True, False, False, True] and opt.count == 2


@pytest.mark.parametrize("kwargs", [
    dict(lr=0.3),
    dict(lr=0.3, warmup_steps=4),
    dict(lr=0.3, schedule="cosine", total_steps=10),
    dict(lr=0.3, schedule="cosine", warmup_steps=3, total_steps=10, min_lr_ratio=0.2),
])
def test_lr_schedule_matches_optax(kwargs):
    got = tstate.make_lr_schedule(**kwargs)
    want = jstate.make_lr_schedule(**kwargs)
    for step in range(13):
        np.testing.assert_allclose(tstate.lr_at(got, step), jstate.lr_at(want, step), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clipping_is_optax_global_norm(scale):
    got, want, *_ = _run_both(dict(lr=1.0, optimizer="sgd", grad_clip_norm=1.0), _grads(1, scale=scale))
    _assert_same(got, want)


def test_unknown_optimizer_and_bad_ema_raise():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.make_optimizer(0.1, optimizer="adagrad")
    with pytest.raises(ValueError, match="ema decay"):
        tstate.make_optimizer(0.1, ema_decay=1.5)


def test_param_count_matches_jax():
    params = _toy_params()
    assert tstate.param_count(_Toy()) == jstate.param_count(params) == 26
    assert tstate.human_param_count(1234567) == jstate.human_param_count(1234567) == "1.23M"


# -------------------------------------------------------------- train step


def _configs(dropout):
    def cut(c):
        return dataclasses.replace(
            c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.3 if dropout else 0.0),
            temporal=dataclasses.replace(c.temporal, dropout_rate=0.1 if dropout else 0.0))

    kw = dict(image_size=SIZE, num_heads=8, hidden_dim=32, attn_impl="flash")
    return cut(jcfg.flagship_video_config(**kw)), cut(tcfg.flagship_video_config(**kw))


def _batch(seed=6, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 2, 48, 48, 3), dtype=np.uint8)


def _jax_variables(jc):
    """The JAX model and seeded numpy variables of its shapes: kernels
    normal / sqrt(fan-in), BN and LayerNorm scales near 1, biases and
    running means near 0, running variances in [0.5, 1.5]. Only the shapes
    come from flax (``eval_shape``: an eager ``init`` takes ~30 s here)."""
    model = jvideo.VideoHybridNet(config=jc)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1 if name == "bias" else 0.2, x.shape)

    variables = {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
                 for c in ("params", "batch_stats")}
    return model, variables


def _port_state(tc, variables, optimizer="sgd", lr=1.0, **kw):
    model = tvideo.VideoHybridNet(tc, device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return tstate.create_train_state(model, tstate.make_optimizer(lr, optimizer=optimizer, **kw), rng=3)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's updated variables and metrics after one step, for accum_steps
    1 and 2, from the same variables and batch."""
    jc, tc = _configs(dropout=False)
    model, variables = _jax_variables(jc)
    out = {}
    for accum in (1, 2):
        st = jstate.TrainState.create(
            apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
            tx=jstate.make_optimizer(1.0, optimizer="sgd"),
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
        step = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, accum_steps=accum)
        new, metrics = step(st, jnp.asarray(_batch()))
        out[accum] = ({"params": jax.tree.map(np.asarray, new.params),
                       "batch_stats": jax.tree.map(np.asarray, new.batch_stats)},
                      {k: float(v) for k, v in metrics.items()})
    return tc, variables, out


@pytest.mark.parametrize("accum", [1, 2])
def test_video_train_step_matches_jax(jax_steps, accum):
    tc, variables, out = jax_steps
    want_vars, want_metrics = out[accum]
    state = _port_state(tc, variables)
    step = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, accum_steps=accum)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, torch.from_numpy(_batch()))
    assert {"flash_mha_plain", "flash_mha_bwd_plain"} <= seen and "sdpa_xla" not in seen
    assert state.step == 1 and set(metrics) == {"loss", "psnr"}
    for k in ("loss", "psnr"):
        assert metrics[k].shape == () and metrics[k].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k], atol=1e-6, rtol=1e-6, err_msg=k)
    before = convert.from_flax(variables)
    want = convert.from_flax(want_vars)
    named = dict(state.model.named_parameters())
    # SGD (lr 1, Nesterov 0.9): p1 = p0 - 1.9 g
    g_jax = {k: (before[k].numpy() - want[k].numpy()) / 1.9 for k in named}
    grad_atol = 2e-2 * max(np.abs(g).max() for g in g_jax.values())
    for key, val in state.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in named:
            np.testing.assert_allclose(named[key].grad.numpy(), g_jax[key], atol=grad_atol, rtol=0,
                                       err_msg=f"grad {key}")
            np.testing.assert_allclose(val.numpy(), want[key].numpy(), atol=1.9 * grad_atol, rtol=0,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(val.numpy(), want[key].numpy(), atol=1e-5, rtol=0, err_msg=key)


def test_video_eval_step_matches_jax(jax_steps):
    tc, variables, _ = jax_steps
    jc, _ = _configs(dropout=False)
    model, _ = _jax_variables(jc)
    jst = jstate.TrainState.create(apply_fn=model.apply, params=variables["params"],
                                   tx=optax.sgd(0.1), batch_stats=variables["batch_stats"])
    want = float(jsteps.make_video_eval_step(SIZE)(jst, jnp.asarray(_batch(7)))["psnr"])
    got = tsteps.make_video_eval_step(SIZE)(_port_state(tc, variables), torch.from_numpy(_batch(7)))
    np.testing.assert_allclose(float(got["psnr"]), want, atol=1e-4, rtol=0)


def _grads_and_stats(state):
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    stats = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
    return grads, stats


@pytest.fixture(scope="module")
def dropout_reference():
    _, tc = _configs(dropout=True)
    jc, _ = _configs(dropout=True)
    _, variables = _jax_variables(jc)
    state = _port_state(tc, variables)
    _, metrics = tsteps.make_video_train_step(SIZE, loss="mse")(state, torch.from_numpy(_batch()))
    return tc, variables, _grads_and_stats(state), float(metrics["loss"])


@pytest.mark.parametrize("policy", ["full", "stages", "dots"])
def test_remat_policies_give_the_gradients_of_none(dropout_reference, policy):
    tc, variables, (grads, stats), loss = dropout_reference
    state = _port_state(tc, variables)
    fwd0 = tfa.launches
    _, metrics = tsteps.make_video_train_step(SIZE, loss="mse", remat_policy=policy)(
        state, torch.from_numpy(_batch()))
    assert tfa.launches == fwd0  # CPU tensors run the plain versions
    assert float(metrics["loss"]) == loss
    got_grads, got_stats = _grads_and_stats(state)
    for name in grads:
        torch.testing.assert_close(got_grads[name], grads[name], atol=1e-6, rtol=0, msg=name)
    for name in stats:
        torch.testing.assert_close(got_stats[name], stats[name], atol=1e-6, rtol=0, msg=name)


def test_dropout_draws_come_from_the_state_generator(dropout_reference):
    tc, variables, (grads, _), loss = dropout_reference
    same = _port_state(tc, variables)
    _, m_same = tsteps.make_video_train_step(SIZE, loss="mse")(same, torch.from_numpy(_batch()))
    other = _port_state(tc, variables)
    other.dropout_generator.manual_seed(12345)
    _, m_other = tsteps.make_video_train_step(SIZE, loss="mse")(other, torch.from_numpy(_batch()))
    assert float(m_same["loss"]) == loss and float(m_other["loss"]) != loss


def test_remat_true_means_full_and_bad_policies_raise():
    with pytest.raises(ValueError, match="remat_policy"):
        tsteps.make_video_train_step(SIZE, remat_policy="everything")
    with pytest.raises(ValueError, match="accum_steps"):
        tsteps.make_video_train_step(SIZE, accum_steps=0)


@pytest.mark.parametrize("kwargs,item", [
    (dict(qat=True), None),
    (dict(fsdp_axis="data"), "item 11"),
    (dict(moe_aux_weight=0.01), "item 11"),
])
def test_unported_options_raise_naming_their_roadmap_item(kwargs, item):
    if item is None:  # ported (item 10, train/qat.py): the steps are made
        assert callable(tsteps.make_video_train_step(SIZE, **kwargs))
        assert callable(tsteps.make_video_eval_step(SIZE, **kwargs))
        return
    with pytest.raises(NotImplementedError, match=item):
        tsteps.make_video_train_step(SIZE, **kwargs)


def test_gaussian_noise_draws_from_the_generator():
    x = torch.zeros(2, 3, 4, 5)
    a = tpipe.gaussian_noise(torch.Generator().manual_seed(0), x, 0.05)
    b = tpipe.gaussian_noise(torch.Generator().manual_seed(0), x, 0.05)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.03 < float(a.std()) < 0.07
    np.testing.assert_array_equal(
        np.asarray(jpipe.gaussian_noise(jax.random.PRNGKey(0), jnp.zeros(3), 0.0)),
        tpipe.gaussian_noise(torch.Generator(), torch.zeros(3), 0.0).numpy())
