"""The port's routed MoE FFN (``tchvp_tpu_torch/ops/moe.py``) against the JAX
package's ``ops/moe.py``, one process, CPU, fp32.

* ``expert_capacity`` over a table of cases: equal.
* ``_route``'s dispatch and combine (exact), aux and dropped fraction
  (atol 1e-6) for top-1 and top-2, with and without capacity overflow; a
  dropped token's FFN output is exactly zero; a second choice queues
  behind every first choice (top-1's dispatch is inside top-2's).
* ``MoEFFN``'s forward (atol 1e-5) and the gradients of sum(out**2) + aux
  for x and every parameter (atol 1e-5 x the largest gradient), the
  weights carried by ``convert.from_flax``.
* ``TransformerEncoder(num_experts=4)`` eval forward against JAX's, atol
  2e-5.
* One ``make_video_train_step(moe_aux_weight=0.01)`` of a small MoE
  flagship (32^2, 2 frames, D 64, one layer, FFN 32, 2 experts at capacity
  factor 0.25, so assignments drop; dropout off, MSE, SGD lr 1) against
  JAX's: loss, ``moe_aux`` and ``moe_drop_frac`` rtol 1e-5; the router's
  gradient (which the aux loss reaches) within 1e-3 x its largest; the
  temporal block's and the CNN's each within 3e-2 x their own largest.
  Every gradient but the router's moves with train-mode BatchNorm's
  rounding chaos (``tests/test_torch_train.py``): at this data the dense
  step's stem reads 1.9 % of the largest gradient, this one 2.3 %, and
  the attention's projections up to 2.1 % of the temporal block's largest
  (with ``accum_steps=2``, BatchNorm over one clip's two frames); also
  under remat
  ``stages`` (against JAX's step without remat: remat never changes the
  math) and ``accum_steps=2``.
* Five AdamW steps (1e-4, weight decay 0.01, clip 1.0, aux weight 0.01)
  of the flagship with 4 experts (32^2, 4 frames, D 64, 2 layers, dropout
  off, MSE) from the seeded weights above, JAX's states carried by
  ``convert.from_flax_state``. ``forced``: from each of JAX's five states
  (parameters, stats and Adam moments) the port takes one step: loss,
  ``moe_aux`` and ``moe_drop_frac`` rtol 1e-5; the routers' new weights
  within 1e-2 x lr of JAX's and their moments within 1e-2 x the largest
  (measured 9e-4 and 2.4e-3). ``free``: the port's own five steps against
  JAX's: Adam turns train-mode BatchNorm's rounding chaos into whole-lr
  moves of the small gradients, so the two runs part after the first
  step; loss and ``moe_aux`` rtol 2e-2, ``moe_drop_frac`` within 3 of its
  128 assignments (measured 0.7 %, 0.7 % and 2).
* Routing collapse at the router's real width: a one-layer MoE encoder of
  D 4096 (config 1's token width; 4 experts, FFN 64, 8 heads, B 2 of 64
  seeded tokens), five AdamW steps (1e-4, clip 1.0) on
  MSE to a seeded target + 0.01 x aux, no BatchNorm: JAX's aux climbs
  from 1.15 to 3.86 of the one-layer maximum 4 by the third step, and the
  port's follows it, rtol 2e-3 (measured 4e-4), the dropped fraction
  within one of 128 assignments (measured equal).
* The expert kernels' init std against JAX's on (8, 512, 256): fan-in E·d,
  within 2 %.
* ``Int8Engine(quantize_dense=True)`` over a MoE flagship: the MoE
  einsums stay float, so the quantized layer set is JAX's (traced), and
  with both engines at the same scales the MoE layer under the port's
  engine, given JAX's int8-path input, gives JAX's output within 1e-5 x
  max|ref|.
* ``video --num-experts 4 --synthetic 1`` for one step on the CPU, then
  ``infer --num-experts 4`` from its checkpoint; ``infer`` with another
  expert count is refused.
"""

import contextlib
import dataclasses
import io
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.infer import quant as jq
from tchvp_tpu.models import TransformerEncoder as JTransformerEncoder
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.ops import moe as jmoe
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.infer import quant as tq
from tchvp_tpu_torch.models import transformer as ttr
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.ops import moe as tmoe
from tchvp_tpu_torch.train import checkpoint as ckpt
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, FRAMES = 32, 2  # S = 16 tokens of D 64


def _x(b=2, s=16, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _moe_params(d, e, h, seed=1):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d),
            "w1": rng.standard_normal((e, d, h)).astype(np.float32) / np.sqrt(d),
            "b1": rng.normal(0.0, 0.1, (e, h)).astype(np.float32),
            "w2": rng.standard_normal((e, h, d)).astype(np.float32) / np.sqrt(h),
            "b2": rng.normal(0.0, 0.1, (e, d)).astype(np.float32)}


def _port_layer(params, **kw):
    d, e = params["router"].shape
    layer = tmoe.MoEFFN(d, e, params["w1"].shape[2], **kw)
    sd = convert.from_flax({"params": {"temporal": {"moe_0": params}}})
    layer.load_state_dict({k.rsplit(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    return layer


# ------------------------------------------------------------ the routing


@pytest.mark.parametrize("tokens,experts,factor,k", [
    (16, 4, 1.25, 1), (1024, 8, 1.0, 1), (4, 4, 0.1, 1), (128, 8, 1.25, 1), (128, 8, 1.25, 2),
    (128, 4, 1.25, 2), (33, 3, 0.7, 3), (64, 2, 0.01, 1),
])
def test_expert_capacity_matches_jax(tokens, experts, factor, k):
    assert tmoe.expert_capacity(tokens, experts, factor, k) == jmoe.expert_capacity(tokens, experts, factor, k)


@pytest.mark.parametrize("k,factor", [(1, 1.25), (2, 1.25), (1, 0.01), (2, 0.25)])
def test_route_matches_jax(k, factor):
    x = _x(b=2, s=32, d=16, seed=3)
    router = _moe_params(16, 4, 8)["router"]
    cap = jmoe.expert_capacity(32, 4, factor, k)
    want = jmoe._route(jnp.asarray(x), jnp.asarray(router), cap, top_k=k)
    got = tmoe._route(torch.from_numpy(x), torch.from_numpy(router), cap, top_k=k)
    for name, g, w in zip(("dispatch", "combine", "aux", "dropped"), got, want):
        atol = 0 if name == "dispatch" else 1e-6
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0, err_msg=name)
    if factor < 1:
        assert float(got[3]) > 0.0


def test_overflow_gives_zero_output_and_second_choice_queues_behind_first():
    x = torch.from_numpy(_x(b=1, s=64, d=16, seed=17))
    params = _moe_params(16, 2, 8, seed=4)
    layer = _port_layer(params, capacity_factor=0.01)
    cap = tmoe.expert_capacity(64, 2, 0.01)
    d1, _, _, dropped1 = tmoe._route(x, layer.router, cap, top_k=1)
    kept = d1.sum(dim=(2, 3))[0]
    assert cap == 8 and float(kept.sum()) < 64
    assert float(dropped1) == pytest.approx(1.0 - float(kept.sum()) / 64, abs=1e-6)
    with torch.no_grad():
        out = layer(x)
    assert torch.equal(out[0, kept == 0], torch.zeros_like(out[0, kept == 0]))
    assert bool((out[0, kept == 1].abs().sum(-1) > 0).all())
    d2, _, _, dropped2 = tmoe._route(x, layer.router, cap, top_k=2)
    assert torch.equal(d1, torch.clamp(d2, max=1.0) * (d1 > 0))
    assert float(dropped2) > 0.5


# ------------------------------------------------------------ the layer


@pytest.mark.parametrize("k", [1, 2])
def test_moeffn_forward_and_grads_match_jax(k):
    x = _x(b=2, s=16, d=16, seed=5)
    params = _moe_params(16, 4, 24)
    m = jmoe.MoEFFN(num_experts=4, hidden_dim=24, top_k=k, capacity_factor=0.5)

    def objective(p, xx):
        out, mut = m.apply({"params": p}, xx, mutable=["intermediates"])
        return (out ** 2).sum() + jmoe.total_load_balance_loss(mut), out

    (_, want), (g_p, g_x) = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    layer = _port_layer(params, top_k=k, capacity_factor=0.5)
    xt = torch.from_numpy(x).requires_grad_()
    sink = []
    with dispatch_trace.capture() as seen:
        out = layer(xt, sink)
    assert seen == {"moe_dense"} and len(sink) == 1
    ((out ** 2).sum() + tmoe.total_load_balance_loss(sink)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    grads = {"x": (xt.grad, g_x), **{n: (getattr(layer, n).grad, g_p[n]) for n in params}}
    scale = max(float(jnp.abs(g).max()) for _, g in grads.values())
    for name, (g, w) in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 * scale, rtol=0, err_msg=name)


def test_moeffn_errors_and_empty_totals():
    with pytest.raises(ValueError, match=">= 2 experts"):
        tmoe.MoEFFN(8, 1, 4)
    for k in (0, 5):
        with pytest.raises(ValueError, match="top_k must be in"):
            tmoe.MoEFFN(8, 4, 4, top_k=k)
    assert float(tmoe.total_load_balance_loss([])) == 0.0
    assert float(tmoe.mean_dropped_fraction([])) == 0.0


def test_init_std_matches_jax_fan_in_over_experts():
    """JAX's expert kernels: variance_scaling(1, "fan_in", "truncated_normal")
    on (E, d, H), whose fan-in counts E as receptive field: std 1/sqrt(E d)."""
    shape = (8, 512, 256)
    init = fnn.initializers.variance_scaling(1.0, "fan_in", "truncated_normal")
    want = float(jnp.std(init(jax.random.PRNGKey(0), shape)))
    layer = tmoe.MoEFFN(512, 8, 256)
    layer.init_flax(torch.Generator().manual_seed(0))
    got = float(layer.w1.std())
    assert want == pytest.approx(1 / math.sqrt(8 * 512), rel=0.02)
    assert got == pytest.approx(want, rel=0.02)
    assert float(layer.w2.std()) == pytest.approx(1 / math.sqrt(8 * 256), rel=0.02)
    assert float(layer.router.std()) == pytest.approx(1 / math.sqrt(512), rel=0.05)
    assert float(layer.b1.abs().max()) == float(layer.b2.abs().max()) == 0.0


def test_transformer_encoder_with_experts_matches_jax():
    cfg = dict(input_dim=16, hidden_dim=24, num_layers=2, num_heads=4, dropout_rate=0.0,
               num_experts=4, expert_capacity_factor=0.5, router_top_k=2)
    x = _x(b=2, s=16, d=16, seed=2)
    jmodel = JTransformerEncoder(config=jcfg.TransformerConfig(**cfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), deterministic=True))
    model = ttr.TransformerEncoder(tcfg.TransformerConfig(**cfg))
    assert not hasattr(model.layers[0], "ffn1")
    sd = convert.from_flax({"params": {"temporal": variables["params"]}})
    model.load_state_dict({k[len("temporal."):]: v for k, v in sd.items()}, strict=True)
    sink = []
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), moe_sink=sink)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert len(sink) == 2


# ------------------------------------------------------------ the train step


def _configs():
    def cut(c):
        return dataclasses.replace(
            c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
            temporal=dataclasses.replace(c.temporal, dropout_rate=0.0, expert_capacity_factor=0.25,
                                         num_layers=1))

    kw = dict(image_size=SIZE, num_heads=8, hidden_dim=32, attn_impl="xla", num_experts=2)
    return cut(jcfg.flagship_video_config(**kw)), cut(tcfg.flagship_video_config(**kw))


def _batch(seed=6):
    return np.random.default_rng(seed).integers(0, 256, (2, FRAMES, 48, 48, 3), dtype=np.uint8)


def _jax_variables(jc):
    model = jvideo.VideoHybridNet(config=jc)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ("kernel", "router", "w1", "w2"):
            return rng.standard_normal(x.shape) / np.sqrt(x.shape[-2] if name != "kernel"
                                                          else np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1 if name.startswith("b") else 0.2, x.shape)

    return model, {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
                   for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def jax_moe_steps():
    jc, tc = _configs()
    model, variables = _jax_variables(jc)
    out = {}
    for accum in (1, 2):
        st = jstate.TrainState.create(
            apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
            tx=jstate.make_optimizer(1.0, optimizer="sgd"),
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
        step = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, accum_steps=accum,
                                            moe_aux_weight=0.01)
        new, metrics = step(st, jnp.asarray(_batch()))
        out[accum] = (jax.tree.map(np.asarray, new.params), {k: float(v) for k, v in metrics.items()})
    return tc, variables, out


@pytest.mark.parametrize("policy,accum", [("none", 1), ("stages", 1), ("none", 2)])
def test_moe_train_step_matches_jax(jax_moe_steps, policy, accum):
    tc, variables, out = jax_moe_steps
    want_params, want_metrics = out[accum]
    model = tvideo.VideoHybridNet(tc, device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    step = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, accum_steps=accum,
                                        remat_policy=policy, moe_aux_weight=0.01)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, torch.from_numpy(_batch()))
    assert "moe_dense" in seen
    assert set(metrics) == {"loss", "psnr", "moe_aux", "moe_drop_frac"}
    assert want_metrics["moe_drop_frac"] > 0.0
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k], rtol=1e-5, atol=1e-6, err_msg=k)
    before = convert.from_flax(variables)
    want = convert.from_flax({"params": want_params})
    named = dict(model.named_parameters())
    g_jax = {k: (before[k].numpy() - want[k].numpy()) / 1.9 for k in named}
    assert np.abs(g_jax["temporal.layers.0.moe.router"]).max() > 0.0
    # The router, reached by the loss and the aux loss: close (measured
    # 2e-5 by relative L2). The temporal block and the CNN inherit the
    # train-mode BatchNorm backward's rounding chaos (module docstring):
    # each is held against its own largest gradient.
    router = "temporal.layers.0.moe.router"
    np.testing.assert_allclose(named[router].grad.numpy(), g_jax[router],
                               atol=1e-3 * np.abs(g_jax[router]).max(), rtol=0, err_msg="router")
    for part, tol in (("temporal.", 3e-2), ("", 3e-2)):
        keys = [k for k in named if k.startswith(part) and (part or not k.startswith("temporal."))]
        atol = tol * max(np.abs(g_jax[k]).max() for k in keys)
        for key in keys:
            np.testing.assert_allclose(named[key].grad.numpy(), g_jax[key], atol=atol, rtol=0,
                                       err_msg=f"grad {key}")


ADAMW = dict(size=32, frames=4, lr=1e-4, steps=5)


def _adamw(pkg):
    return pkg.make_optimizer(ADAMW["lr"], weight_decay=0.01, grad_clip_norm=1.0)


@pytest.fixture(scope="module")
def jax_adamw_steps():
    """JAX's five AdamW steps of the E=4 flagship from seeded weights: the
    port's payload of each state before a step and after the last, and
    each step's metrics."""
    size, frames = ADAMW["size"], ADAMW["frames"]

    def cut(c):
        return dataclasses.replace(c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
                                   temporal=dataclasses.replace(c.temporal, dropout_rate=0.0))

    kw = dict(image_size=size, num_experts=4, attn_impl="xla")
    jc, tc = cut(jcfg.flagship_video_config(**kw)), cut(tcfg.flagship_video_config(**kw))
    model, variables = _jax_variables(jc)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]), tx=_adamw(jstate),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    step = jsteps.make_video_train_step(size, loss="mse", noise_std=0.0, moe_aux_weight=0.01)
    batches = [np.random.default_rng(10 + i).integers(0, 256, (2, frames, size + 16, size + 16, 3), dtype=np.uint8)
               for i in range(ADAMW["steps"])]
    states, metrics = [], []
    for b in batches:
        states.append(convert.from_flax_state(jax.tree.map(np.array, st)))
        st, m = step(st, jnp.asarray(b))
        metrics.append({k: float(v) for k, v in m.items()})
    states.append(convert.from_flax_state(jax.tree.map(np.array, st)))
    return tc, batches, states, metrics


@pytest.mark.parametrize("mode", ["forced", "free"])
def test_moe_adamw_steps_track_jax(jax_adamw_steps, mode):
    tc, batches, states, want = jax_adamw_steps
    model = tvideo.VideoHybridNet(tc, device="cpu")
    state = tstate.create_train_state(model, _adamw(tstate), rng=3)
    ckpt.load_payload(state, states[0])
    step = tsteps.make_video_train_step(ADAMW["size"], loss="mse", noise_std=0.0, moe_aux_weight=0.01)
    named = dict(model.named_parameters())
    routers = [n for n in named if n.endswith(".moe.router")]
    assert len(routers) == 2
    for k, batch in enumerate(batches):
        if mode == "forced":
            ckpt.load_payload(state, states[k])
        state, m = step(state, torch.from_numpy(batch))
        got = {x: float(m[x]) for x in ("loss", "moe_aux", "moe_drop_frac")}
        if mode == "free":
            np.testing.assert_allclose([got["loss"], got["moe_aux"]], [want[k]["loss"], want[k]["moe_aux"]],
                                       rtol=2e-2, atol=0, err_msg=f"step {k}")
            assert abs(got["moe_drop_frac"] - want[k]["moe_drop_frac"]) <= 3 / 128 + 1e-9, (k, got, want[k])
            continue
        for x, v in got.items():
            np.testing.assert_allclose(v, want[k][x], rtol=1e-5, atol=1e-6, err_msg=f"step {k} {x}")
        after = states[k + 1]
        for n in routers:
            np.testing.assert_allclose(named[n].detach().numpy(), after["model"][n].numpy(),
                                       atol=1e-2 * ADAMW["lr"], rtol=0, err_msg=f"step {k} {n}")
            for moment, ref in after["opt_state"]["moments"][n].items():
                if moment != "step":
                    np.testing.assert_allclose(
                        state.tx.core.state[named[n]][moment].numpy(), ref.numpy(),
                        atol=1e-2 * ref.abs().max().item(), rtol=0, err_msg=f"step {k} {n} {moment}")
    if mode == "free":
        assert state.tx.count == ADAMW["steps"]


def test_moe_routing_collapses_at_config_1_width_as_in_jax():
    d, steps, lr = 4096, 5, 1e-4
    cfg = dict(input_dim=d, hidden_dim=64, num_layers=1, num_heads=8, dropout_rate=0.0, num_experts=4)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 64, d)).astype(np.float32) for _ in range(steps)]
    ys = [rng.standard_normal((2, 64, d)).astype(np.float32) for _ in range(steps)]
    jmodel = JTransformerEncoder(config=jcfg.TransformerConfig(**cfg))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))["params"])
    tx = jstate.make_optimizer(lr, weight_decay=0.01, grad_clip_norm=1.0)

    def objective(p, x, y):
        out, mut = jmodel.apply({"params": p}, x, deterministic=True, mutable=["intermediates"])
        aux = jmoe.total_load_balance_loss(mut)
        return jnp.mean((out - y) ** 2) + 0.01 * aux, (aux, jmoe.mean_dropped_fraction(mut))

    @jax.jit
    def jax_step(p, o, x, y):
        (_, metrics), g = jax.value_and_grad(objective, has_aux=True)(p, x, y)
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), o, metrics

    p = jax.tree.map(jnp.asarray, params)
    o = tx.init(p)
    want = []
    for x, y in zip(xs, ys):
        p, o, metrics = jax_step(p, o, jnp.asarray(x), jnp.asarray(y))
        want.append([float(v) for v in metrics])
    assert max(a for a, _ in want) > 3.5  # JAX's routing collapses toward one expert
    model = ttr.TransformerEncoder(tcfg.TransformerConfig(**cfg))
    sd = convert.from_flax({"params": {"temporal": params}})
    model.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    opt = tstate.create_train_state(model, tstate.make_optimizer(lr, weight_decay=0.01, grad_clip_norm=1.0)).tx
    for k, (x, y) in enumerate(zip(xs, ys)):
        sink = []
        out = model.eval()(torch.from_numpy(x), moe_sink=sink)
        aux = tmoe.total_load_balance_loss(sink)
        model.zero_grad(set_to_none=True)
        (((out - torch.from_numpy(y)) ** 2).mean() + 0.01 * aux).backward()
        opt.step()
        np.testing.assert_allclose(float(aux), want[k][0], rtol=2e-3, err_msg=f"step {k} aux")
        assert abs(float(tmoe.mean_dropped_fraction(sink)) - want[k][1]) <= 1 / 128 + 1e-9, (k, want[k])


# ------------------------------------------------------------ int8 serving


def test_int8_engine_over_moe_matches_jax():
    """The engines quantize the same layers, none of the MoE pool; under the
    engine the MoE layer, given JAX's int8-path input, gives JAX's output
    (it stays float in both). The whole int8 forwards are not compared
    element-wise: at these weights a one-ulp difference at the input of
    ``layer1_block2`` flips one int8 rounding and moves the reconstruction
    by ~2 % of its range in either package (the cascade of
    ``tests/test_torch_quant.py``)."""
    jc, tc = _configs()
    jmodel, variables = _jax_variables(jc)
    clip = np.random.default_rng(3).uniform(size=(1, 2, SIZE, SIZE, 3)).astype(np.float32)
    port = tvideo.VideoHybridNet(tc, device="cpu")
    port.load_state_dict(convert.from_flax(variables), strict=True)
    teng = tq.Int8Engine(port.eval(), quantize_dense=True).calibrate([torch.from_numpy(clip)])
    keys = set()

    def record_key(next_fn, module, x, **kw):
        keys.add(jq._path_key(module))
        return next_fn(x, **kw)

    def traced(v):
        with jq._conv_interceptor(record_key, dense=True):
            return jmodel.apply(v, jnp.asarray(clip))

    jax.eval_shape(traced, variables)  # JAX's quantized layer set, no compile
    mapped = {convert._module_name(tuple(k.split("/")))[0]: k for k in keys}
    assert set(mapped) == set(teng.scales) and not any("moe" in k for k in mapped)
    # JAX's engine at the port's scales: the same int8 weights and steps.
    jeng = jq.Int8Engine(jmodel, jax.tree.map(jnp.asarray, variables), quantize_dense=True)
    jeng.scales = {mapped[name]: s for name, s in teng.scales.items()}
    jeng.qparams = jq.quantize_conv_params(jeng.variables, sorted(jeng.scales))

    @jax.jit
    def int8_forward(qparams, v, x):
        moe = {}

        def record(next_fn, args, kwargs, context):
            out = next_fn(*args, **kwargs)
            if isinstance(context.module, jmoe.MoEFFN) and context.method_name == "__call__":
                moe["x"], moe["out"] = args[0], out
            return out

        with jeng.intercepting(qparams), fnn.intercept_methods(record):
            recon = jmodel.apply(v, x, deterministic=True)[1]
        return recon, moe

    want_recon, seen_j = jax.tree.map(np.array, int8_forward(jeng.qparams, jeng.variables, jnp.asarray(clip)))
    layer = port.temporal.layers[0].moe
    with teng.intercepting(teng.qparams), torch.no_grad(), dispatch_trace.capture() as seen:
        got = layer(torch.from_numpy(seen_j["x"]))
        recon = port(torch.from_numpy(clip))[1]
    assert "moe_dense" in seen
    np.testing.assert_allclose(got.numpy(), seen_j["out"], atol=1e-5 * np.abs(seen_j["out"]).max(), rtol=0)
    assert recon.shape == want_recon.shape and bool(torch.isfinite(recon).all())


# ------------------------------------------------------------ the CLI


def test_video_then_infer_with_experts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    small = ["--image-size", "32", "--layers", "1", "--batch-size", "1", "--clip-len", "4",
             "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["video", "--synthetic", "1", "--epochs", "1", "--num-experts", "4",
                  "--moe-aux-weight", "0.02", "--router-top-k", "2", "--checkpoint-dir", "ck", *small])
    assert "moe_aux" in out.getvalue() and "moe_drop_frac" in out.getvalue()
    ckpt_path = str(tmp_path / "ck" / "step_1")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["infer", "--synthetic", "1", "--num-experts", "4", "--checkpoint", ckpt_path, *small])
    assert "mean PSNR" in out.getvalue()
    for experts in ("0", "2"):
        with pytest.raises(SystemExit, match="--num-experts 4"):
            cli.main(["infer", "--synthetic", "1", "--num-experts", experts, "--checkpoint", ckpt_path,
                      *small])
