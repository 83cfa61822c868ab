"""BASELINE config 3's mixed precision: the port's
``VideoHybridNet(compute_dtype=torch.bfloat16)`` against the JAX package's
``VideoHybridNet(dtype=bfloat16)`` (fp32 ``param_dtype``), at the
``test_torch_train.py`` model (32^2, D 64, 8 heads, FFN 32, dropout 0,
"xla" attention).

One SGD (lr 1) step with ``loss="mse"`` and no input noise, from the same
seeded variables: the parameters, the gradients and the BatchNorm running
stats stay fp32, and the loss lies within rtol 1e-2 of JAX's bf16 loss and
is not the port's fp32 loss (the autocast scope ran).

Whether the port rounds where flax does is held stage by stage, each stage
given the JAX bf16 model's input to it, JAX run op by op: that is the
program's own rounding. Under ``jax.jit`` XLA's CPU compiler drops some of
the roundings inside its fusions; its jitted bf16 stages lie as far from
its eager ones as from fp32. Over a whole step it cannot be held:
two bf16 implementations that round at the same points still part once a
value flips to the other side of a rounding boundary, and train-mode
BatchNorm spreads each flip over its channel. At this size any two bf16
steps' gradients lie 0.3-0.9 (relative RMS) apart, as far as bf16 from
fp32, and the loss 1e-3 apart.

Each stage's distance from JAX's bf16 output (relative RMS) must stay
within 0.3 x the distance between JAX's bf16 and fp32 outputs, and the
port's fp32 model, as a control, must fail that limit. Measured (ratio to
that gap): the temporal transformer 0, the decoder 0.25, the encoder's
first residual block 0.003 (eval mode), and the decoder's running-stat
updates 0.02 (train mode). Fusing each bias into its product's one
rounding (torch's own layers) reads 1.0-1.1 at the temporal stage and the
decoder, attention logits in bf16 0.8 at the temporal stage; the fp32
control reads ~1. CPU autocast hands LayerNorm on in bf16 already, so the
cast back that CUDA's autocast needs (``transformer._norm``) is held on the
card (``chip_smoke.py`` phase 17: the temporal output stays bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.models import video as jvideo
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from test_torch_train import SIZE, _batch, _configs, _jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LIMIT = 0.3  # x the distance between JAX's bf16 and fp32 outputs
HW = (SIZE // 4, SIZE // 4)


def _xla(c):
    return dataclasses.replace(c, temporal=dataclasses.replace(c.temporal, attn_impl="xla"))


@pytest.fixture(scope="module")
def setup():
    jc, tc = (_xla(c) for c in _configs(dropout=False))
    _, variables = _jax_variables(jc)
    # The JAX bf16 model's (eval-mode) inputs to the temporal stage and
    # the decoder: any bf16 input both sides are given will do.
    tokens = _jax(jc, variables, jnp.bfloat16, "encode_clip", jnp.asarray(_clip()), jit=True)[0]
    inputs = {"temporal": tokens,
              "decoder": _jax(jc, variables, jnp.bfloat16, "temporal_mix", tokens, jit=True)}
    return jc, tc, variables, convert.from_flax(variables), inputs


@pytest.fixture(scope="module")
def steps(setup):
    jc, tc, variables, before, _ = setup
    out = {}
    model = jvideo.VideoHybridNet(config=jc, dtype=jnp.bfloat16)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    _, m = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)(st, jnp.asarray(_batch()))
    out["jax_bf16"] = float(m["loss"])
    for name, cd in (("port_bf16", torch.bfloat16), ("port_fp32", None)):
        model = tvideo.VideoHybridNet(tc, device="cpu", compute_dtype=cd)
        model.load_state_dict(before, strict=True)
        state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
        state, m = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)(
            state, torch.from_numpy(_batch()))
        out[name] = (float(m["loss"]), model)
    return out


def test_parameters_grads_and_stats_stay_fp32(steps):
    model = steps["port_bf16"][1]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for n, b in model.named_buffers() if "running" in n} == {torch.float32}


def test_bf16_loss_within_bf16_limits_of_jax(steps):
    np.testing.assert_allclose(steps["port_bf16"][0], steps["jax_bf16"], rtol=1e-2, atol=0)
    assert steps["port_bf16"][0] != steps["port_fp32"][0]


# ---------------------------------------------------------------- stages


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax(jc, variables, dtype, method, x, *static, jit=False, **kw):
    """``VideoHybridNet(dtype).<method>(x, *static)``, op by op unless
    ``jit`` (module docstring)."""
    model = jvideo.VideoHybridNet(config=jc, dtype=dtype)
    fn = getattr(jvideo.VideoHybridNet, method)

    def run(v, x):
        return model.apply(v, x, *static, method=fn, **kw)

    return (jax.jit(run) if jit else run)(jax.tree.map(jnp.asarray, variables), x)


def _port(tc, state_dict, compute_dtype, train):
    model = tvideo.VideoHybridNet(tc, device="cpu", compute_dtype=compute_dtype)
    model.load_state_dict(state_dict, strict=True)
    return model.train(train)


def _clip():
    return np.random.default_rng(5).uniform(0, 1, (2, 2, SIZE, SIZE, 3)).astype(np.float32)


def _encoder_block(jc, tc, variables, sd, inputs):
    """The first residual block's output (eval mode) on the clip."""
    clip = _clip()
    picked = lambda mdl, method: mdl.name == "layer1_block0" and method == "__call__"  # noqa: E731
    jax_out = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        _, st = _jax(jc, variables, dtype, "encode_clip", jnp.asarray(clip),
                     capture_intermediates=picked, mutable=["intermediates"])
        jax_out[dtype] = _f32(st["intermediates"]["encoder"]["layer1_block0"]["__call__"][0])
    port_out = {}
    for cd in (torch.bfloat16, None):
        model = _port(tc, sd, cd, train=False)
        seen = []
        model.encoder.blocks.layer1_block0.register_forward_hook(lambda m, i, o: seen.append(o))
        with torch.no_grad():
            model.encode_clip(torch.from_numpy(clip))
        port_out[cd] = seen[0].float().permute(0, 2, 3, 1).numpy()
    return jax_out, port_out


def _port_input(x, cd):
    """JAX's bf16 stage input for the port: bf16 under autocast, else its
    values in fp32 (the fp32 model takes fp32)."""
    return torch.from_numpy(np.array(_f32(x))).to(cd or torch.float32)


def _temporal(jc, tc, variables, sd, inputs):
    x = inputs["temporal"]
    jax_out = {dt: _f32(_jax(jc, variables, dt, "temporal_mix", x)) for dt in (jnp.bfloat16, jnp.float32)}
    port_out = {}
    for cd in (torch.bfloat16, None):
        with torch.no_grad():
            port_out[cd] = _port(tc, sd, cd, train=False).temporal_mix(_port_input(x, cd)).float().numpy()
    return jax_out, port_out


def _decoder(jc, tc, variables, sd, inputs):
    x = inputs["decoder"]
    jax_out = {dt: _f32(_jax(jc, variables, dt, "decode_tokens", x, HW)) for dt in (jnp.bfloat16, jnp.float32)}
    port_out = {}
    for cd in (torch.bfloat16, None):
        with torch.no_grad():
            port_out[cd] = _port(tc, sd, cd, train=False).decode_tokens(_port_input(x, cd), HW).float().numpy()
    return jax_out, port_out


def _decoder_stats(jc, tc, variables, sd, inputs):
    """How far one train-mode decoder pass moves each running stat."""
    x = inputs["decoder"]
    names = sorted(k for k in sd if k.startswith("decoder.") and "running" in k)

    def moved(stats):
        return np.concatenate([(np.asarray(stats[k], np.float64) - sd[k].double().numpy()).ravel()
                               for k in names])

    jax_out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        _, upd = _jax(jc, variables, dt, "decode_tokens", x, HW, train=True, mutable=["batch_stats"])
        stats = convert.from_flax({"params": variables["params"], "batch_stats": {
            **variables["batch_stats"], **jax.tree.map(np.asarray, upd["batch_stats"])}})
        jax_out[dt] = moved(stats)
    port_out = {}
    for cd in (torch.bfloat16, None):
        model = _port(tc, sd, cd, train=True)
        with torch.no_grad():
            model.decode_tokens(_port_input(x, cd), HW)
        port_out[cd] = moved(model.state_dict())
    return jax_out, port_out


@pytest.mark.parametrize("stage", [_encoder_block, _temporal, _decoder, _decoder_stats],
                         ids=["encoder_block_eval", "temporal_eval", "decoder_eval", "decoder_stats_train"])
def test_bf16_stages_round_as_flax(setup, stage):
    jax_out, port_out = stage(*setup)
    gap = _rel(jax_out[jnp.float32], jax_out[jnp.bfloat16])
    assert gap > 0
    bf16 = _rel(port_out[torch.bfloat16], jax_out[jnp.bfloat16])
    assert bf16 <= LIMIT * gap, f"bf16 {bf16:.3g} > {LIMIT} x gap {gap:.3g}"
    control = _rel(port_out[None], jax_out[jnp.bfloat16])
    assert control > LIMIT * gap, f"the fp32 control {control:.3g} meets the limit {LIMIT} x {gap:.3g}"
