"""The port's windowed (banded) temporal attention against the JAX package's.

* The dense cores ``sdpa_windowed`` and ``_sdpa_banded`` (with a nonzero
  left context ``k_prev0``, masked and not): fp32 atol 1e-5; bf16 within
  one bf16 rounding (an ulp of the largest output).
* The ``multi_head_attention`` dispatch: every (impl, window) pair runs the
  core JAX runs (its ``dispatch_trace`` markers, the port's ``*_plain``
  kernel markers aside) and gives JAX's output, fp32 atol 1e-5.
* ``windowed_mha``: on the CPU the port runs the kernels' plain versions
  (dense fp32 over the (S, S) logits with the band masked); JAX runs the
  Pallas band kernels in interpret mode, and ``jax.grad`` their backward.
  Forward and gradients atol 1e-5, without and with dropout (the hash mask
  is bit-exact in both), at a ragged S, a window that 16 does not divide,
  and one window (w >= S), where the result equals the port's ``mha``.
* The flagship with a window: the eval forward on ``"flash"`` and on
  ``"windowed"`` against JAX from the same weights (``convert.from_flax``),
  atol/rtol 1e-4; one ``make_video_train_step`` on ``"flash"`` with a window
  against JAX's at ``tests/test_torch_train.py``'s tolerances; and, port
  only, the remat ``"stages"`` policy with dropout on gives the gradients
  of ``"none"`` with every draw in place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.ops import attention as jatt
from tchvp_tpu.ops import dispatch_trace as jtrace
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5


def _arrays(shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _close(got, want, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------- dense cores


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_windowed_matches_jax(dtype):
    q, k, v = _arrays((2, 3, 48, 8))
    want = jatt.sdpa_windowed(*(jnp.asarray(t, dtype) for t in (q, k, v)), window_size=16)
    with dispatch_trace.capture() as seen:
        got = tatt.sdpa_windowed(*(torch.from_numpy(t).to(getattr(torch, dtype)) for t in (q, k, v)),
                                 window_size=16)
    assert seen == {"sdpa_windowed", "banded_core"}
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 3, 48, 8)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    # bf16: one rounding, an ulp (2^-7 relative) of the largest output.
    _close(got.float(), want, atol=ATOL if dtype == "float32" else 2.0**-7 * np.abs(want).max())


@pytest.mark.parametrize("mask_prev0", [False, True])
def test_sdpa_banded_left_context_matches_jax(mask_prev0):
    q, k, v = _arrays((1, 2, 32, 8), seed=1)
    k_prev0, v_prev0 = _arrays((1, 2, 8, 8), n=2, seed=2)
    args = (q, k, v, k_prev0, v_prev0)
    want = jatt._sdpa_banded(*(jnp.asarray(t) for t in args), jnp.asarray(mask_prev0),
                             window_size=8, scale=0.3)
    got = tatt._sdpa_banded(*(torch.from_numpy(t) for t in args), torch.tensor(mask_prev0),
                            window_size=8, scale=0.3)
    _close(got, want)
    # The context is what the first window sees: masked, it changes nothing.
    no_ctx = tatt.sdpa_windowed(*(torch.from_numpy(t) for t in (q, k, v)), window_size=8, scale=0.3)
    assert torch.equal(got, no_ctx) == mask_prev0


def test_sdpa_windowed_needs_whole_windows_and_drops_from_the_generator():
    q, k, v = (torch.from_numpy(t) for t in _arrays((1, 2, 40, 8)))
    with pytest.raises(AssertionError, match="multiple of window"):
        tatt.sdpa_windowed(q, k, v, window_size=16)

    def run(seed):
        return tatt.sdpa_windowed(q, k, v, window_size=8, dropout_rate=0.5, deterministic=False,
                                  generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


# ------------------------------------------------------------------- dispatch


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("impl", ["xla", "flash", "windowed", "auto"])
def test_dispatch_runs_the_core_jax_runs(impl, window):
    q, k, v = _arrays((2, 48, 32), seed=3)
    with jtrace.capture() as jax_seen:
        want = jatt.multi_head_attention(*(jnp.asarray(t) for t in (q, k, v)), 4, impl=impl,
                                         window_size=window, scale=0.25)
    with dispatch_trace.capture() as seen:
        got = tatt.multi_head_attention(*(torch.from_numpy(t) for t in (q, k, v)), 4, impl=impl,
                                        window_size=window, scale=0.25)
    assert {m for m in seen if not m.endswith("_plain")} == jax_seen
    _close(got, want)


def test_a_mask_takes_the_dense_core_for_every_windowed_impl():
    q, k, v = (torch.from_numpy(t) for t in _arrays((2, 48, 32), seed=4))
    mask = torch.ones(2, 1, 48, 48, dtype=torch.bool)
    for impl in ("flash", "windowed", "auto"):
        with dispatch_trace.capture() as seen:
            tatt.multi_head_attention(q, k, v, 4, impl=impl, window_size=16, mask=mask)
        assert seen == {"sdpa_xla"}, impl


# -------------------------------------------------------- windowed_mha kernel


def _jax_windowed(q, k, v, ct, window, scale, rate, seed):
    def f(q, k, v):
        out = jfa.windowed_mha(q, k, v, window_size=window, scale=scale, interpret=True,
                               dropout_rate=rate, dropout_seed=seed)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    return out, grads


def _torch_windowed(q, k, v, ct, window, scale, rate, seed):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tfa.windowed_mha(qt, kt, vt, window_size=window, scale=scale, dropout_rate=rate,
                           dropout_seed=seed)
    out.backward(torch.from_numpy(ct))
    return out.detach(), (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("shape,window", [
    ((1, 2, 48, 8), 16),   # three whole windows
    ((1, 2, 40, 8), 16),   # ragged S: a partial last window
    ((1, 2, 96, 16), 24),  # a window that 16 does not divide
])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 7)])
def test_windowed_mha_matches_jax_interpret(shape, window, rate, seed):
    q, k, v, ct = _arrays(shape, n=4, seed=5)
    want_out, want_grads = _jax_windowed(q, k, v, ct, window, 0.3, rate, seed)
    with dispatch_trace.capture() as seen:
        out, grads = _torch_windowed(q, k, v, ct, window, 0.3, rate, seed)
    assert seen == {"flash_windowed_plain", "flash_windowed_bwd_plain"}
    assert (tfa.band_fwd_launches, tfa.band_dq_launches, tfa.band_dkv_launches) == (0, 0, 0)
    _close(out, want_out, msg="out")
    for name, g, w in zip("qkv", grads, want_grads):
        _close(g, w, msg=f"d{name}")


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.2, 11)])
def test_one_window_equals_full_flash_attention(rate, seed):
    q, k, v, ct = _arrays((2, 2, 20, 8), n=4, seed=6)
    out_w, grads_w = _torch_windowed(q, k, v, ct, 32, 0.3, rate, seed)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tfa.mha(qt, kt, vt, scale=0.3, dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(ct))
    torch.testing.assert_close(out_w, out.detach(), rtol=0, atol=0)
    for g_w, g in zip(grads_w, (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(g_w, g, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_windowed_plain_backward_is_the_vjp_of_its_forward(rate):
    q, k, v, ct = (torch.from_numpy(t).reshape(3, 40, 8) for t in _arrays((1, 3, 40, 8), n=4, seed=8))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = tfa.windowed_mha_reference(qr, kr, vr, 0.25, 16, rate, 99)
    out.backward(ct)
    delta = (ct * out.detach()).sum(-1)
    args = (q, k, v, ct, lse.detach(), delta, 0.25, 16, rate, 99)
    got = (tfa.windowed_mha_bwd_dq_reference(*args),) + tfa.windowed_mha_bwd_dkv_reference(*args)
    for g, w in zip(got, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def test_band_mask_is_the_tpu_kernels_band():
    want = np.asarray(jfa._band_mask((40, 40), 0, 0, 16, 40))
    np.testing.assert_array_equal(tfa.band_mask(40, 16, torch.device("cpu")).numpy(), want)


def test_windowed_mha_rejects_bad_arguments_and_keeps_bf16():
    q = torch.zeros(1, 1, 16, 8, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="window_size"):
        tfa.windowed_mha(q, q, q, window_size=0)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.windowed_mha(q, q, q, window_size=4, dropout_rate=0.1)
    tfa.windowed_mha(q, q, q, window_size=4).sum().backward()
    assert q.grad.dtype == torch.bfloat16 and q.grad.shape == q.shape


# -------------------------------------------------------------- the flagship

SIZE = 32
FRAMES = 4  # S = 32 tokens: four windows of one frame (8 tokens)
WINDOW = 8


def _configs(attn_impl, dropout=False):
    def cut(c):
        return dataclasses.replace(
            c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.3 if dropout else 0.0),
            temporal=dataclasses.replace(c.temporal, dropout_rate=0.1 if dropout else 0.0))

    kw = dict(image_size=SIZE, num_heads=8, hidden_dim=32, attn_impl=attn_impl, window_size=WINDOW)
    return cut(jcfg.flagship_video_config(**kw)), cut(tcfg.flagship_video_config(**kw))


def _jax_variables(jc):
    """The JAX model and seeded numpy variables of its shapes (only the
    shapes come from flax: ``eval_shape``)."""
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


def _batch(seed=6, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, FRAMES, 48, 48, 3), dtype=np.uint8)


def _port_model(tc, variables):
    model = tvideo.VideoHybridNet(tc, device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize("attn_impl,markers", [
    ("flash", {"flash_windowed", "flash_windowed_plain"}),
    ("windowed", {"sdpa_windowed", "banded_core"}),
])
def test_windowed_flagship_eval_matches_jax(attn_impl, markers):
    jc, tc = _configs(attn_impl)
    jmodel, variables = _jax_variables(jc)
    raw = _batch(b=1)
    tokens_j, recon_j = jmodel.apply(variables, jpipe.preprocess_clip(jnp.asarray(raw), SIZE))
    port = _port_model(tc, variables).eval()
    with dispatch_trace.capture() as seen, torch.no_grad():
        tokens, recon = port(tpipe.preprocess_clip(torch.from_numpy(raw), SIZE))
    assert seen == markers
    assert tokens.shape == (1, FRAMES * 8, (SIZE // 4) ** 2)
    _close(tokens, tokens_j, atol=1e-4, rtol=1e-4)
    _close(recon, recon_j, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_windowed_step():
    """JAX's updated variables and metrics after one windowed step."""
    jc, tc = _configs("flash")
    model, variables = _jax_variables(jc)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    step = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)
    new, metrics = step(st, jnp.asarray(_batch()))
    want = {"params": jax.tree.map(np.asarray, new.params),
            "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}
    return tc, variables, want, {k: float(v) for k, v in metrics.items()}


def test_windowed_train_step_matches_jax(jax_windowed_step):
    tc, variables, want_vars, want_metrics = jax_windowed_step
    state = tstate.create_train_state(_port_model(tc, variables), tstate.make_optimizer(1.0, optimizer="sgd"),
                                      rng=3)
    step = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, torch.from_numpy(_batch()))
    assert {"flash_windowed_plain", "flash_windowed_bwd_plain"} <= seen
    assert not seen & {"sdpa_xla", "flash_mha", "sdpa_windowed"}
    for k in ("loss", "psnr"):
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
            _close(named[key].grad, g_jax[key], atol=grad_atol, msg=f"grad {key}")
            _close(val, want[key], atol=1.9 * grad_atol, msg=key)
        else:
            _close(val, want[key], atol=1e-5, msg=key)


@pytest.mark.parametrize("attn_impl", ["flash", "windowed"])
def test_windowed_remat_stages_gives_the_gradients_of_none(attn_impl):
    """Dropout on: the attention draws (a seed for the kernels, a
    (B, H, S/w, w, 2w) keep mask for the dense band) come from the state's
    generator before the forward, so the recompute applies the same ones."""
    jc, tc = _configs(attn_impl, dropout=True)
    _, variables = _jax_variables(jc)
    results = []
    for policy in ("none", "stages"):
        state = tstate.create_train_state(_port_model(tc, variables),
                                          tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
        draws = state.model.draw_dropout((2, FRAMES, SIZE, SIZE, 3), torch.Generator().manual_seed(0),
                                         torch.device("cpu"))
        shape = (1,) if attn_impl == "flash" else (2, 8, FRAMES, WINDOW, 2 * WINDOW)
        assert all(tuple(a.shape) == shape for a in draws.temporal.attention)
        _, metrics = tsteps.make_video_train_step(SIZE, loss="mse", remat_policy=policy)(
            state, torch.from_numpy(_batch()))
        results.append((float(metrics["loss"]), {n: p.grad for n, p in state.model.named_parameters()}))
    (loss, grads), (loss_s, grads_s) = results
    assert loss == loss_s
    for name in grads:
        torch.testing.assert_close(grads_s[name], grads[name], atol=1e-6, rtol=0, msg=name)
