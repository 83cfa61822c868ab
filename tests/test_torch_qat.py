"""The port's quantization-aware training (``tchvp_tpu_torch/train/qat.py``)
against the JAX package's (``tchvp_tpu/train/qat.py``) on the CPU.

* ``ste_round``, ``fake_quant`` (forward and gradients: the STE inside the
  range, zero outside, half at a bound as ``jnp.clip`` gives), and the
  activation and kernel scales (the all-zero guards too) against JAX's on
  numpy inputs.
* One conv and one Dense under ``qat_fake_quant`` against JAX's, and (as
  ``tests/test_qat.py`` holds JAX) against the port's int8 engine
  calibrated on the same batch: within 1e-5. Exclusions keep a layer fp.
* One ``make_video_train_step(qat=True, qat_dense=True)`` against JAX's at
  ``tests/test_torch_train.py``'s cell (32^2, D 64, mse, no noise or
  dropout, SGD lr 1), both packages' ``qat_fake_quant`` given ``exclude``
  for every layer but STEP_QAT (a conv at each end of the network and a
  Dense): loss within 1e-4 of itself (measured 2.6e-5: the quantized
  head rounds a few edges apart), gradients 2e-2 x the largest (the limit of
  ``test_torch_train.py``; measured 0.85e-2), the ``qat_fake_quant`` and
  ``qat_fake_quant_dense`` markers recorded, the fp step 0.47 away.
  With every layer quantized the step is chaotic at this cell: a
  one-ulp change of half of JAX's weights moves its own gradients by 0.78 x
  the largest (1.09 in rms) and its loss by 1.2 %, as the port's do with
  the thread count. A flipped round(x / s) at a .5 edge changes an
  activation by a quantum and the flips cascade through the 35 quantized
  convs and train-mode BatchNorm; the port's step sits as far from JAX's
  (0.61, 1.24) as JAX's from itself, and as far as the fp step does, so the
  whole step is held port-only: both markers, a finite loss, and the
  remat policy ``stages`` (whose backward recomputes the forward under the
  interceptor) giving ``none``'s gradients. The eval step's PSNR with
  ``qat`` against JAX's.
* A checkpointed region under ``qat_fake_quant`` whose backward runs on
  another thread, as the autograd engine runs a CUDA backward: its
  recompute still fake-quantizes, and gives the gradients of no remat.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import SIZE, _batch, _configs, _jax_variables, _port_state
from tchvp_tpu.infer import quant as jq
from tchvp_tpu.train import qat as jqat
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.infer import quant as tq
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.ops.blocks import Conv2d, Dense, with_current_hook
from tchvp_tpu_torch.ops.conv_attention import PaddedConv2d
from tchvp_tpu_torch.train import qat as tqat
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_fake_quant_and_its_gradients_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32) * 3.0
    scale = np.float32(0.02)
    x[:4] = [127 * scale, -127 * scale, 200 * scale, -0.51 * scale]  # at and past the bounds
    w = rng.standard_normal(64).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x).requires_grad_(True)
    want, jgrad = jax.value_and_grad(lambda v: jnp.sum(jqat.fake_quant(v, jnp.float32(scale)) * w))(jx)
    got = torch.sum(tqat.fake_quant(tx, torch.tensor(scale)) * torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tqat.fake_quant(torch.from_numpy(x), torch.tensor(scale)).numpy(),
                                  np.asarray(jqat.fake_quant(jx, jnp.float32(scale))))
    sgrad = jax.grad(lambda v: jnp.sum(jqat.ste_round(v) * w))(jx)
    tx.grad = None
    torch.sum(tqat.ste_round(tx) * torch.from_numpy(w)).backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(sgrad))


@pytest.mark.parametrize("zero", [False, True])
def test_scales_match_jax(zero):
    rng = np.random.default_rng(1)
    x = np.zeros((2, 5, 3), np.float32) if zero else rng.standard_normal((2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tqat._act_scale(torch.from_numpy(x)).numpy(),
                                  np.asarray(jqat._act_scale(jnp.asarray(x))))
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)  # HWIO
    w[..., 2] = 0.0
    got = tqat._kernel_scale(torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()))  # OIHW
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(jqat._kernel_scale(jnp.asarray(w))))


class _Wrap(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.c = layer

    def forward(self, x):
        return self.c(x)


def _one_layer(dense: bool, seed: int):
    """(JAX module, its params, the port's wrapped layer, x NHWC / (B, S, F))."""
    import flax.linen as nn

    class J(nn.Module):
        @nn.compact
        def __call__(self, x):
            return (nn.Dense(6, name="c") if dense else nn.Conv(4, (3, 3), padding="SAME", name="c"))(x)

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 8) if dense else (2, 8, 8, 3)).astype(np.float32)
    jm = J()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda s: rng.normal(0.0, 0.3, s.shape).astype(np.float32), shapes)
    port = _Wrap(Dense(8, 6) if dense else PaddedConv2d(3, 4, 3))
    port.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, port, x


def _nchw(x, dense):
    t = torch.from_numpy(x)
    return t if dense else t.permute(0, 3, 1, 2)


@pytest.mark.parametrize("dense", [False, True])
def test_fake_quant_layer_matches_jax_and_the_int8_engine(dense):
    jm, params, port, x = _one_layer(dense, 2)
    with jqat.qat_fake_quant(dense=True):
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with dispatch_trace.capture() as seen, tqat.qat_fake_quant(dense=True):
        got = port(_nchw(x, dense))
    assert ("qat_fake_quant_dense" if dense else "qat_fake_quant") in seen
    got = got.detach() if dense else got.detach().permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    eng = tq.Int8Engine(port, quantize_dense=dense).calibrate([_nchw(x, dense)])
    served = eng.apply(eng.qparams, _nchw(x, dense))
    served = served if dense else served.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), served.numpy(), rtol=1e-5, atol=1e-5)


def test_exclusions_stay_fp():
    _, _, port, x = _one_layer(False, 3)
    with torch.no_grad():
        want = port(_nchw(x, False))
        with tqat.qat_fake_quant(exclude=("c",), model=port):
            assert torch.equal(port(_nchw(x, False)), want)
        with tqat.qat_fake_quant():
            assert not torch.equal(port(_nchw(x, False)), want)
    with pytest.raises(ValueError, match="model"):
        with tqat.qat_fake_quant(exclude=("c",)):
            pass


# The layers the whole-step comparison quantizes: a conv at each end of the
# network and one Dense (module docstring).
STEP_QAT = ("encoder/stem_conv", "temporal/attention_1/out_linear", "decoder/head_conv")


def _excluded_but(model, keep):
    """Every flax path JAX's interceptor reaches in ``model`` but ``keep``."""
    x = jnp.zeros((1, 2, SIZE, SIZE, 3))
    keys = set()

    def record(next_fn, module, x, **kw):
        keys.add(jq._path_key(module))
        return next_fn(x, **kw)

    def apply(v):
        with jq._conv_interceptor(record, dense=True):
            return model.apply(v, x)

    jax.eval_shape(apply, jax.eval_shape(model.init, jax.random.PRNGKey(0), x))
    assert set(keep) <= keys
    return tuple(sorted(keys - set(keep)))


@pytest.fixture(scope="module")
def jax_qat_step():
    """JAX's variables and metrics after one QAT step (Dense too), its
    interceptor given ``exclude`` for every layer but STEP_QAT."""
    jc, tc = _configs(dropout=False)
    model, variables = _jax_variables(jc)
    excluded = _excluded_but(model, STEP_QAT)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqat, "qat_fake_quant", functools.partial(jqat.qat_fake_quant, exclude=excluded))
        step = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, qat=True, qat_dense=True)
        new, metrics = step(st, jnp.asarray(_batch()))
    want = {"params": jax.tree.map(np.asarray, new.params), "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}
    port_excluded = tuple(convert._module_name(tuple(k.split("/")))[0] for k in excluded)
    return model, tc, variables, want, {k: float(v) for k, v in metrics.items()}, port_excluded


def _qat_step(tc, variables, policy="none", exclude=None, qat=True):
    """The port's state after one QAT step (``exclude``: the layers its
    interceptor keeps fp) and the markers it recorded."""
    state = _port_state(tc, variables)
    step = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, qat=qat, qat_dense=qat,
                                        remat_policy=policy)
    with pytest.MonkeyPatch.context() as mp, dispatch_trace.capture() as seen:
        if exclude is not None:
            mp.setattr(tqat, "qat_fake_quant",
                       functools.partial(tqat.qat_fake_quant, exclude=exclude, model=state.model))
        state, metrics = step(state, torch.from_numpy(_batch()))
    return state, metrics, seen


def test_qat_train_step_matches_jax(jax_qat_step):
    _, tc, variables, want_vars, want_metrics, excluded = jax_qat_step
    state, metrics, seen = _qat_step(tc, variables, exclude=excluded)
    assert {"qat_fake_quant", "qat_fake_quant_dense"} <= seen
    np.testing.assert_allclose(float(metrics["loss"]), want_metrics["loss"], rtol=1e-4, atol=0)
    before, after = convert.from_flax(variables), convert.from_flax(want_vars)
    named = dict(state.model.named_parameters())
    g_jax = {k: (before[k].numpy() - after[k].numpy()) / 1.9 for k in named}  # SGD: p1 = p0 - 1.9 g
    atol = 2e-2 * max(np.abs(g).max() for g in g_jax.values())
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), g_jax[key], atol=atol, rtol=0, err_msg=key)
    # The fp step lies far outside the limit (0.47 x the largest gradient).
    fp_state, _, _ = _qat_step(tc, variables, qat=False)
    fp = dict(fp_state.model.named_parameters())
    assert max(np.abs(fp[k].grad.numpy() - g_jax[k]).max() for k in named) > 5 * atol


def test_whole_qat_step_quantizes_every_layer_and_recomputes_under_remat(jax_qat_step):
    _, tc, variables, *_ = jax_qat_step
    plain, metrics, seen = _qat_step(tc, variables)
    assert {"qat_fake_quant", "qat_fake_quant_dense"} <= seen and np.isfinite(float(metrics["loss"]))
    remat, _, seen = _qat_step(tc, variables, "stages")
    assert "qat_fake_quant" in seen
    for (name, p), q in zip(plain.model.named_parameters(), remat.model.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_qat_eval_step_matches_jax(jax_qat_step):
    model, tc, variables, *_ = jax_qat_step
    jst = jstate.TrainState.create(apply_fn=model.apply, params=variables["params"], tx=optax.sgd(0.1),
                                   batch_stats=variables["batch_stats"])
    want = float(jsteps.make_video_eval_step(SIZE, qat=True, qat_dense=True)(jst, jnp.asarray(_batch(7)))["psnr"])
    with dispatch_trace.capture() as seen:
        got = tsteps.make_video_eval_step(SIZE, qat=True, qat_dense=True)(_port_state(tc, variables),
                                                                          torch.from_numpy(_batch(7)))
    assert "qat_fake_quant_dense" in seen
    np.testing.assert_allclose(float(got["psnr"]), want, atol=1e-3, rtol=0)


def _backward_on_another_thread(loss: torch.Tensor) -> None:
    """``loss.backward()`` on a new thread, which sees none of this
    thread's context variables (as the autograd engine's CUDA thread)."""
    errors = []

    def run():
        try:
            loss.backward()
        except Exception as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if errors:
        raise errors[0]


def test_checkpoint_recompute_on_another_thread_keeps_the_qat_hook():
    torch.manual_seed(0)
    net = torch.nn.Sequential(Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(), Conv2d(8, 4, 3, padding=1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(np.float32))
    checkpoint = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False,
                                   preserve_rng_state=False)

    def grads(run):
        net.zero_grad()
        with dispatch_trace.capture() as seen:
            with tqat.qat_fake_quant():
                y = run(x)
            _backward_on_another_thread(y.square().sum())
        assert "qat_fake_quant" in seen
        return [p.grad.clone() for p in net.parameters()]

    want = grads(net)
    atol = 1e-6 * max(float(w.abs().max()) for w in want)  # a few ulps: a thread's conv backward sums its own way
    got = grads(lambda c: checkpoint(with_current_hook(net), c))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=atol, rtol=0)
    # The control: without the hook carried over, the recompute runs the fp
    # convs, and the backward refuses (it saves another number of tensors).
    with pytest.raises(torch.utils.checkpoint.CheckpointError, match="different number of tensors"):
        grads(lambda c: checkpoint(net, c))
