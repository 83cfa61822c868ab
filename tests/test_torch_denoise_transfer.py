"""The port's denoising and transfer steps against the JAX package's, on
the CPU.

* ``make_denoising_train_step``: one step of ``AutoEncoder`` (default
  filters, dropout 0) at 192^2 (MS-SSIM's five scales need more than 160),
  batch 2, the mixed loss (alpha = beta = 0.5), on JAX's own draws: the
  test splits the step's key as the JAX step does (``k_geo``, ``k_aug``)
  and makes the geometric and corruption draws from them as the JAX
  functions do (``tests/test_torch_data_pipeline.py``), with rot90, crop and
  jitter on at 0.5 and with the default ``AugmentConfig``. SGD with lr 1,
  whose update -1.9 g gives the JAX step's gradients back. Loss and PSNR
  rtol 1e-5; the updates within 1e-4 x the largest.
* ``make_denoising_eval_step`` and ``make_inpainting_test_step`` (on JAX's
  blackout draws): PSNR atol 1e-4, the corrupted batch bit-equal, the
  prediction within 1e-4 x max|ref|.
* ``make_segmentation_train_step(output_index=1)`` on
  ``Autoencoder32K("mask")`` (dropout 0) at 32^2, the encoder frozen
  (``frozen_prefixes=("encoder",)`` in both, the port's encoder parameters
  also ``requires_grad=False``, as ``TransferFlow`` sets them): dice loss
  rtol 1e-5, IoU atol 1e-2 (a threshold at 0.5), the decoder's updates
  within 2e-2 x the largest (``tests/test_torch_train.py``'s limit for two
  fp32 implementations of train-mode BatchNorm: against the port's float64
  gradients, JAX's fp32 ones lie 0.42 % of the largest away and the port's
  0.36 %, so they differ by 0.42 % from each other), the encoder's
  parameters bit-equal to before the step and without gradients, and
  every BatchNorm stat (the frozen encoder's moved too) within 1e-4 x the
  largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.models import autoencoder as jae
from tchvp_tpu.models import resnet_ae as jres
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models import autoencoder as tae
from tchvp_tpu_torch.models import resnet_ae as tres
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from test_torch_conv_families import flax_variables
from test_torch_data_pipeline import _blackout_draws, _denoising_draws, _geometric_draws, _t
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 192
TOL = 1e-4
AUGS = {"default": {}, "geometric": dict(rot90_prob=0.5, crop_prob=0.5, jitter_prob=0.5)}


def _batch(seed, b=2, size=200, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, channels), dtype=np.uint8)


def _updates(before: dict, after: dict, keys) -> dict:
    return {k: after[k].numpy().astype(np.float64) - before[k].numpy() for k in keys}


def _close_updates(got: dict, want: dict, tol: float = TOL) -> None:
    top = max(float(np.abs(w).max()) for w in want.values())
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert err <= tol * top, f"max abs {err:.3g} > {tol} x {top:.3g}"


def _sgd(**kw):
    return dict(lr=1.0, optimizer="sgd", grad_clip_norm=1.0, **kw)


# ---------------------------------------------------------------- denoising


@pytest.fixture(scope="module")
def ae_variables():
    return flax_variables(jae.AutoEncoder(jcfg.AutoEncoderConfig(dropout_rate=0.0)),
                          np.zeros((1, SIZE, SIZE, 3), np.float32), seed=3)


def _port_ae(variables):
    model = tae.AutoEncoder(tcfg.AutoEncoderConfig(dropout_rate=0.0), device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize("aug", list(AUGS))
def test_denoising_step_matches_jax_on_jax_draws(ae_variables, aug):
    jaug, taug = jcfg.AugmentConfig(**AUGS[aug]), tcfg.AugmentConfig(**AUGS[aug])
    batch = _batch(4)
    key = jax.random.PRNGKey(11)  # the step donates its state, the key with it
    _, k_geo, k_aug, _ = jax.random.split(key, 4)
    jmodel = jae.AutoEncoder(jcfg.AutoEncoderConfig(dropout_rate=0.0))
    jst = jstate.TrainState.create(apply_fn=jmodel.apply,
                                   params=jax.tree.map(jnp.asarray, ae_variables["params"]),
                                   tx=jstate.make_optimizer(**_sgd()), rng=jnp.array(key))
    jnew, jm = jsteps.make_denoising_train_step(SIZE, jaug, "mixed", 0.5, 0.5)(jst, jnp.asarray(batch))
    shape = (2, SIZE, SIZE, 3)
    draws = {"geometric": _t(jax.tree.map(np.asarray, _geometric_draws(k_geo, shape, jaug))),
             "denoising": _t(jax.tree.map(np.asarray, _denoising_draws(k_aug, shape, jaug)))}
    model = _port_ae(ae_variables)
    state = tstate.create_train_state(model, tstate.make_optimizer(**_sgd()), rng=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = tsteps.make_denoising_train_step(SIZE, taug, "mixed", 0.5, 0.5)(
        state, torch.from_numpy(batch), draws=draws)
    assert state.step == 1 and set(m) == {"loss", "psnr"}
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = convert.from_flax({"params": jax.tree.map(np.asarray, jnew.params)})
    keys = [n for n, _ in model.named_parameters()]
    _close_updates(_updates(before, model.state_dict(), keys), _updates(before, want, keys))


def test_denoising_step_draws_from_the_state_generators(ae_variables):
    batch = torch.from_numpy(_batch(5))
    losses = []
    for seed in (7, 7, 8):
        model = tae.AutoEncoder(device="cpu")  # dropout 0.3
        model.load_state_dict(convert.from_flax(ae_variables), strict=True)
        state = tstate.create_train_state(model, tstate.make_optimizer(1e-3), rng=seed)
        losses.append(float(tsteps.make_denoising_train_step(SIZE, loss="mse")(state, batch)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_denoising_eval_and_inpainting_test_steps_match_jax(ae_variables):
    jmodel = jae.AutoEncoder(jcfg.AutoEncoderConfig(dropout_rate=0.0))
    jst = jstate.TrainState.create(apply_fn=jmodel.apply, params=ae_variables["params"],
                                   tx=jstate.make_optimizer(1e-3))
    state = tstate.create_train_state(_port_ae(ae_variables), tstate.make_optimizer(1e-3))
    batch = _batch(6)
    want = float(jsteps.make_denoising_eval_step(SIZE)(jst, jnp.asarray(batch))["psnr"])
    got = float(tsteps.make_denoising_eval_step(SIZE)(state, torch.from_numpy(batch))["psnr"])
    np.testing.assert_allclose(got, want, atol=1e-4)

    aug = jcfg.AugmentConfig()
    key = jax.random.PRNGKey(3)
    jm, jcorrupted, jpred = jsteps.make_inpainting_test_step(SIZE, aug)(jst, jnp.asarray(batch), key)
    draws = _t(jax.tree.map(np.asarray, _blackout_draws(key, SIZE, SIZE, aug.max_blackout_patches,
                                                        aug.test_blackout_size)))
    m, corrupted, pred = tsteps.make_inpainting_test_step(SIZE, tcfg.AugmentConfig())(
        state, torch.from_numpy(batch), None, draws=draws)
    np.testing.assert_allclose(float(m["psnr"]), float(jm["psnr"]), atol=1e-4)
    np.testing.assert_array_equal(corrupted.numpy() == 0, np.asarray(jcorrupted) == 0)
    np.testing.assert_allclose(corrupted.numpy(), np.asarray(jcorrupted), atol=1e-5, rtol=0)
    err = float(np.abs(pred.numpy() - np.asarray(jpred)).max())
    assert err <= TOL * float(np.abs(np.asarray(jpred)).max())


def test_unported_denoising_options_raise_naming_item_11(ae_variables):
    """``fsdp_axis`` (item 11d, ported): with no mesh carrying the axis the
    step is the plain step, bit for bit, as JAX's is dormant there."""
    batch = torch.from_numpy(_batch(6))
    states = []
    for kw in ({}, {"fsdp_axis": "data"}):
        model = _port_ae(ae_variables)
        state = tstate.create_train_state(model, tstate.make_optimizer(**_sgd()), rng=0)
        tsteps.make_denoising_train_step(SIZE, loss="mse", **kw)(state, batch)
        states.append(model.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


# ---------------------------------------------------------------- transfer step


MASK_SIZE = 32


def _mask_batch(seed):
    return _batch(seed, size=MASK_SIZE), (_batch(seed + 1, size=MASK_SIZE, channels=1) > 127).astype(np.uint8) * 255


def test_frozen_encoder_segmentation_step_matches_jax():
    jmodel = jres.Autoencoder32K(jcfg.ResNetAEConfig(output_type="mask", dropout_rate=0.0))
    variables = flax_variables(jmodel, np.zeros((1, MASK_SIZE, MASK_SIZE, 3), np.float32), seed=8,
                               train=False)
    image_u8, mask_u8 = _mask_batch(12)
    jst = jstate.TrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(**_sgd(frozen_prefixes=("encoder",))),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(2))
    jnew, jm = jsteps.make_segmentation_train_step(MASK_SIZE, "dice", output_index=1)(
        jst, (jnp.asarray(image_u8), jnp.asarray(mask_u8)))
    want = convert.from_flax({"params": jax.tree.map(np.asarray, jnew.params),
                              "batch_stats": jax.tree.map(np.asarray, jnew.batch_stats)})

    model = tres.Autoencoder32K(tcfg.ResNetAEConfig(output_type="mask", dropout_rate=0.0), device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(**_sgd(frozen_prefixes=("encoder",))))
    model.encoder.requires_grad_(False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = tsteps.make_segmentation_train_step(MASK_SIZE, "dice", output_index=1)(
        state, (torch.from_numpy(image_u8), torch.from_numpy(mask_u8)))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert abs(float(m["iou"]) - float(jm["iou"])) <= 1e-2
    after = model.state_dict()
    encoder = [n for n, _ in model.named_parameters() if n.startswith("encoder.")]
    assert encoder and all(torch.equal(after[n], before[n]) for n in encoder)
    assert all(p.grad is None for p in model.encoder.parameters())
    decoder = [n for n, _ in model.named_parameters() if n.startswith("decoder.")]
    _close_updates(_updates(before, after, decoder), _updates(before, want, decoder), tol=2e-2)
    stats = [k for k in after if "running" in k]
    assert all(not torch.equal(after[k], before[k]) for k in stats if k.startswith("encoder."))
    top = max(float(want[k].abs().max()) for k in stats)
    assert max(float((after[k] - want[k]).abs().max()) for k in stats) <= TOL * top
