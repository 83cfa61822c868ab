"""The port's losses and MS-SSIM against the JAX package, values and
gradients.

Inputs are made with numpy from a seed and handed to both packages as the
same arrays (NHWC, fp32, on the CPU). 176^2 is the smallest even size that
five scales allow; 250^2 takes odd sizes at the lower scales (125, 63, 32),
where the pool pads the top/left with zeros. Tolerances: values atol 1e-5
(fp32 sums in another order), gradients atol 1e-6 (each pixel's gradient
is ~1/N of the loss's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import losses as jl
from tchvp_tpu.ops import msssim as jm
from tchvp_tpu_torch import losses as tl
from tchvp_tpu_torch.ops import msssim as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(shape, dtype=np.float32), 0.0, 1.0).astype(np.float32)
    return x, y


def _torch_value_and_grad(fn, x, y):
    xt = torch.from_numpy(x).requires_grad_()
    val = fn(xt, torch.from_numpy(y))
    val.backward()
    return val.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("size", [176, 250])
def test_ms_ssim_and_grad_match_jax(size):
    x, y = _pair((2, size, size, 3), seed=size)
    want, want_g = jax.value_and_grad(lambda a: jm.ms_ssim(a, jnp.asarray(y)))(jnp.asarray(x))
    got, got_g = _torch_value_and_grad(tm.ms_ssim, x, y)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=1e-6, rtol=0)


@pytest.mark.parametrize("size,data_range", [(176, 1.0), (250, 1.0), (176, 255.0)])
def test_mixed_loss_and_grad_match_jax(size, data_range):
    x, y = _pair((2, size, size, 3), seed=size + 1)

    def jfn(a):
        return jl.mixed_loss(a, jnp.asarray(y), 0.3, 0.7, data_range=data_range)

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x))
    got, got_g = _torch_value_and_grad(
        lambda a, b: tl.mixed_loss(a, b, 0.3, 0.7, data_range=data_range), x, y)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=1e-6, rtol=0)


def test_ssim_matches_jax_and_is_one_on_equal_images():
    x, y = _pair((2, 40, 36, 3), seed=9)
    np.testing.assert_allclose(tm.ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jm.ssim(jnp.asarray(x), jnp.asarray(y))), atol=1e-5, rtol=0)
    one = tm.ms_ssim(torch.from_numpy(x[:1, :36, :36].repeat(5, 1).repeat(5, 2)),
                     torch.from_numpy(x[:1, :36, :36].repeat(5, 1).repeat(5, 2)))
    assert abs(float(one) - 1.0) < 1e-6


@pytest.mark.parametrize("shape", [(1, 7, 9, 2), (2, 8, 6, 1), (1, 5, 5, 3)])
def test_avg_pool2_pads_top_left_like_jax(shape):
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    np.testing.assert_allclose(tm.avg_pool2(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.avg_pool2(jnp.asarray(x))), atol=1e-7, rtol=0)


def test_gaussian_window_matches_jax():
    np.testing.assert_array_equal(tm._gaussian_window(11, 1.5), jm._gaussian_window(11, 1.5))


def test_ms_ssim_rejects_small_images():
    with pytest.raises(ValueError, match="spatial dims > 160"):
        tm.ms_ssim(torch.zeros(1, 160, 200, 3), torch.zeros(1, 160, 200, 3))


@pytest.mark.parametrize("name", ["mse", "psnr", "dice_loss", "jaccard_score"])
def test_simple_losses_match_jax(name):
    x, y = _pair((2, 12, 10, 3), seed=4)
    if name == "jaccard_score":
        x, y = x > 0.5, y > 0.4
    want = getattr(jl, name)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(tl, name)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
