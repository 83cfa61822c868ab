"""The port's fused decoder tail against the JAX package's.

* ``fold_tail_params``: a JAX ``Decoder32K`` with non-trivial BN (running
  stats, scale and shift) and biases goes into the port through
  ``convert.from_flax``; every key of the port's fold equals JAX's, atol 1e-6
  (both compute the same fp32 products), image and mask heads.
* ``fused_tail_reference`` (the kernel's plain version) against JAX's on the
  same folded arrays, fp32: rtol/atol 1e-5 x max|want| (sums in another
  order over up to 1728 terms).
* ``fused_decoder_tail`` on the CPU (the plain version) against the JAX
  function with ``tile=16, interpret=True``, i.e. the Pallas kernel in
  interpret mode: one tile, 2x3 tiles, the mask head, and a 9x9 input
  (which the JAX function sends to its reference); rtol/atol 2e-4, the JAX
  tests' own.
* The slice: JAX ``Decoder32K.__call__`` against the port's ``body`` +
  ``fused_decoder_tail``, rtol/atol 5e-4 (the JAX full-pipeline test's).
* ``PixelShuffleUpconv`` against JAX's on flax parameters converted as
  ``convert.py`` converts a ConvTranspose kernel, and against
  ``nn.ConvTranspose2d`` with the same parameters, atol 1e-5.
* A CPU call launches nothing; the CUDA wrapper raises on what the kernel
  does not take before it builds or launches anything.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import fused_tail as jft
from tchvp_tpu.models import resnet_ae as jae
from tchvp_tpu.ops import blocks as jblocks
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.kernels import fused_tail as tft
from tchvp_tpu_torch.models import resnet_ae as tae
from tchvp_tpu_torch.ops import blocks as tblocks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _jax_decoder(output_type, seed):
    """A JAX Decoder32K (flax-default weights) whose BNs and biases are
    non-trivial, so the fold is really exercised: (module, variables)."""
    dec = jae.Decoder32K(output_type=output_type)
    variables = dec.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, 8)))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        if key == "mean":
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        if key == "var" or (key == "scale" and path[-2].key == "BatchNorm_0"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key == "bias":
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return np.asarray(x)

    return dec, {c: jax.tree_util.tree_map_with_path(draw, variables[c])
                 for c in ("params", "batch_stats")}


def _port_decoder(output_type, variables):
    state = convert.from_flax({c: {"decoder": variables[c]} for c in ("params", "batch_stats")})
    port = tae.Decoder32K(output_type=output_type)
    port.load_state_dict({k[len("decoder."):]: v for k, v in state.items()}, strict=True)
    return port.eval()


@pytest.fixture(scope="module", params=["image", "mask"])
def decoders(request):
    output_type = request.param
    dec, variables = _jax_decoder(output_type, seed=3 if output_type == "mask" else 0)
    return output_type, dec, variables, _port_decoder(output_type, variables)


def _torch_folded(folded):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in folded.items()}


def test_fold_matches_jax(decoders):
    _, _, variables, port = decoders
    want = jft.fold_tail_params(variables["params"], variables["batch_stats"])
    got = tft.fold_tail_params(port)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == torch.float32 and tuple(got[key].shape) == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=key)


def test_reference_matches_jax(decoders):
    output_type, _, variables, _ = decoders
    folded = jft.fold_tail_params(variables["params"], variables["batch_stats"])
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 384), dtype=np.float32)
    want = np.asarray(jft.fused_tail_reference(jnp.asarray(x), folded, output_type))
    got = tft.fused_tail_reference(torch.from_numpy(x), _torch_folded(folded), output_type)
    assert got.shape == (2, 12, 10, 1 if output_type == "mask" else 3)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-5)


def _random_folded(rng, cin=64, c1=32, c2=16, c3=8, c4=3):
    """Folded weights at small widths (the JAX kernel tests' own)."""
    def mk(*s):
        return rng.normal(0, 0.2, s).astype(np.float32)

    b_up = mk(c1)
    return dict(w_up=mk(cin, 4 * c1), b_up=b_up, b_up4=np.tile(b_up, 4), w0=mk(3, 3, c1, c2),
                b0=mk(c2), w1=mk(3, 3, c2, c3), b1=mk(c3), w2=mk(3, 3, c3, c4), b2=mk(c4))


@pytest.mark.parametrize("shape,output_type,seed", [
    ((2, 8, 8, 64), "image", 4),   # one 16x16 tile
    ((1, 16, 24, 64), "image", 5),  # 2x3 tiles: halos, borders, seams
    ((1, 8, 8, 64), "mask", 6),     # the sigmoid head
    ((1, 9, 9, 64), "image", 9),    # 2H not a tile multiple: JAX takes its reference
], ids=["one_tile", "tiles_2x3", "mask_head", "ragged_9x9"])
def test_fused_decoder_tail_matches_jax_interpret(shape, output_type, seed):
    rng = np.random.default_rng(seed)
    folded = _random_folded(rng, c4=1 if output_type == "mask" else 3)
    x = rng.standard_normal(shape, dtype=np.float32)
    want = jft.fused_decoder_tail(jnp.asarray(x), {k: jnp.asarray(v) for k, v in folded.items()},
                                  output_type=output_type, tile=16, interpret=True)
    got = tft.fused_decoder_tail(torch.from_numpy(x), _torch_folded(folded), output_type)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_decoder_body_and_fused_tail_match_jax_decoder(decoders):
    """The slice: body (cuDNN's convs on the card) + the fused tail against
    JAX's Decoder32K.__call__ in eval mode."""
    output_type, dec, variables, port = decoders
    lat = np.random.default_rng(8).standard_normal((2, 4, 5, 8), dtype=np.float32)
    want = np.asarray(dec.apply(variables, jnp.asarray(lat)))
    launches = tft.launches
    with torch.no_grad():
        body = port.body(torch.from_numpy(lat).permute(0, 3, 1, 2))  # (2, 384, 8, 10)
        got = tft.fused_decoder_tail(body.permute(0, 2, 3, 1), tft.fold_tail_params(port), output_type)
    assert got.shape == want.shape == (2, 16, 20, 1 if output_type == "mask" else 3)
    assert tft.launches == launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_cpu_call_launches_nothing():
    rng = np.random.default_rng(10)
    folded = _torch_folded(_random_folded(rng))
    before = tft.launches
    tft.fused_decoder_tail(torch.from_numpy(rng.standard_normal((1, 3, 4, 64), dtype=np.float32)), folded)
    assert tft.launches == before == 0


def _full_width_folded(c4=3):
    return _torch_folded(_random_folded(np.random.default_rng(11), cin=384, c1=192, c2=64, c3=8, c4=c4))


@pytest.mark.parametrize("case", ["dtype", "channels", "empty", "widths", "head", "output_type", "cpu"])
def test_cuda_wrapper_raises_before_launching(case):
    x = torch.zeros(1, 2, 2, 384)
    folded = _full_width_folded()
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "channels":
        x, err = torch.zeros(1, 2, 2, 256), ValueError
    elif case == "empty":
        x, err = torch.zeros(1, 0, 2, 384), ValueError
    elif case == "widths":
        folded, err = _torch_folded(_random_folded(np.random.default_rng(12), cin=384)), ValueError
    elif case == "head":
        folded, err = _full_width_folded(c4=2), ValueError
    else:  # "output_type", and "cpu": a valid input that lies on the CPU
        err = ValueError
    output_type = "edges" if case == "output_type" else "image"
    launches = tft.launches
    with pytest.raises(err):
        tft.fused_tail_cuda(x, folded, output_type)
    assert tft.launches == launches


def test_pixel_shuffle_upconv_matches_jax_and_conv_transpose():
    x = np.random.default_rng(13).standard_normal((2, 5, 7, 6), dtype=np.float32)
    jmod = jblocks.PixelShuffleUpconv(4)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"kernel": np.asarray(variables["params"]["kernel"]),
                            "bias": np.random.default_rng(14).normal(0, 0.2, 4).astype(np.float32)}}
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))  # (2, 10, 14, 4)
    ref = np.asarray(fnn.ConvTranspose(4, (2, 2), strides=(2, 2)).apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(want, ref, atol=1e-5)

    port = tblocks.PixelShuffleUpconv(6, 4)
    kernel = variables["params"]["kernel"]
    state = {"weight": torch.from_numpy(np.ascontiguousarray(np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1)))),
             "bias": torch.from_numpy(variables["params"]["bias"])}
    port.load_state_dict(state, strict=True)
    conv_t = torch.nn.ConvTranspose2d(6, 4, 2, stride=2)
    conv_t.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt)
        np.testing.assert_allclose(got.numpy(), conv_t(xt).numpy(), atol=1e-5)
    assert got.shape == (2, 4, 10, 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_fold_uses_the_polyphase_matrix_of_pixel_shuffle_upconv():
    """fold_tail_params' w_up is PixelShuffleUpconv's matrix of the BN-scaled
    ConvTranspose weight: the up-projection of the fold equals the module."""
    _, variables = _jax_decoder("image", seed=15)
    port = _port_decoder("image", variables)
    folded = tft.fold_tail_params(port)
    up = tblocks.PixelShuffleUpconv(384, 192)
    up.load_state_dict(port.upconvs[1].state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(16).standard_normal((1, 384, 3, 2), dtype=np.float32))
    with torch.no_grad():
        want = port.up_bns[1](up(x)).permute(0, 2, 3, 1)
    y = x.permute(0, 2, 3, 1) @ folded["w_up"]
    got = y.reshape(1, 3, 2, 2, 2, 192).permute(0, 1, 3, 2, 4, 5).reshape(1, 6, 4, 192) + folded["b_up"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-5)
