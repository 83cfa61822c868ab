"""Train-mode numerics of the port against the JAX package: the bf16
``scale_out`` constant and BatchNorm's train mode.

* ``scale_out``: JAX multiplies by ``jnp.asarray(math.sqrt(0.5), x.dtype)``,
  a constant rounded to bf16 (0.70703125) before the multiply; the port must
  give the same bits on bf16 inputs.
* BatchNorm: one train-mode forward of ``Encoder32K`` at 32^2 against flax
  with ``mutable=["batch_stats"]``. flax normalises with the biased batch
  variance and moves the running variance with the biased one too; torch's
  BatchNorm2d would move it with the unbiased one. fp32. The updated stats
  agree to atol 1e-5. The output is held to atol 2e-4: XLA's fp32 batch
  statistics on the CPU are the less exact side (the stem's normalised
  output is 2.7e-5 from a float64 recompute in flax, 6e-7 in the port), and
  28 train-mode BatchNorms carry that to 1.6e-4 at the latent. One
  BatchNorm on inputs of small mean is held to flax at atol 1e-5, output
  and stats, and the port's own normalisation to float64 at atol 1e-6.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.models import resnet_ae as jae
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models import resnet_ae as tae
from tchvp_tpu_torch.models import transformer as ttr
from tchvp_tpu_torch.ops import blocks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 32


def _bf16_bits(x):
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_out_rounds_the_constant_like_jax_bf16(seed):
    x = np.random.default_rng(seed).standard_normal(4096, dtype=np.float32) * 8
    xb = x.astype(ml_dtypes.bfloat16)
    want = jnp.asarray(xb) * jnp.asarray(math.sqrt(0.5), jnp.bfloat16)
    got = ttr.scale_out(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), _bf16_bits(want))
    # The fp32 constant would differ in at least one element.
    unrounded = (torch.from_numpy(x).to(torch.bfloat16).float() * math.sqrt(0.5)).to(torch.bfloat16)
    assert not torch.equal(unrounded, got)


def test_scale_out_fp32_matches_jax():
    x = np.random.default_rng(2).standard_normal(512, dtype=np.float32)
    want = jnp.asarray(x) * jnp.asarray(math.sqrt(0.5), jnp.float32)
    np.testing.assert_array_equal(ttr.scale_out(torch.from_numpy(x)).numpy(), np.asarray(want))


def _encoders(dropout_rate=0.0):
    jc = dataclasses.replace(jcfg.ResNetAEConfig(token_latent=True), dropout_rate=dropout_rate)
    jenc = jae.Encoder32K(config=jc)
    frames = np.random.default_rng(3).random((4, SIZE, SIZE, 3), dtype=np.float32)
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(frames))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(0.0, 0.2, x.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tenc = tae.Encoder32K(dataclasses.replace(tcfg.ResNetAEConfig(token_latent=True),
                                              dropout_rate=dropout_rate))
    sd = convert.from_flax({c: {"encoder": variables[c]} for c in ("params", "batch_stats")})
    tenc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()}, strict=True)
    return jenc, variables, tenc, frames


def _torch_stats(tenc):
    sd = tenc.state_dict()
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_encoder_train_mode_output_and_stats_match_flax():
    jenc, variables, tenc, frames = _encoders()
    want, mutated = jenc.apply(variables, jnp.asarray(frames), train=True, mutable=["batch_stats"])
    got = tenc.train()(torch.from_numpy(frames).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=2e-4, rtol=0)
    want_sd = convert.from_flax({"batch_stats": {"encoder": mutated["batch_stats"]}})
    got_stats = _torch_stats(tenc)
    assert len(got_stats) == 2 * sum(isinstance(m, blocks.BatchNorm) for m in tenc.modules()) == 56
    for key, val in got_stats.items():
        np.testing.assert_allclose(val.numpy(), want_sd[f"encoder.{key}"].numpy(), atol=1e-5, rtol=0,
                                   err_msg=key)


def test_train_mode_batchnorm_matches_float64():
    x = np.random.default_rng(6).standard_normal((4, 5, 16, 16)).astype(np.float32) * 2 + 3
    bn = blocks.BatchNorm(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-1, 1, 5))
        got = bn(torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    mean, var = x64.mean((0, 2, 3), keepdims=True), x64.var((0, 2, 3), keepdims=True)
    want = ((x64 - mean) / np.sqrt(var + 1e-5) * np.linspace(0.5, 1.5, 5).reshape(1, 5, 1, 1)
            + np.linspace(-1, 1, 5).reshape(1, 5, 1, 1))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(4, 16, 16, 6), (2, 5, 7, 3)])
def test_one_train_mode_batchnorm_matches_flax(shape):
    """One layer, inputs whose mean is small against their spread (where
    flax's E[x^2] - E[x]^2 loses nothing that shows): output and updated
    stats atol 1e-5 against ``tchvp_tpu.ops.blocks.BatchNorm``."""
    from tchvp_tpu.ops import blocks as jblocks

    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)  # NHWC
    c = shape[-1]
    scale, bias = np.linspace(0.5, 1.5, c, dtype=np.float32), np.linspace(-1, 1, c, dtype=np.float32)
    mean0, var0 = rng.normal(0, 0.2, c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    want, mutated = jblocks.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = blocks.BatchNorm(c).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5, rtol=0)


def test_batchnorm_moves_running_var_with_the_biased_variance():
    bn = blocks.BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 4, 5), dtype=np.float32))
    bn(x)
    biased = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)), rtol=0, atol=1e-6)


def test_frozen_batch_stats_leaves_the_running_stats_alone():
    bn = blocks.BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 4, 5), dtype=np.float32))
    with blocks.frozen_batch_stats(bn):
        out = bn(x)
    torch.testing.assert_close(bn.running_mean, torch.zeros(3), rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, torch.ones(3), rtol=0, atol=0)
    assert not bn.freeze_stats
    torch.testing.assert_close(out, bn(x), rtol=0, atol=0)  # the output does not depend on it


def test_dropout2d_uses_a_predrawn_mask():
    _, _, tenc, frames = _encoders(dropout_rate=0.5)
    x = torch.from_numpy(frames).permute(0, 3, 1, 2)
    keep = tenc.draw_dropout(4, torch.Generator().manual_seed(0), x.device)
    assert keep.shape == (4, 8, 1, 1) and keep.dtype == torch.bool
    with blocks.frozen_batch_stats(tenc):
        a = tenc.train()(x, keep=keep)
        b = tenc(x, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(((a == 0).all(dim=(2, 3)) == ~keep[:, :, 0, 0]).all())
