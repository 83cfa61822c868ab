"""The port's flagship path against the JAX package, module by module.

The JAX model is initialised from ``PRNGKey(0)``; every BatchNorm's running
mean and variance is replaced with seeded non-trivial values so that eval
BN is not the identity; ``convert.from_flax`` carries the weights across.
Config: ``flagship_video_config(image_size=32, num_heads=8,
hidden_dim=32)`` (D 64, Dh 8). The JAX temporal transformer on
``attn_impl="flash"`` runs its Pallas kernel in interpret mode, the port's
runs the kernel's plain version. fp32 on the CPU throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.models import resnet_ae as jae
from tchvp_tpu.models import transformer as jtr
from tchvp_tpu.models import video as jvideo
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.models import resnet_ae as tae
from tchvp_tpu_torch.models import transformer as ttr
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import dispatch_trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 32


def _jax_variables(output_type="image", attn_impl="flash"):
    jc = dataclasses.replace(
        jcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32, attn_impl=attn_impl),
        output_type=output_type,
    )
    model = jvideo.VideoHybridNet(config=jc)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(0.0, 0.2, x.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, jc, {"params": params, "batch_stats": stats}


def _port_model(jc, variables):
    tc = dataclasses.replace(
        tcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32,
                                   attn_impl=jc.temporal.attn_impl),
        output_type=jc.output_type,
    )
    model = tvideo.VideoHybridNet(tc, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def image_models():
    jmodel, jc, variables = _jax_variables()
    return jmodel, variables, _port_model(jc, variables)


def _sub(variables, name):
    return {c: variables[c][name] for c in ("params", "batch_stats") if name in variables[c]}


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_from_flax_uses_every_leaf_exactly_once(image_models):
    _, variables, port = image_models
    n_leaves = sum(len(jax.tree_util.tree_leaves(variables[c])) for c in ("params", "batch_stats"))
    n_bn = sum(1 for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert len(convert.from_flax(variables)) == n_leaves + n_bn  # + num_batches_tracked
    assert len(port.state_dict()) == n_leaves + n_bn


def test_encoder_matches_jax(image_models):
    jmodel, variables, port = image_models
    frames = np.random.default_rng(3).random((2, SIZE, SIZE, 3), dtype=np.float32)
    want = jae.Encoder32K(config=jmodel.config.encoder).apply(
        _sub(variables, "encoder"), jnp.asarray(frames))
    with torch.no_grad():
        got = port.encoder(torch.from_numpy(frames).permute(0, 3, 1, 2))
    assert got.shape == (2, 8, SIZE // 4, SIZE // 4)
    _close(got.permute(0, 2, 3, 1), want, 1e-4, 1e-4)


def test_decoder_matches_jax(image_models):
    _, variables, port = image_models
    latent = np.random.default_rng(4).random((2, SIZE // 4, SIZE // 4, 8), dtype=np.float32)
    dec = jae.Decoder32K(output_type="image")
    dvars = _sub(variables, "decoder")
    want_body = dec.apply(dvars, jnp.asarray(latent), method=jae.Decoder32K.body)
    want = dec.apply(dvars, jnp.asarray(latent))
    with torch.no_grad():
        x = torch.from_numpy(latent).permute(0, 3, 1, 2)
        got_body = port.decoder.body(x)
        got = port.decoder(x)
    _close(got_body.permute(0, 2, 3, 1), want_body, 1e-4, 1e-4)
    _close(got.permute(0, 2, 3, 1), want, 1e-4, 1e-4)


def test_latent_token_reshapes_keep_the_jax_element_order():
    latent = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)  # NHWC
    want = jae.latent_to_tokens(jnp.asarray(latent))
    got = tae.latent_to_tokens(torch.from_numpy(latent).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tae.tokens_to_latent(got, (3, 4)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(back.numpy(), latent)


def test_transformer_flash_matches_jax_interpret(image_models):
    jmodel, variables, port = image_models
    tokens = np.random.default_rng(5).standard_normal((1, 16, 64), dtype=np.float32)
    want = jtr.TransformerEncoder(config=jmodel.config.temporal).apply(
        _sub(variables, "temporal"), jnp.asarray(tokens))
    with dispatch_trace.capture() as seen, torch.no_grad():
        got = port.temporal(torch.from_numpy(tokens))
    assert {"flash_mha", "flash_mha_plain"} <= seen and "sdpa_xla" not in seen
    _close(got, want, 1e-5, 0)


def test_sinusoidal_posenc_matches_jax():
    np.testing.assert_array_equal(tvideo.sinusoidal_posenc(16, 64),
                                  np.asarray(jvideo.sinusoidal_posenc(16, 64)))
    np.testing.assert_array_equal(tvideo.sinusoidal_posenc(5, 7),
                                  np.asarray(jvideo.sinusoidal_posenc(5, 7)))


@pytest.mark.parametrize("src,dst", [(48, 32), (37, 16), (20, 32), (32, 32)])
def test_preprocess_clip_matches_jax(src, dst):
    raw = np.random.default_rng(src).integers(0, 256, (1, 2, src, src, 3), dtype=np.uint8)
    want = jpipe.preprocess_clip(jnp.asarray(raw), dst)
    got = tpipe.preprocess_clip(torch.from_numpy(raw), dst)
    assert got.dtype == torch.float32 and got.shape == (1, 2, dst, dst, 3)
    _close(got, want, 1e-6, 0)


def _whole_model(jmodel, variables, port):
    raw = np.random.default_rng(6).integers(0, 256, (1, 2, 48, 48, 3), dtype=np.uint8)
    clip_j = jpipe.preprocess_clip(jnp.asarray(raw), SIZE)
    tokens_j, recon_j = jmodel.apply(variables, clip_j)
    with dispatch_trace.capture() as seen, torch.no_grad():
        tokens_t, recon_t = port(tpipe.preprocess_clip(torch.from_numpy(raw), SIZE))
    return seen, (tokens_t, recon_t), (tokens_j, recon_j)


def test_video_hybrid_net_matches_jax(image_models):
    seen, (tokens_t, recon_t), (tokens_j, recon_j) = _whole_model(*image_models)
    assert "flash_mha_plain" in seen
    assert tokens_t.shape == (1, 16, (SIZE // 4) ** 2)
    assert recon_t.shape == (1, 2, SIZE, SIZE, 3)
    _close(tokens_t, tokens_j, 1e-4, 1e-4)
    _close(recon_t, recon_j, 1e-4, 1e-4)


def test_video_hybrid_net_mask_head_matches_jax():
    jmodel, jc, variables = _jax_variables(output_type="mask", attn_impl="xla")
    port = _port_model(jc, variables)
    seen, (tokens_t, recon_t), (tokens_j, recon_j) = _whole_model(jmodel, variables, port)
    assert seen == {"sdpa_xla"}
    assert recon_t.shape == (1, 2, SIZE, SIZE, 1)
    assert float(recon_t.min()) >= 0.0 and float(recon_t.max()) <= 1.0
    _close(tokens_t, tokens_j, 1e-4, 1e-4)
    _close(recon_t, recon_j, 1e-4, 1e-4)


def test_train_mode_dropout_needs_a_generator():
    cfg = tcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32)
    port = tvideo.VideoHybridNet(cfg, device="cpu").train()
    with pytest.raises(ValueError, match="Generator"), torch.no_grad():
        port(torch.zeros(1, 2, SIZE, SIZE, 3))


def test_moe_is_not_ported():
    """Ported since (item 11b; tests/test_torch_moe.py holds it to JAX):
    num_experts >= 2 builds the routed pool in place of the dense FFNs."""
    enc = ttr.TransformerEncoder(tcfg.TransformerConfig(input_dim=16, num_heads=2, num_experts=2))
    assert all(hasattr(layer, "moe") and not hasattr(layer, "ffn1") for layer in enc.layers)
