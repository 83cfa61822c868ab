"""The port's streaming path and over-memory batches against the JAX package.

* Tiling (``pad_frames`` in edge mode, ``tile_frames``, ``untile_frames``):
  equal to JAX's, element for element, in float32 and uint8.
* ``microbatched_infer``: equal to one whole-batch eval forward of the
  port, and to JAX's ``microbatched_infer`` at atol/rtol 1e-4.
* ``stream_clip`` and ``stream_video`` against JAX's at a tiny size (the
  model of ``tests/test_streaming.py``: a (1, 1)-layer encoder, D 16, one
  temporal layer), with no carried context and with some, tiled and not:
  atol/rtol 1e-4, fp32 on the CPU. Weights are seeded numpy values of the
  flax shapes, carried across by ``convert.from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.models import streaming as jstream
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.ops import tiling as jtiling
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models import streaming as tstream
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import tiling as ttiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 16


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# --------------------------------------------------------------------- tiling


@pytest.mark.parametrize("shape,multiple,dtype", [
    ((2, 3, 8, 12, 3), 4, np.float32),   # already whole: no padding
    ((1, 2, 5, 6, 1), 4, np.float32),
    ((1, 2, 30, 44, 3), 16, np.float32),
    ((2, 1, 13, 7, 3), 8, np.uint8),
])
def test_pad_frames_matches_jax(shape, multiple, dtype):
    clip = (np.random.default_rng(0).uniform(size=shape) * 255).astype(dtype)
    want, want_hw = jtiling.pad_frames(jnp.asarray(clip), multiple)
    got, got_hw = ttiling.pad_frames(torch.from_numpy(clip), multiple)
    assert got_hw == want_hw == shape[2:4]
    assert got.dtype == torch.from_numpy(clip).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,tile,dtype", [
    ((2, 3, 8, 12, 3), 4, np.float32),
    ((1, 2, 32, 48, 3), 16, np.uint8),
])
def test_tile_and_untile_match_jax(shape, tile, dtype):
    clip = (np.random.default_rng(1).uniform(size=shape) * 255).astype(dtype)
    want, want_grid = jtiling.tile_frames(jnp.asarray(clip), tile)
    got, grid = ttiling.tile_frames(torch.from_numpy(clip), tile)
    assert grid == want_grid
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    crop = (shape[2] - 3, shape[3] - 1)
    np.testing.assert_array_equal(ttiling.untile_frames(got, grid, crop).numpy(),
                                  np.asarray(jtiling.untile_frames(want, want_grid, crop)))
    np.testing.assert_array_equal(ttiling.untile_frames(got, grid).numpy(), clip)


def test_tile_frames_needs_whole_tiles():
    with pytest.raises(ValueError, match="not a multiple of tile"):
        ttiling.tile_frames(torch.zeros(1, 1, 10, 8, 3), 4)


# ------------------------------------------------------------------ streaming


def _tiny_configs(attn_impl="xla"):
    kw = dict(input_dim=(SIZE // 4) ** 2, hidden_dim=16, num_layers=1, num_heads=4,
              attn_impl=attn_impl)
    jc = jcfg.VideoModelConfig(encoder=jcfg.ResNetAEConfig(layers=(1, 1), token_latent=True),
                               temporal=jcfg.TransformerConfig(**kw))
    tc = tcfg.VideoModelConfig(encoder=tcfg.ResNetAEConfig(layers=(1, 1), token_latent=True),
                               temporal=tcfg.TransformerConfig(**kw))
    return jc, tc


@pytest.fixture(scope="module")
def models():
    """The JAX model, its seeded numpy variables (only the shapes come from
    flax: ``eval_shape``) and the port's model with the same weights."""
    jc, tc = _tiny_configs()
    jmodel = jvideo.VideoHybridNet(config=jc)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
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
    port = tvideo.VideoHybridNet(tc, device="cpu")
    port.load_state_dict(convert.from_flax(variables), strict=True)
    return jmodel, variables, port


def test_microbatched_infer_equals_the_whole_batch_and_jax(models):
    jmodel, variables, port = models
    clip = _uniform((4, 2, SIZE, SIZE, 3), seed=1)
    port.train()  # the call runs in eval mode and gives the flag back
    got = tstream.microbatched_infer(port, torch.from_numpy(clip), microbatch=2)
    assert port.training
    with torch.no_grad():
        _, whole = port.eval()(torch.from_numpy(clip))
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=0)
    _close(got, jstream.microbatched_infer(jmodel, variables, jnp.asarray(clip), 2))
    with pytest.raises(ValueError, match="microbatch"):
        tstream.microbatched_infer(port, torch.from_numpy(clip), microbatch=3)


@pytest.mark.parametrize("ctx_frames", [0, 2])
def test_stream_clip_matches_jax(models, ctx_frames):
    jmodel, variables, port = models
    clip = _uniform((1, 8, SIZE, SIZE, 3), seed=2)
    want = jstream.stream_clip(jmodel, variables, jnp.asarray(clip), chunk_len=4, ctx_frames=ctx_frames)
    got = tstream.stream_clip(port, torch.from_numpy(clip), chunk_len=4, ctx_frames=ctx_frames)
    assert got.shape == (1, 8, SIZE, SIZE, 3)
    _close(got, want)


def test_one_chunk_without_context_is_the_whole_forward(models):
    _, _, port = models
    clip = torch.from_numpy(_uniform((2, 4, SIZE, SIZE, 3), seed=3))
    got = tstream.stream_clip(port, clip, chunk_len=4, ctx_frames=0)
    with torch.no_grad():
        _, want = port.eval()(clip)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tstream.stream_clip(port, clip, chunk_len=3)
    with pytest.raises(ValueError, match="ctx_frames"):
        tstream.stream_clip(port, clip, chunk_len=2, ctx_frames=3)


@pytest.mark.parametrize("shape,cfg", [
    ((1, 4, 30, 44, 3), tstream.StreamingConfig(tile=16, chunk_len=2, ctx_frames=1)),  # tiled
    ((2, 4, 14, 15, 3), tstream.StreamingConfig(tile=16, chunk_len=2, ctx_frames=0)),  # untiled
])
def test_stream_video_matches_jax(models, shape, cfg):
    jmodel, variables, port = models
    clip = _uniform(shape, seed=4)
    jcfg_stream = jstream.StreamingConfig(tile=cfg.tile, chunk_len=cfg.chunk_len, ctx_frames=cfg.ctx_frames)
    want = jstream.stream_video(jmodel, variables, jnp.asarray(clip), jcfg_stream)
    got = tstream.make_streamer(port, cfg)(torch.from_numpy(clip))
    assert got.shape == shape
    _close(got, want)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "item 11"),
    (dict(int8_engine=object()), "item 10"),
])
def test_make_streamer_options_not_ported_raise(models, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        tstream.make_streamer(models[2], **kwargs)


def test_streaming_config_defaults_match_jax():
    assert tstream.StreamingConfig() == tstream.StreamingConfig(
        **{f: getattr(jstream.StreamingConfig(), f) for f in ("tile", "chunk_len", "ctx_frames")})
