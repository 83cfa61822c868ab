"""The port's serving artifacts (``tchvp_tpu_torch/infer/export.py``) on the
CPU.

* A flagship artifact (32^2, weights from a seeded flax tree through
  ``convert.from_flax``): the loaded program bit-equal to the live model at
  batches 1, 2 and 5 from one artifact (``Dim("b", min=1)``, example batch
  2); ``meta.json`` carries JAX's record; ``--static-batch`` refuses other
  sizes; a wrong dtype is a TypeError, a wrong frame size a ValueError; an
  older version, a JAX package artifact (``fn.jaxexp``, made here by the
  JAX package's own ``export_serving``), a platform other than the
  artifact's, and a CUDA artifact without a card are refused.
* An image model (FCT, tuple-free) and the AutoEncoder (its last output)
  round trip; an int8 engine's artifact equals the live engine bit for
  bit; the streaming carry step, chunk by chunk, equals ``stream_clip``
  (and the int8 streaming step the engine's ``stream_clip``).
* On a card (``chip_smoke.py`` phase 20) the exported graphs keep their
  ``tchvp.flash_fwd`` nodes; here "auto" attention is the plain core, so
  the flagship is exported with ``attn_impl="flash"``, whose CPU
  registration is the plain version, and its graph holds 2 nodes.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.infer import export as jexport
from tchvp_tpu.models import video as jvideo
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.infer import export as texport
from tchvp_tpu_torch.infer import quant as tq
from tchvp_tpu_torch.models import autoencoder as tae
from tchvp_tpu_torch.models import fct as tfct
from tchvp_tpu_torch.models import streaming as tstream
from tchvp_tpu_torch.models import video as tvideo
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE, CLIP_LEN = 32, 4
VIDEO_KW = dict(image_size=SIZE, num_heads=8, hidden_dim=32, num_layers=1, attn_impl="flash")


def _clips(b, seed=0, t=CLIP_LEN):
    return np.random.default_rng(seed).integers(0, 256, (b, t, SIZE, SIZE, 3), dtype=np.uint8)


def _flagship():
    jmodel = jvideo.VideoHybridNet(config=jcfg.flagship_video_config(**VIDEO_KW))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0.0, 0.1 if name == "bias" else 0.2, s.shape)

    variables = {c: jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes[c])
                 for c in ("params", "batch_stats")}
    model = tvideo.VideoHybridNet(tcfg.flagship_video_config(**VIDEO_KW), device="cpu")
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model.eval()


def _live(model, raw):
    with torch.no_grad():
        return model(tpipe.preprocess_clip(torch.from_numpy(raw), SIZE))[1]


@pytest.fixture(scope="module")
def flagship():
    return _flagship()


@pytest.fixture(scope="module")
def artifact(flagship, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "m.tchvp")
    exported, record = texport.export_video_model(flagship, clip_len=CLIP_LEN, image_size=SIZE)
    texport.save_artifact(path, exported, record, meta={"model": "hybrid", "image_size": SIZE})
    return path, exported


def test_round_trip_is_bit_exact_at_several_batches(flagship, artifact):
    path, exported = artifact
    targets = [n.target for n in exported.graph.nodes]
    assert targets.count(torch.ops.tchvp.flash_fwd.default) == 1  # one temporal layer
    m = texport.load_artifact(path)
    assert m.platforms == ("cpu",) and m.meta["meta"]["model"] == "hybrid"
    for b, seed in ((2, 0), (5, 1), (1, 2)):
        raw = _clips(b, seed)
        got = m(raw)
        assert torch.equal(got, _live(flagship, raw)), f"batch {b}"
    assert m.example_input(3).shape == (3, CLIP_LEN, SIZE, SIZE, 3)


def test_meta_record_is_jaxs(artifact):
    path, _ = artifact
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        assert "program.pt2" in z.namelist()
    assert set(meta) >= {"artifact_version", "platforms", "batch_aval", "out_avals", "meta"}
    assert meta["platforms"] == ["cpu"] and meta["artifact_version"] == texport.ARTIFACT_VERSION
    assert meta["batch_aval"] == f"uint8[b,{CLIP_LEN},{SIZE},{SIZE},3]"
    assert meta["out_avals"] == [f"float32[b,{CLIP_LEN},{SIZE},{SIZE},3]"]


def test_wrong_inputs_are_refused(artifact):
    m = texport.load_artifact(artifact[0])
    with pytest.raises(TypeError, match="dtype"):
        m(_clips(2).astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        m(np.zeros((2, CLIP_LEN, SIZE + 4, SIZE, 3), np.uint8))
    with pytest.raises(ValueError, match="empty"):
        m(np.zeros((0, CLIP_LEN, SIZE, SIZE, 3), np.uint8))


def test_static_batch_rejects_other_sizes(flagship, tmp_path):
    exported, record = texport.export_video_model(flagship, clip_len=CLIP_LEN, image_size=SIZE,
                                                  symbolic_batch=False)
    path = str(tmp_path / "static.tchvp")
    texport.save_artifact(path, exported, record)
    m = texport.load_artifact(path)
    raw = _clips(1, 3)
    assert torch.equal(m(raw), _live(flagship, raw))  # the traced size works
    with pytest.raises(ValueError):
        m(_clips(2))


def test_version_mismatch_rejected(artifact, tmp_path, monkeypatch):
    path = str(tmp_path / "v.tchvp")
    monkeypatch.setattr(texport, "ARTIFACT_VERSION", 99)
    texport.save_artifact(path, artifact[1], {"platforms": ["cpu"], "batch_aval": "uint8[b]",
                                             "in_avals": ["uint8[b]"], "out_avals": []})
    monkeypatch.undo()
    with pytest.raises(ValueError, match="artifact version"):
        texport.load_artifact(path)


def test_a_jax_artifact_is_refused(tmp_path):
    exported, weights = jexport.export_serving(lambda w, x: x * w["s"], {"s": jnp.float32(2.0)},
                                               jnp.zeros((2, 4), jnp.float32))
    path = str(tmp_path / "jax.tchvp")
    jexport.save_artifact(path, exported, weights)
    with pytest.raises(ValueError, match="JAX package artifact.*re-export"):
        texport.load_artifact(path)


def test_platforms_are_held(artifact, tmp_path):
    with pytest.raises(ValueError, match="exported for"):
        texport.load_artifact(artifact[0], device="cuda")
    path = str(tmp_path / "cuda.tchvp")
    with zipfile.ZipFile(artifact[0]) as src, zipfile.ZipFile(path, "w") as dst:
        meta = json.loads(src.read("meta.json"))
        meta["platforms"] = ["cuda"]
        dst.writestr("meta.json", json.dumps(meta))
        dst.writestr("program.pt2", src.read("program.pt2"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texport.load_artifact(path)
    with pytest.raises(ValueError, match="platforms"):
        texport.export_video_model(_flagship(), clip_len=CLIP_LEN, image_size=SIZE, platforms=("cuda",))


@pytest.mark.parametrize("family", ["fct", "ae"])
def test_image_model_round_trip(family, tmp_path):
    g = torch.Generator().manual_seed(4)
    if family == "fct":
        model = tfct.FCT(tcfg.FCTConfig(filters=(4, 8, 8, 8, 8, 8, 8, 8, 4), attn_impl="flash"), device="cpu",
                         generator=g)
    else:
        model = tae.AutoEncoder(device="cpu", generator=g)
    model.eval()
    exported, record = texport.export_image_model(model, image_size=SIZE)
    path = str(tmp_path / f"{family}.tchvp")
    texport.save_artifact(path, exported, record)
    m = texport.load_artifact(path)
    images = np.random.default_rng(5).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    with torch.no_grad():
        out = model(tpipe.preprocess_images(torch.from_numpy(images), SIZE))
    want = out[-1] if isinstance(out, tuple) else out
    assert torch.equal(m(images), want)


def test_int8_artifact_equals_the_live_engine(flagship, tmp_path):
    raw = _clips(2, 7)
    clip = tpipe.preprocess_clip(torch.from_numpy(raw), SIZE)
    engine = tq.Int8Engine(flagship, quantize_dense=True).calibrate([clip])
    exported, record = texport.export_int8_video_model(engine, clip_len=CLIP_LEN, image_size=SIZE)
    path = str(tmp_path / "int8.tchvp")
    texport.save_artifact(path, exported, record, meta={"int8": True})
    m = texport.load_artifact(path)
    for b, seed in ((2, 7), (3, 8)):
        raw = _clips(b, seed)
        want = engine.apply(engine.qparams, tpipe.preprocess_clip(torch.from_numpy(raw), SIZE))[1]
        assert torch.equal(m(raw), want)


@pytest.mark.parametrize("int8", [False, True])
def test_streaming_step_equals_stream_clip(flagship, tmp_path, int8):
    chunk, ctx = 2, 1
    raw = _clips(1, 9, t=3 * chunk)
    clip = tpipe.preprocess_clip(torch.from_numpy(raw), SIZE)
    geometry = dict(chunk_len=chunk, ctx_frames=ctx, image_size=SIZE, batch=1)
    if int8:
        engine = tq.Int8Engine(flagship).calibrate([clip])
        exported, record = texport.export_int8_streaming_step(engine, **geometry)
        with engine.intercepting(engine.qparams):
            want = tstream.stream_clip(flagship, clip, chunk, ctx)
    else:
        exported, record = texport.export_streaming_step(flagship, **geometry)
        want = tstream.stream_clip(flagship, clip, chunk, ctx)
    path = str(tmp_path / "s.tchvp")
    texport.save_artifact(path, exported, record, meta=texport.streaming_meta(
        tokens_per_frame=flagship.config.tokens_per_frame, **geometry))
    m = texport.load_artifact(path)
    assert isinstance(m, texport.StreamingServingModel)
    carry = m.init_carry()
    assert tuple(carry.shape) == (1, ctx * 8, (SIZE // 4) ** 2)
    parts = []
    for start in range(0, raw.shape[1], chunk):
        carry, recon = m.step(carry, raw[:, start:start + chunk])
        parts.append(recon)
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), want.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match="step"):
        m(raw)
