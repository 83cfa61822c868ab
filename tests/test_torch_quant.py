"""The port's int8 engine (``tchvp_tpu_torch/infer/quant.py``) against the
JAX package's (``tchvp_tpu/infer/quant.py``) on the CPU.

* The quantized layer set: the names the port's engine calibrates equal
  JAX's ``engine.scales`` keys carried through ``convert``'s name map, for
  the flagship, FCT, UNet and the AutoEncoder, conv-only, with
  ``quantize_dense`` and with an exclusion; no ``ConvTranspose2d`` or
  ``PixelShuffleUpconv`` among them. JAX's keys come from its interceptor
  traced under ``jax.eval_shape`` (the keys of an eager calibration, at no
  compile). The flagship's counts are chip_smoke.py's INT8_CONV_LAYERS
  and INT8_DENSE_LAYERS.
* One layer on the same input x, each case from a numpy seed: the scale
  equal, ``w_i8`` and the int32 accumulators bit-equal to JAX's
  (``lax.conv_general_dilated``/``dot_general`` with int32 accumulation),
  the output within 1 fp32 ulp: SAME, VALID, int padding, stride 2 (SAME's
  asymmetric pad), dilation 2 and 3, depthwise, grouped, and Dense (10
  rows: the card's int8 GEMM's M > 16 padding).
* The whole flagship (fp32, 32^2, weights through ``convert.from_flax``)
  calibrated by each engine on the same clip: scales within 1e-5 (most
  differ by an ulp: the fp forwards differ by ~4e-7), every ``w_i8``
  bit-equal. With JAX's scales the port's int8 reconstruction is within
  1e-3 x max|ref| of JAX's (measured ~1e-7) and its ``psnr_vs`` within
  0.1 dB. JAX runs eagerly here, as its engine calibrates: under
  ``jax.jit`` XLA multiplies by 1/s_x where the eager op divides, and
  JAX's jitted int8 flagship differs from its eager one by 2 % of
  max|ref|. So do the two packages' own calibrations: an ulp of a scale
  flips round(x / s_x) at a .5 edge, and the flips cascade (measured 2.2 %
  of max|ref|, PSNR 0.05-0.16 dB apart over three seeds); held to 0.5 dB.
* Port only: calibration keeps the max over calls; ``make_streamer`` with
  the engine equals ``stream_video`` under ``intercepting``; an exported
  int8 program keeps ``tchvp.int8_conv`` nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tchvp_tpu import config as jcfg
from tchvp_tpu.infer import quant as jq
from tchvp_tpu.models import autoencoder as jae
from tchvp_tpu.models import fct as jfct
from tchvp_tpu.models import unet as junet
from tchvp_tpu.models import video as jvideo
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.infer import quant as tq
from tchvp_tpu_torch.models import autoencoder as tae
from tchvp_tpu_torch.models import fct as tfct
from tchvp_tpu_torch.models import streaming as tstream
from tchvp_tpu_torch.models import unet as tunet
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops.blocks import ConvTranspose2d, Dense, PixelShuffleUpconv
from tchvp_tpu_torch.ops.conv_attention import PaddedConv2d
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = 32
FILTERS = (4, 8, 8, 8, 8, 8, 8, 8, 4)
VIDEO_KW = dict(image_size=SIZE, num_heads=8, hidden_dim=32)


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


# ---------------------------------------------------------------- layer set


def _families():
    """name -> (JAX model, port model, input shape NHWC / NTHWC, exclusion)."""
    return {
        "hybrid": (jvideo.VideoHybridNet(config=jcfg.flagship_video_config(**VIDEO_KW)),
                   lambda: tvideo.VideoHybridNet(tcfg.flagship_video_config(**VIDEO_KW), device="cpu"),
                   (1, 2, SIZE, SIZE, 3), "head_conv"),
        "fct": (jfct.FCT(config=jcfg.FCTConfig(filters=FILTERS, attn_impl="xla")),
                lambda: tfct.FCT(tcfg.FCTConfig(filters=FILTERS, attn_impl="xla"), device="cpu"),
                (1, SIZE, SIZE, 3), "wide_focus"),
        "unet": (junet.UNet(jcfg.UNetConfig(init_features=4)),
                 lambda: tunet.UNet(tcfg.UNetConfig(init_features=4), device="cpu"),
                 (1, SIZE, SIZE, 3), "decoder"),
        "ae": (jae.AutoEncoder(), lambda: tae.AutoEncoder(device="cpu"), (1, SIZE, SIZE, 3), "conv1_b"),
    }


def _jax_keys(model, shape, dense: bool, exclude: str):
    """JAX's ``engine.scales`` keys: the modules its interceptor reaches,
    traced (``jax.eval_shape``), less the exclusion."""
    x = jnp.zeros(shape)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    keys = set()

    def record(next_fn, module, x, **kw):
        keys.add(jq._path_key(module))
        return next_fn(x, **kw)

    def apply(v):
        with jq._conv_interceptor(record, dense=dense):
            return model.apply(v, x)

    jax.eval_shape(apply, variables)
    return {k for k in keys if exclude not in k}


def _port_input(shape):
    x = torch.from_numpy(_uniform(shape, 0))
    return x


@pytest.mark.parametrize("family", ["hybrid", "fct", "unet", "ae"])
@pytest.mark.parametrize("dense,exclude", [(False, False), (True, False), (False, True)])
def test_quantized_layer_set_matches_jax(family, dense, exclude):
    jmodel, make_port, shape, excluded = _families()[family]
    excl = excluded if exclude else "\0"
    want = {convert._module_name(tuple(k.split("/")))[0] for k in _jax_keys(jmodel, shape, dense, excl)}
    port = make_port().eval()
    eng = tq.Int8Engine(port, exclude=(excl,) if exclude else (), quantize_dense=dense)
    eng.calibrate([_port_input(shape)])
    assert set(eng.scales) == set(eng.qparams) == want
    kinds = {type(port.get_submodule(k)) for k in eng.scales}
    assert not any(issubclass(t, (ConvTranspose2d, PixelShuffleUpconv)) for t in kinds)
    assert any(issubclass(t, Dense) for t in kinds) == (dense and family in ("hybrid", "fct"))
    if exclude:
        assert not any(excluded in k for k in eng.scales) and want


def test_flagship_layer_counts_are_chip_smokes():
    port = tvideo.VideoHybridNet(tcfg.flagship_video_config(**VIDEO_KW), device="cpu").eval()
    x = _port_input((1, 2, SIZE, SIZE, 3))
    assert len(tq.Int8Engine(port).calibrate([x]).scales) == chip_smoke.INT8_CONV_LAYERS
    assert len(tq.Int8Engine(port, quantize_dense=True).calibrate([x]).scales) == \
        chip_smoke.INT8_CONV_LAYERS + chip_smoke.INT8_DENSE_LAYERS
    jmodel = _families()["hybrid"][0]
    assert len(_jax_keys(jmodel, (1, 2, SIZE, SIZE, 3), True, "\0")) == \
        chip_smoke.INT8_CONV_LAYERS + chip_smoke.INT8_DENSE_LAYERS


# -------------------------------------------------------------- one layer

# (padding, stride, dilation, groups), flax's padding ("SAME", "VALID" or an int).
CONV_CASES = [("SAME", 1, 1, 1), ("VALID", 1, 1, 1), (1, 1, 1, 1), ("SAME", 2, 1, 1), (1, 2, 1, 1),
              ("SAME", 1, 2, 1), ("SAME", 1, 3, 1), ("SAME", 1, 1, 6), ("SAME", 2, 1, 6), ("SAME", 1, 1, 2)]


class _Wrap(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.c = layer

    def forward(self, x):
        return self.c(x)


def _engines(make_jlayer, tlayer, x_jax, x_port, dense=False):
    """Each package's engine over one layer named "c" (JAX's made by
    ``make_jlayer(name)``), the weights from a numpy seed, calibrated on
    the same input."""
    import flax.linen as nn

    class JWrap(nn.Module):
        @nn.compact
        def __call__(self, x):
            return make_jlayer("c")(x)

    jm = JWrap()
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x_jax)
    params = jax.tree.map(lambda s: rng.normal(0.0, 0.3, s.shape).astype(np.float32), shapes)
    jeng = jq.Int8Engine(jm, params, apply_kwargs={}, quantize_dense=dense).calibrate([x_jax])
    tm = _Wrap(tlayer)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    teng = tq.Int8Engine(tm, quantize_dense=dense).calibrate([x_port])
    return jm, params, jeng, tm, teng


@pytest.mark.parametrize("pad,stride,dil,groups", CONV_CASES)
def test_int8_conv_is_jaxs_bit_for_bit(monkeypatch, pad, stride, dil, groups):
    import flax.linen as nn

    cin = 6
    cout = 6 if groups == 6 else 4
    x = np.random.default_rng(11).standard_normal((2, 11, 10, cin)).astype(np.float32)
    kw = dict(strides=stride, padding=pad, kernel_dilation=dil, feature_group_count=groups)
    tconv = PaddedConv2d(cin, cout, 3, stride=stride, padding=pad, dilation=dil, groups=groups)
    x_port = torch.from_numpy(x).permute(0, 3, 1, 2)
    jm, params, jeng, tm, teng = _engines(lambda name: nn.Conv(cout, (3, 3), name=name, **kw), tconv,
                                          jnp.asarray(x), x_port)
    s_x = jeng.scales["c"]
    assert teng.scales["c"] == s_x
    jw = np.asarray(jeng.qparams["c"]["w_i8"])
    np.testing.assert_array_equal(teng.qparams["c"]["w_i8"].numpy(), np.transpose(jw, (3, 2, 0, 1)))
    np.testing.assert_array_equal(teng.qparams["c"]["s_w"].numpy(), np.asarray(jeng.qparams["c"]["s_w"]))
    # JAX's int32 accumulators, as its _int8_conv forms them.
    xq = jnp.clip(jnp.round(jnp.asarray(x) / s_x), -127, 127).astype(jnp.int8)
    dn = jax.lax.conv_dimension_numbers(xq.shape, jw.shape, ("NHWC", "HWIO", "NHWC"))
    want_acc = np.asarray(jax.lax.conv_general_dilated(
        xq, jnp.asarray(jw), window_strides=(stride, stride), padding=jq._pad_of(nn.Conv(cout, (3, 3), **kw)),
        dimension_numbers=dn,
        rhs_dilation=(dil, dil), feature_group_count=groups, preferred_element_type=jnp.int32))
    # The port's, from the padded input its Conv2d sees (PaddedConv2d pads
    # SAME at a stride before the conv).
    seen = {}
    orig = tq.conv_accumulators

    def keep(module, xx, w_i8, s):
        parts = list(orig(module, xx, w_i8, s))
        seen["acc"] = torch.cat([a.reshape(xx.shape[0], nr, -1, a.shape[-1]) for nr, a in parts], dim=1)
        yield from parts

    monkeypatch.setattr(tq, "conv_accumulators", keep)
    got = teng.apply(teng.qparams, x_port)
    assert seen["acc"].dtype == torch.int32
    np.testing.assert_array_equal(seen["acc"].numpy(), want_acc)
    want = np.asarray(jeng.apply(jeng.qparams, jnp.asarray(x)))
    np.testing.assert_array_max_ulp(got.permute(0, 2, 3, 1).numpy(), want, maxulp=1)


def test_int8_dense_is_jaxs_bit_for_bit():
    import flax.linen as nn

    x = np.random.default_rng(12).standard_normal((2, 5, 12)).astype(np.float32)
    jm, params, jeng, tm, teng = _engines(lambda name: nn.Dense(6, name=name), Dense(12, 6), jnp.asarray(x),
                                          torch.from_numpy(x), dense=True)
    s_x = jeng.scales["c"]
    assert teng.scales["c"] == s_x
    jw = np.asarray(jeng.qparams["c"]["w_i8"])
    np.testing.assert_array_equal(teng.qparams["c"]["w_i8"].numpy(), jw.T)
    xq = jnp.clip(jnp.round(jnp.asarray(x) / s_x), -127, 127).astype(jnp.int8)
    want_acc = np.asarray(jax.lax.dot_general(xq, jnp.asarray(jw), (((2,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
    got_acc = tq.dense_accumulator(torch.from_numpy(x), teng.qparams["c"]["w_i8"], tq._scalar(s_x, "cpu"))
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), want_acc.reshape(10, 6))
    got = teng.apply(teng.qparams, torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, np.asarray(jeng.apply(jeng.qparams, jnp.asarray(x))), maxulp=1)


# ------------------------------------------------------------ whole model


def _flagship_variables():
    jmodel = _families()["hybrid"][0]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0.0, 0.1 if name == "bias" else 0.2, s.shape)

    return jmodel, {c: jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes[c])
                    for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def flagship():
    jmodel, variables = _flagship_variables()
    port = tvideo.VideoHybridNet(tcfg.flagship_video_config(**VIDEO_KW), device="cpu")
    port.load_state_dict(convert.from_flax(variables), strict=True)
    clip = _uniform((2, 2, SIZE, SIZE, 3), 3)
    jeng = jq.Int8Engine(jmodel, jax.tree.map(jnp.asarray, variables)).calibrate([jnp.asarray(clip)])
    got = np.asarray(jeng.apply(jeng.qparams, jnp.asarray(clip))[1])
    return port.eval(), clip, jeng, got, jeng.psnr_vs(jnp.asarray(clip))


def test_flagship_int8_forward_matches_jax(flagship):
    port, clip, jeng, want, want_psnr = flagship
    teng = tq.Int8Engine(port).calibrate([torch.from_numpy(clip)])
    mapped = {convert._module_name(tuple(k.split("/")))[0]: k for k in jeng.scales}
    assert set(mapped) == set(teng.scales)
    for name, jkey in mapped.items():
        np.testing.assert_allclose(teng.scales[name], jeng.scales[jkey], rtol=1e-5, err_msg=name)
        jw = np.asarray(jeng.qparams[jkey]["w_i8"])
        np.testing.assert_array_equal(teng.qparams[name]["w_i8"].numpy(), np.transpose(jw, (3, 2, 0, 1)),
                                      err_msg=name)
    x = torch.from_numpy(clip)
    assert abs(teng.psnr_vs(x) - want_psnr) <= 0.5
    teng.scales = {name: jeng.scales[jkey] for name, jkey in mapped.items()}
    got = teng.apply(teng.qparams, x)[1].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(), rtol=0)
    assert abs(teng.psnr_vs(x) - want_psnr) <= 0.1


# -------------------------------------------------------------- port only


def test_calibration_keeps_the_max_over_calls():
    conv = _Wrap(PaddedConv2d(3, 4, 3))
    small = torch.full((1, 3, 6, 6), 0.5)
    big = torch.full((1, 3, 6, 6), -2.0)
    scales = tq.calibrate_conv_scales(conv, conv, [small, big, small])
    assert scales == {"c": 2.0 / 127.0}
    assert tq.calibrate_conv_scales(conv, conv, [torch.zeros(1, 3, 6, 6)]) == {"c": 1.0}


def test_int8_streamer_runs_the_engine(flagship):
    port, clip, *_ = flagship
    x = torch.from_numpy(_uniform((1, 4, 40, 36, 3), 9))
    eng = tq.Int8Engine(port).calibrate([x[:, :2, :SIZE, :SIZE]])
    cfg = tstream.StreamingConfig(tile=SIZE, chunk_len=2, ctx_frames=1)
    got = tstream.make_streamer(port, cfg, int8_engine=eng)(x)
    with eng.intercepting(eng.qparams):
        want = tstream.stream_video(port, x, cfg)
    assert torch.equal(got, want)
    assert not torch.equal(got, tstream.make_streamer(port, cfg)(x))


def test_exported_int8_program_keeps_the_int8_ops(flagship):
    from tchvp_tpu_torch.infer import export

    port, clip, *_ = flagship
    eng = tq.Int8Engine(port, quantize_dense=True).calibrate([torch.from_numpy(clip)])
    exported, _ = export.export_int8_video_model(eng, clip_len=2, image_size=SIZE)
    targets = [n.target for n in exported.graph.nodes]
    assert targets.count(torch.ops.tchvp.int8_conv.default) == chip_smoke.INT8_CONV_LAYERS
    assert targets.count(torch.ops.tchvp.int8_dense.default) == chip_smoke.INT8_DENSE_LAYERS
