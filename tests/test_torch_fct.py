"""The port's FCT against the JAX package's, on the CPU.

Weights: flax parameter trees of the JAX modules' own shapes
(``jax.eval_shape`` of their ``init``), filled from numpy with a seed
(LayerNorm scales and biases away from 1 and 0, so a wrong map shows), then
carried into the port by ``convert.from_flax``. Inputs are numpy with a
seed. Tolerances:

* each module (pools, upsample, ``TorchMultiheadAttention``,
  ``ConvProjAttention`` with strided projections, ``WideFocus``,
  ``SpatialTransformer``) and the whole fp32 forward: max abs <= 1e-4 x
  max|ref|. Flax's LayerNorm takes E[x^2] - E[x]^2, the port's two passes:
  the same numerics note as the port's BatchNorm, well inside that limit;
* the whole model on ``attn_impl="flash"`` (JAX's Pallas kernels in
  interpret mode, the port's plain versions): the same limit;
* the bf16 forward (``compute_dtype`` against flax's ``dtype=bfloat16``
  over fp32 parameters), JAX run op by op (under ``jax.jit`` XLA's CPU
  compiler drops roundings inside its fusions): at each block's output and
  the head's logits the port's distance from JAX's bf16 output (relative
  RMS) within 0.3 x the distance between JAX's bf16 and fp32 outputs, and
  the port's fp32 model, as a control, outside it
  (``tests/test_torch_train_bf16.py``'s rule); measured 0, bit-equal,
  once GELU rounds each step as ``jax.nn.gelu`` does (torch's one rounding
  of it read 0.8 at ``WideFocus``); the mask within one bf16 ulp.

Token order is held on a non-square map (64 x 96): a transposed H/W would
pass square inputs. The k/v padding quirk and flax's asymmetric SAME at
stride 2 are held on ``ConvProjAttention(stride_q=2, stride_kv=2)``, which
computes on "xla" and raises on "flash" in both packages (JAX's ``mha``
reshapes k to q's token count). Exact GELU: ``WideFocus`` against JAX, and
the tanh form outside the limit. Dropout and drop-path: their keep share
and their draws from the generator (the JAX masks cannot be reproduced).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tchvp_tpu import config as jcfg
from tchvp_tpu.models import fct as jfct
from tchvp_tpu.ops import attention as jattn
from tchvp_tpu.ops import basic as jbasic
from tchvp_tpu.ops import conv_attention as jca
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models import fct as tfct
from tchvp_tpu_torch.ops import attention as tattn
from tchvp_tpu_torch.ops import basic as tbasic
from tchvp_tpu_torch.ops import conv_attention as tca
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FILTERS = (4, 8, 8, 8, 8, 8, 8, 8, 4)
TOL = 1e-4  # x max|ref|
BF16_LIMIT = 0.3  # x the distance between JAX's bf16 and fp32 outputs


def _flax_params(module, *inputs, seed: int = 0):
    """A flax ``params`` tree of ``module``'s shapes, filled from numpy."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _prefixed(params, prefix: str):
    """A module's tree under ``prefix`` (the converter maps FCT paths)."""
    tree = params
    for part in reversed(prefix.split("/")):
        tree = {part: tree}
    return tree


def _load(module: torch.nn.Module, params, prefix: str) -> torch.nn.Module:
    """``params`` of a JAX submodule into the port's counterpart through
    ``convert.from_flax``, as if it sat at ``prefix`` in an FCT."""
    sd = convert.from_flax({"params": _prefixed(params, prefix)})
    dot = prefix.replace("/", ".") + "."
    module.load_state_dict({k[len(dot):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got: np.ndarray, ref: np.ndarray, tol: float = TOL) -> None:
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * top, f"max abs {err:.3g} > {tol} x {top:.3g}"


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------- configs


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["FCTConfig", "SobelConfig"])
def test_config_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert _defaults(tc) == _defaults(jc)
    assert tc.__dataclass_params__.frozen == jc.__dataclass_params__.frozen


@pytest.mark.parametrize("kwargs", [dict(attn_impl="ring"), dict(seq_axis="seq"),
                                    dict(sp_axis="spatial")])
def test_unported_axes_raise_naming_item_11(kwargs):
    """Ring attention, ``seq_axis`` (11a) and ``sp_axis`` (11e) are ported:
    ``attn_impl="ring"`` without ``seq_axis`` raises JAX's ValueError at the
    call; ``seq_axis`` or ``sp_axis`` without a mesh carrying it is the
    forward without it (tests/test_torch_spatial.py runs it over one)."""
    model = tfct.FCT(tcfg.FCTConfig(filters=FILTERS, **kwargs), device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, 32, 32, 3)).astype(np.float32))
    if "attn_impl" in kwargs:
        with pytest.raises(ValueError, match="impl='ring' requires seq_axis"):
            model(x)
        return
    plain = tfct.FCT(tcfg.FCTConfig(filters=FILTERS), device="cpu").eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), plain(x), rtol=0, atol=0)


def test_input_not_divisible_by_32_raises():
    model = tfct.FCT(tcfg.FCTConfig(filters=FILTERS), device="cpu")
    with pytest.raises(ValueError, match="divisible by 32"):
        model(torch.zeros(1, 48, 64, 3))


# ---------------------------------------------------------------- basic ops


@pytest.mark.parametrize("name", ["max_pool_2x2", "avg_pool_2x2", "upsample2x_nearest"])
def test_basic_ops_match_jax(name):
    x = np.random.default_rng(1).standard_normal((2, 7, 10, 3)).astype(np.float32)  # odd H: VALID
    ref = np.asarray(getattr(jbasic, name)(jnp.asarray(x)))
    got = _nhwc(getattr(tbasic, name)(_nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- modules


def test_torch_multihead_attention_matches_jax():
    q, k, v = (np.random.default_rng(s).standard_normal((2, 24, 8)).astype(np.float32) for s in (2, 3, 4))
    jm = jattn.TorchMultiheadAttention(features=8, num_heads=2, impl="xla")
    params = _flax_params(jm, q, k, v, seed=5)
    ref = jm.apply({"params": params}, q, k, v)
    tm = _load(tattn.TorchMultiheadAttention(8, 2, impl="xla"), params,
               "block_1/trans/attention_output/attention")
    with torch.no_grad():
        got = tm(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    _close(got, ref)


@pytest.fixture(scope="module")
def strided_attention():
    """ConvProjAttention with stride_q 2 (flax's asymmetric SAME on an odd
    map) and stride_kv 2 (k, v padded by 2: fewer tokens than q)."""
    x = np.random.default_rng(6).standard_normal((2, 9, 12, 8)).astype(np.float32)
    kw = dict(channels=8, num_heads=2, stride_q=2, stride_kv=2)
    params = _flax_params(jca.ConvProjAttention(**kw, attn_impl="xla"), x, seed=7)
    return x, kw, params


def test_strided_conv_attention_matches_jax_on_xla(strided_attention):
    x, kw, params = strided_attention
    ref = jca.ConvProjAttention(**kw, attn_impl="xla").apply({"params": params}, x)
    assert ref.shape == (2, 5, 6, 8)
    port = _load(tca.ConvProjAttention(8, 2, attn_impl="xla", stride_q=2, stride_kv=2), params,
                 "block_1/trans/attention_output")
    assert port.conv_q.flax_padding == "same" and port.conv_k.padding == (2, 2)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    _close(got, ref)


def test_strided_conv_attention_raises_on_flash_as_jax_does(strided_attention):
    x, kw, params = strided_attention
    with pytest.raises(TypeError):
        jca.ConvProjAttention(**kw, attn_impl="flash").apply({"params": params}, x)
    port = _load(tca.ConvProjAttention(8, 2, attn_impl="flash", stride_q=2, stride_kv=2), params,
                 "block_1/trans/attention_output")
    with pytest.raises(ValueError, match="one shape"), torch.no_grad():
        port(_nchw(x))


def test_flax_pads_match_lax_same_padding():
    for size in range(5, 12):
        for stride in (1, 2, 3):
            for dilation in (1, 2, 3):
                want = jax.lax.padtype_to_pads((size,), ((3 - 1) * dilation + 1,), (stride,), "SAME")[0]
                assert tca.flax_pads(size, 3, stride, "same", dilation) == tuple(want)


@pytest.fixture(scope="module")
def wide_focus():
    x = np.random.default_rng(8).standard_normal((2, 12, 10, 8)).astype(np.float32)
    params = _flax_params(jca.WideFocus(features=8), x, seed=9)
    ref = np.asarray(jca.WideFocus(features=8).apply({"params": params}, x))
    port = _load(tca.WideFocus(8), params, "block_1/trans/wide_focus")
    return x, ref, port


def test_wide_focus_matches_jax_with_exact_gelu(wide_focus):
    x, ref, port = wide_focus
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), ref)


def test_tanh_gelu_would_miss_the_limit(wide_focus, monkeypatch):
    x, ref, port = wide_focus
    gelu = F.gelu
    monkeypatch.setattr(tca.F, "gelu", lambda y, approximate="none": gelu(y, approximate="tanh"))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert np.abs(got - ref).max() > TOL * np.abs(ref).max()  # tanh reads ~2.2e-4 x max|ref|


def test_spatial_transformer_matches_jax_on_a_non_square_map():
    x = np.random.default_rng(10).standard_normal((2, 6, 10, 8)).astype(np.float32)
    jm = jca.SpatialTransformer(channels=8, num_heads=2, attn_impl="xla")
    params = _flax_params(jm, x, seed=11)
    ref = jm.apply({"params": params}, x)
    port = _load(tca.SpatialTransformer(8, 2, attn_impl="xla"), params, "block_1/trans")
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), ref)


def test_tokens_are_row_major_over_height_then_width():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)  # (B, C, H, W)
    t = tca.to_tokens(x)
    nhwc = x.permute(0, 2, 3, 1).reshape(2, 20, 3)
    assert torch.equal(t, nhwc) and torch.equal(tca.from_tokens(t, 4, 5), x)


# ---------------------------------------------------------------- whole model


def _jax_fct(attn: str, dtype=jnp.float32):
    return jfct.FCT(config=jcfg.FCTConfig(filters=FILTERS, attn_impl=attn), dtype=dtype)


def _port_fct(attn: str, params, compute_dtype=None) -> tfct.FCT:
    model = tfct.FCT(tcfg.FCTConfig(filters=FILTERS, attn_impl=attn), device="cpu",
                     compute_dtype=compute_dtype)
    model.load_state_dict(convert.from_flax({"params": params}), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def fct_params():
    return _flax_params(_jax_fct("xla"), jnp.zeros((1, 32, 32, 3)), seed=12)


def test_from_flax_covers_fct_and_maps_depthwise_kernels(fct_params):
    sd = convert.from_flax({"params": fct_params})
    model = tfct.FCT(tcfg.FCTConfig(filters=FILTERS), device="cpu")
    assert set(sd) == set(model.state_dict())
    k = np.asarray(fct_params["block_2"]["trans"]["attention_output"]["conv_q"]["kernel"])
    assert k.shape == (3, 3, 1, 8)
    got = sd["block_2.trans.attention_output.conv_q.weight"]
    assert tuple(got.shape) == (8, 1, 3, 3)
    np.testing.assert_array_equal(got.numpy(), k.transpose(3, 2, 0, 1))
    ln = fct_params["block_9"]["trans"]["layernorm"]["scale"]
    np.testing.assert_array_equal(sd["block_9.trans.layernorm.weight"].numpy(), ln)
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(fct_params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_fct_fp32_forward_matches_jax_on_a_non_square_image(fct_params):
    x = _image((2, 64, 96, 3), 13)
    ref = jax.jit(_jax_fct("xla").apply)({"params": fct_params}, x)
    with torch.no_grad():
        got = _port_fct("xla", fct_params)(torch.from_numpy(x)).numpy()
    _close(got, ref)


def test_fct_flash_matches_jax_pallas_in_interpret_mode(fct_params):
    x = _image((2, 32, 32, 3), 14)
    ref = jax.jit(_jax_fct("flash").apply)({"params": fct_params}, x)
    with torch.no_grad():
        got = _port_fct("flash", fct_params)(torch.from_numpy(x)).numpy()
    _close(got, ref)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


STAGES = [f"block_{i}" for i in range(1, 10)] + ["ds/conv3"]


def _jax_stages(variables, x, dtype) -> dict:
    """Each block's output and the head's pre-sigmoid logits (NHWC, fp32)."""
    picked = lambda mdl, method: method == "__call__" and "/".join(mdl.scope.path) in STAGES  # noqa: E731
    run = lambda v, x: _jax_fct("xla", dtype).apply(  # noqa: E731
        v, x, capture_intermediates=picked, mutable=["intermediates"])
    out, st = (run if dtype == jnp.bfloat16 else jax.jit(run))(variables, x)
    found = {}
    for name in STAGES:
        node = st["intermediates"]
        for part in name.split("/"):
            node = node[part]
        found[name] = np.asarray(node["__call__"][0].astype(jnp.float32))
    return found, np.asarray(out.astype(jnp.float32))


def _port_stages(model: tfct.FCT, x) -> dict:
    seen = {}
    for name in STAGES:
        model.get_submodule(name.replace("/", ".")).register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, _nhwc(o)))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).float().numpy()
    return seen, out


def test_bf16_forward_rounds_where_flax_does(fct_params):
    """Every block's output and the head's logits, JAX's bf16 run op by op;
    the mask within one bf16 ulp of [0.5, 1) (2^-8): ``torch.sigmoid``
    rounds the logistic once, XLA's CPU backend expands it into exp, add
    and divide, each rounded to bf16 (measured: 19 % of the mask one ulp
    off, the logits and every block bit-equal)."""
    x = _image((2, 32, 32, 3), 15)
    variables = {"params": jax.tree.map(jnp.asarray, fct_params)}
    jax_bf16, jax_mask = _jax_stages(variables, x, jnp.bfloat16)
    jax_fp32, _ = _jax_stages(variables, x, jnp.float32)
    bf16, mask = _port_stages(_port_fct("xla", fct_params, torch.bfloat16), x)
    fp32, _ = _port_stages(_port_fct("xla", fct_params), x)
    for name in STAGES:
        gap = _rel(jax_bf16[name], jax_fp32[name])
        assert _rel(bf16[name], jax_bf16[name]) <= BF16_LIMIT * gap, name
        assert _rel(fp32[name], jax_bf16[name]) > BF16_LIMIT * gap, name  # the control
    assert np.abs(mask - jax_mask).max() <= 2.0 ** -8


# ---------------------------------------------------------------- dropout


def _train_model(rate: float = 0.3, sd_rate: float = 0.0) -> tfct.FCT:
    cfg = tcfg.FCTConfig(filters=FILTERS, attn_impl="xla", dropout_rate=rate,
                         stochastic_depth_rate=sd_rate)
    return tfct.FCT(cfg, device="cpu").train()


def test_dropout_draws_come_from_the_generator():
    model = _train_model(sd_rate=0.5)
    x = torch.from_numpy(_image((2, 32, 32, 3), 16))
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(x)


@pytest.mark.parametrize("rate", [0.3, 0.1])
def test_dropout_keep_share(rate):
    """The blocks' dropout (0.3) and Wide-Focus's (0.1): the share kept,
    and the survivors scaled by 1 / (1 - rate)."""
    x = torch.ones(4, 8, 32, 32)
    if rate == 0.1:
        wf = tca.WideFocus(8).train()
        seen = []
        orig = tca.dropout
        tca.dropout = lambda y, r, g, **kw: seen.append(orig(y, r, g, **kw)) or seen[-1]
        try:
            with torch.no_grad():
                wf(x, generator=torch.Generator().manual_seed(3))
        finally:
            tca.dropout = orig
        assert len(seen) == 4
        y = torch.cat([s.flatten() for s in seen])
        ref = None
    else:
        from tchvp_tpu_torch.ops.blocks import dropout

        y = dropout(x, rate, torch.Generator().manual_seed(4))
        ref = 1.0 / (1.0 - rate)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1.0 - rate)) < 0.01
    if ref is not None:
        assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], ref))


def test_drop_path_gates_whole_samples():
    x = torch.ones(4000, 2, 3, 3)
    y = tca.drop_path(x, 0.25, torch.Generator().manual_seed(5))
    per_sample = y.flatten(1)
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1))
    assert abs((per_sample[:, 0] != 0).float().mean().item() - 0.75) < 0.03


def test_no_dropout_in_eval_mode():
    model = _train_model(sd_rate=0.5).eval()
    x = torch.from_numpy(_image((1, 32, 32, 3), 17))
    with torch.no_grad():
        assert torch.equal(model(x), model(x))
