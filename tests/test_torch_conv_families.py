"""The port's conv families against the JAX package's, on the CPU: the
blocks of ``ops/blocks.py`` (``ConvBNReLUBlock``, ``EncoderBlock``,
``DecoderBlock``, ``DeepSupervisionBlock``), ``UNet`` (``init_features=4``),
``AutoEncoder`` (default filters, 64^2), ``Image2Image2Mask``,
``Autoencoder32K`` (image and mask heads, ``vae`` on JAX's ``eps``,
``token_latent``) and ``Autoencoder4K`` (64^2).

Weights: flax trees of the JAX modules' own shapes (``jax.eval_shape`` of
their ``init``) filled from numpy with a seed: kernels normal / sqrt(fan-in),
BatchNorm scales and running variances in [0.5, 1.5], biases and running
means N(0, 0.1^2) and N(0, 0.2^2), so a wrong map shows. They reach the port
through ``convert.from_flax`` and ``load_state_dict(strict=True)``. Inputs
are numpy with a seed. Tolerances:

* the eval forward, every output: max abs <= 1e-4 x max|ref|;
* train mode with every dropout off (rate 0, or JAX's ``deterministic``):
  the gradients of ``sum_i sum(out_i * w_i)`` (w fixed, numpy) within
  1e-4 x the largest gradient, and the BatchNorm running stats after the
  pass within 1e-4 x their largest magnitude;
* dropout: JAX's ``bernoulli`` and the port's ``draw_keep`` both hand out
  the same fixed keep masks, made per call from a counter (NHWC, transposed
  for the port), so the AutoEncoder's element-wise masks and
  ``Encoder32K``'s channel-wise Dropout2d are held to JAX's forms; the
  eval forward's limit;
* a control: UNet's ConvTranspose kernels transposed to torch's layout
  but not flipped miss JAX's mask by more than 10x the limit, so the
  converter's ConvTranspose rule is what passes.
"""

import dataclasses
import itertools

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu.models import autoencoder as jae
from tchvp_tpu.models import combined as jcomb
from tchvp_tpu.models import resnet_ae as jres
from tchvp_tpu.models import unet as junet
from tchvp_tpu.ops import blocks as jblocks
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models import autoencoder as tae
from tchvp_tpu_torch.models import combined as tcomb
from tchvp_tpu_torch.models import resnet_ae as tres
from tchvp_tpu_torch.models import unet as tunet
from tchvp_tpu_torch.ops import blocks as tblocks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4  # x max|ref|


def flax_variables(module, *inputs, seed: int = 0, init_rngs=None, **kw):
    """{"params", "batch_stats"?} of ``module``'s shapes, filled from numpy."""
    shapes = jax.eval_shape(lambda: module.init(init_rngs or jax.random.PRNGKey(0), *inputs, **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, x.shape)
        else:
            a = rng.normal(0.0, 0.1 if name == "bias" else 0.2, x.shape)
        return a.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(leaf, shapes[c])
            for c in ("params", "batch_stats") if c in shapes}


def inner(module: torch.nn.Module) -> torch.nn.Module:
    """The module whose state_dict mirrors the flax tree (an NCHW block's
    own, not its wrapper's)."""
    return module.block if isinstance(module, NCHW) else module


def load(module: torch.nn.Module, variables) -> torch.nn.Module:
    inner(module).load_state_dict(convert.from_flax(variables), strict=True)
    return module


def image(shape, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def close(got, ref, tol: float = TOL) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * top, f"max abs {err:.3g} > {tol} x {top:.3g}"
    return err / top


def close_pairs(pairs, tol: float = TOL) -> None:
    """Every (got, want) pair within ``tol`` x the largest |want| of all."""
    top = max(float(np.abs(w).max()) for _, w in pairs)
    err = max(float(np.abs(g - w).max()) for g, w in pairs)
    assert err <= tol * top, f"max abs {err:.3g} > {tol} x {top:.3g}"


class NCHW(torch.nn.Module):
    """A block of ``ops/blocks.py`` (NCHW) behind the NHWC interface."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, *xs):
        out = self.block(*(x.permute(0, 3, 1, 2).contiguous() for x in xs))
        return out.permute(0, 2, 3, 1)


@dataclasses.dataclass
class Case:
    jmake: object  # dtype -> the JAX module computing and holding its parameters in it
    shapes: list  # its inputs' shapes (NHWC)
    port: object  # () -> the port's module, NHWC in and out
    eval_kw: dict = dataclasses.field(default_factory=dict)
    train_kw: dict = dataclasses.field(default_factory=dict)

    @property
    def jmod(self):
        return self.jmake(jnp.float32)

    def inputs(self):
        return [image(s, seed=i + 1) for i, s in enumerate(self.shapes)]


def _no_dropout_4k():
    model = tres.Autoencoder4K(device="cpu")
    model.encoder.config = dataclasses.replace(model.encoder.config, dropout_rate=0.0)
    return model


def _dt(cls, *a, **kw):
    """``dtype -> cls(*a, **kw)`` computing and holding its parameters in dtype."""
    return lambda dt: cls(*a, dtype=dt, param_dtype=dt, **kw)


J_TRAIN = dict(train=True, deterministic=True)
J_EVAL = dict(train=False)
AE0, UNET4 = jcfg.AutoEncoderConfig(dropout_rate=0.0), jcfg.UNetConfig(init_features=4)
TAE0, TUNET4 = tcfg.AutoEncoderConfig(dropout_rate=0.0), tcfg.UNetConfig(init_features=4)
R0 = dict(dropout_rate=0.0)

CASES = {
    "conv_bn_relu": Case(_dt(jblocks.ConvBNReLUBlock, 6), [(2, 12, 10, 3)],
                         lambda: NCHW(tblocks.ConvBNReLUBlock(3, 6)), J_EVAL, dict(train=True)),
    "encoder_first": Case(_dt(jblocks.EncoderBlock, "first", 3, 6, dropout_rate=0.0), [(2, 12, 10, 3)],
                          lambda: NCHW(tblocks.EncoderBlock("first", 3, 6, 0.0))),
    "encoder_middle": Case(_dt(jblocks.EncoderBlock, "middle", 4, 6, dropout_rate=0.0),
                           [(2, 12, 10, 4), (2, 12, 10, 3)],
                           lambda: NCHW(tblocks.EncoderBlock("middle", 4, 6, 0.0))),
    "encoder_bottleneck": Case(_dt(jblocks.EncoderBlock, "bottleneck", 4, 6, dropout_rate=0.0),
                               [(2, 7, 9, 4)],
                               lambda: NCHW(tblocks.EncoderBlock("bottleneck", 4, 6, 0.0))),
    "decoder": Case(_dt(jblocks.DecoderBlock, 5, dropout_rate=0.0), [(2, 6, 5, 4)],
                    lambda: NCHW(tblocks.DecoderBlock(4, 5, 0.0))),
    "ds_relu": Case(_dt(jblocks.DeepSupervisionBlock, 4, 2, "relu"), [(2, 6, 5, 4)],
                    lambda: NCHW(tblocks.DeepSupervisionBlock(4, 2, "relu"))),
    "ds_sigmoid": Case(_dt(jblocks.DeepSupervisionBlock, 4, 2, "sigmoid"), [(2, 6, 5, 4)],
                       lambda: NCHW(tblocks.DeepSupervisionBlock(4, 2, "sigmoid"))),
    "unet": Case(_dt(junet.UNet, UNET4), [(2, 32, 32, 3)],
                 lambda: tunet.UNet(TUNET4, device="cpu"), J_EVAL, J_TRAIN),
    "autoencoder": Case(_dt(jae.AutoEncoder, AE0), [(2, 64, 64, 3)],
                        lambda: tae.AutoEncoder(TAE0, device="cpu")),
    "combined": Case(_dt(jcomb.Image2Image2Mask, AE0, UNET4), [(2, 64, 64, 3)],
                     lambda: tcomb.Image2Image2Mask(TAE0, TUNET4, device="cpu"), J_EVAL, J_TRAIN),
    "ae32k_image": Case(_dt(jres.Autoencoder32K, jcfg.ResNetAEConfig(**R0)), [(2, 32, 32, 3)],
                        lambda: tres.Autoencoder32K(tcfg.ResNetAEConfig(**R0), device="cpu"),
                        J_EVAL, J_TRAIN),
    "ae32k_mask": Case(_dt(jres.Autoencoder32K, jcfg.ResNetAEConfig(output_type="mask", **R0)),
                       [(2, 32, 32, 3)],
                       lambda: tres.Autoencoder32K(tcfg.ResNetAEConfig(output_type="mask", **R0),
                                                   device="cpu"),
                       J_EVAL, J_TRAIN),
    "ae32k_tokens": Case(_dt(jres.Autoencoder32K, jcfg.ResNetAEConfig(token_latent=True, **R0)),
                         [(2, 32, 24, 3)],
                         lambda: tres.Autoencoder32K(tcfg.ResNetAEConfig(token_latent=True, **R0),
                                                     device="cpu"),
                         J_EVAL, J_TRAIN),
    "ae4k": Case(_dt(jres.Autoencoder4K), [(2, 64, 64, 3)], _no_dropout_4k, J_EVAL, J_TRAIN),
}


def _jax_outputs(jmod, variables, inputs, kw, train: bool):
    """JAX's outputs (a tuple) and, in train mode, the updated batch stats."""
    if train and "batch_stats" in variables:
        out, mut = jmod.apply(variables, *inputs, **kw, mutable=["batch_stats"])
        return as_tuple(out), mut["batch_stats"]
    return as_tuple(jmod.apply(variables, *inputs, **kw)), None


@pytest.mark.parametrize("name", list(CASES))
def test_eval_forward_matches_jax(name):
    case = CASES[name]
    inputs = case.inputs()
    variables = flax_variables(case.jmod, *inputs, **case.eval_kw)
    model = load(case.port(), variables).eval()
    want, _ = _jax_outputs(case.jmod, variables, inputs, case.eval_kw, train=False)
    with torch.no_grad():
        got = as_tuple(model(*map(torch.from_numpy, inputs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.numpy(), w)


def _jax_train(case, variables, inputs, ws, dtype):
    """JAX's gradients of sum_i sum(out_i * w_i) and its updated stats, in
    ``dtype`` (float64 under ``jax.enable_x64``), as the port's tensors by name."""
    jmod = case.jmake(dtype)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
    variables, inputs, ws = cast(variables), cast(inputs), cast(ws)

    def loss(params):
        outs, stats = _jax_outputs(jmod, dict(variables, params=params), inputs, case.train_kw, True)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), stats

    grads, stats = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    out = {k: v.double().numpy() for k, v in convert.from_flax({"params": grads}).items()}
    if stats is not None:
        out.update({k: v.double().numpy() for k, v in convert.from_flax({"batch_stats": stats}).items()
                    if "running" in k})
    return out


def _port_train(case, variables, inputs, ws, dtype):
    """The port's gradients and updated running stats by name, in ``dtype``."""
    model = load(case.port(), variables).train().to(dtype)
    outs = as_tuple(model(*(torch.from_numpy(x).to(dtype) for x in inputs)))
    sum((o * torch.from_numpy(w).to(dtype)).sum() for o, w in zip(outs, ws)).backward()
    out = {k: p.grad.double().numpy() for k, p in inner(model).named_parameters()}
    out.update({k: b.double().numpy() for k, b in inner(model).named_buffers() if "running" in k})
    return out


def _dist(a: dict, b: dict, keys) -> float:
    """The largest |a - b| over ``keys`` relative to the largest |b| there."""
    top = max(float(np.abs(b[k]).max()) for k in keys)
    return max(float(np.abs(a[k] - b[k]).max()) for k in keys) / top


@pytest.mark.parametrize("name", [n for n in CASES if n != "ae32k_tokens"])
def test_train_gradients_and_stats_match_jax(name):
    """Train mode, dropout off: the gradients and the updated BatchNorm
    stats. In float64 (JAX under ``jax.enable_x64``) the port's are within
    1e-6 of JAX's (relative to the largest of each kind). In fp32 they are
    within 1e-4 of JAX's where JAX's own fp32 run is that close to float64;
    where it is not, the port's fp32 run is no farther from float64 than 10x
    JAX's. Those are the ResNet AEs, whose chains of train-mode BatchNorm
    amplify every fp32 rounding into the first layers' gradients (JAX's
    fp32 run 1.1-3 % of the largest gradient from float64, the port's
    0.8-5.2 %, the float64 runs 4e-8 apart), and Image2Image2Mask, whose
    UNet's first BatchNorm sees the AutoEncoder's output, where flax's
    E[x^2] - E[x]^2 variance cancels (JAX's fp32 run 0.37 % off, the
    port's 2.5e-6). ``token_latent`` only reshapes the latent: its eval
    forward is held, its gradients are ``ae32k_image``'s."""
    case = CASES[name]
    inputs = case.inputs()
    variables = flax_variables(case.jmod, *inputs, **case.train_kw)
    shapes = [o.shape for o in jax.eval_shape(
        lambda: _jax_outputs(case.jmod, variables, inputs, case.train_kw, True)[0])]
    rng = np.random.default_rng(9)
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    with jax.enable_x64(True):
        want64 = _jax_train(case, variables, inputs, ws, jnp.float64)
    got64 = _port_train(case, variables, inputs, ws, torch.float64)
    want32 = _jax_train(case, variables, inputs, ws, jnp.float32)
    got32 = _port_train(case, variables, inputs, ws, torch.float32)
    assert got64.keys() == want64.keys() == got32.keys()
    grads = [k for k in got64 if "running" not in k]
    stats = [k for k in got64 if "running" in k]
    for keys in filter(None, (grads, stats)):
        assert _dist(got64, want64, keys) <= 1e-6
        jax_err = _dist(want32, want64, keys)
        if jax_err <= TOL:
            assert _dist(got32, want32, keys) <= TOL
        else:
            assert _dist(got32, want64, keys) <= 10 * jax_err


# ---------------------------------------------------------------- vae


def test_vae_matches_jax_on_jax_eps(monkeypatch):
    """``vae=True`` (eval and train mode): the port fed the ``eps`` JAX drew,
    captured from ``jax.random.normal``."""
    x = image((2, 32, 32, 3))
    jmod = jres.Autoencoder32K(jcfg.ResNetAEConfig(vae=True, dropout_rate=0.0))
    rngs = {"vae": jax.random.PRNGKey(4)}
    variables = flax_variables(jmod, x, init_rngs={"params": jax.random.PRNGKey(0), **rngs})
    assert {"mu", "logvar"} <= set(variables["params"])
    model = load(tres.Autoencoder32K(tcfg.ResNetAEConfig(vae=True, dropout_rate=0.0), device="cpu"),
                 variables)
    drawn, normal = [], jax.random.normal

    def record(*a, **k):
        drawn.append(normal(*a, **k))
        return drawn[-1]

    monkeypatch.setattr(jax.random, "normal", record)
    for train in (False, True):
        kw = dict(train=True, mutable=["batch_stats"]) if train else {}
        out = jmod.apply(variables, x, rngs=rngs, **kw)
        want = out[0] if train else out
        eps = torch.from_numpy(np.asarray(drawn[-1]).transpose(0, 3, 1, 2).copy())
        model.train(train)
        with torch.no_grad():
            got = model(torch.from_numpy(x), draws=tres.AEDraws(eps=eps))
        for g, w in zip(got, want):
            close(g.numpy(), w)
    with pytest.raises(ValueError, match="Generator"):
        model.eval()(torch.from_numpy(x))


# ---------------------------------------------------------------- dropout


class FixedMasks:
    """Keep masks by call order: call i gets ``uniform(seed i) >= rate`` of
    the NHWC shape, for JAX's bernoulli and (transposed) the port's draw_keep."""

    def __init__(self, rate: float):
        self.rate = rate
        self.jax_calls = itertools.count()
        self.port_calls = itertools.count()

    def mask(self, i: int, shape) -> np.ndarray:
        return np.random.default_rng(100 + i).uniform(size=shape) >= self.rate

    def bernoulli(self, key, p, shape):
        assert abs(p - (1.0 - self.rate)) < 1e-9
        return jnp.asarray(self.mask(next(self.jax_calls), tuple(shape)))

    def draw_keep(self, shape, rate, generator, device):
        assert rate == self.rate
        n, c, h, w = shape
        m = self.mask(next(self.port_calls), (n, h, w, c)).transpose(0, 3, 1, 2)
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)


@pytest.mark.parametrize("kind", ["autoencoder", "ae32k"])
def test_dropout_forms_match_jax_on_fixed_masks(kind, monkeypatch):
    """Train mode with dropout on, both in float64 (the ResNet AE's
    train-mode BatchNorm spreads fp32 roundings: see the gradient test)."""
    masks = FixedMasks(0.3)
    monkeypatch.setattr(flax_stochastic.random, "bernoulli", masks.bernoulli)
    monkeypatch.setattr(tblocks, "draw_keep", masks.draw_keep)
    monkeypatch.setattr(tres, "draw_keep", masks.draw_keep)
    if kind == "autoencoder":  # element-wise, every encoder and decoder block
        x = image((2, 64, 64, 3))
        jmake, kw = _dt(jae.AutoEncoder), {}
        model, calls = tae.AutoEncoder(device="cpu"), 9
    else:  # Encoder32K's Dropout2d: (N, 1, 1, C) masks, in train mode
        x = image((2, 32, 32, 3))
        jmake, kw = _dt(jres.Autoencoder32K), dict(train=True, mutable=["batch_stats"])
        model, calls = tres.Autoencoder32K(device="cpu"), 1
    variables = flax_variables(jmake(jnp.float32), x)
    load(model, variables).train().double()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        out = jmake(jnp.float64).apply(v64, jnp.asarray(x, jnp.float64), deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
        want = [np.asarray(w) for w in (out[0] if "mutable" in kw else out)]
    with torch.no_grad():
        got = model(torch.from_numpy(x).double(), generator=torch.Generator())
    assert next(masks.jax_calls) == next(masks.port_calls) == calls
    for g, w in zip(got, want):
        close(g.numpy(), w)


def test_dropout_without_a_generator_raises():
    model = tae.AutoEncoder(device="cpu").train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(1, 32, 32, 3))


# ---------------------------------------------------------------- layouts and repairs


def test_unet_upconv_transposed_but_not_flipped_fails():
    """The control: ConvTranspose kernels carried as HWIO -> (in, out, kh,
    kw) without the spatial flip give a plausible but wrong mask."""
    case = CASES["unet"]
    inputs = case.inputs()
    variables = flax_variables(case.jmod, *inputs, **case.eval_kw)
    want = np.asarray(case.jmod.apply(variables, *inputs, **case.eval_kw))
    state = convert.from_flax(variables)
    for i in range(1, 5):
        k = np.asarray(variables["params"][f"upconv{i}"]["kernel"])
        state[f"upconv{i}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    model = case.port()
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(inputs[0])).numpy()
    err = float(np.abs(got - want).max())
    assert err > 10 * TOL * float(np.abs(want).max()), err


def test_decoder32k_takes_its_width_from_the_latent():
    """``Autoencoder4K``'s decoder (a 16-channel latent) loads into a
    ``Decoder32K(latent_channels=16)`` and decodes as JAX's; the flagship's
    default width, 8, refuses those weights."""
    x = image((2, 64, 64, 3))
    jmod = jres.Autoencoder4K()
    variables = flax_variables(jmod, x, train=False)
    dec = {c: {"decoder": variables[c]["decoder"]} for c in variables}
    state = {k[len("decoder."):]: v for k, v in convert.from_flax(dec).items()}
    decoder = tres.Decoder32K(conv_features=(32, 64, 128, 256), latent_channels=16)
    decoder.load_state_dict(state, strict=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tres.Decoder32K(conv_features=(32, 64, 128, 256)).load_state_dict(state, strict=True)
    latent = image((2, 16, 16, 16), seed=5)
    want = jres.Decoder32K(conv_features=(32, 64, 128, 256)).apply(
        {c: variables[c]["decoder"] for c in variables}, latent)
    with torch.no_grad():
        got = decoder.eval()(torch.from_numpy(latent.transpose(0, 3, 1, 2).copy()))
    close(got.permute(0, 2, 3, 1).numpy(), want)


def test_autoencoder4k_flat_latent_is_the_channel_first_flatten():
    """The 4096-d latent against JAX's on a non-square input, where a
    transposed (H, W, C) order would show."""
    case = CASES["ae4k"]
    x = image((2, 64, 48, 3))
    variables = flax_variables(case.jmod, x, **case.eval_kw)
    want = case.jmod.apply(variables, x, **case.eval_kw)[0]
    with torch.no_grad():
        got = load(case.port(), variables).eval()(torch.from_numpy(x))[0]
    assert got.shape == (2, 16 * 16 * 12)
    close(got.numpy(), want)


def test_notebook_variant_latent_shape_matches_jax():
    x = image((1, 64, 64, 3))
    jmod = jae.AutoEncoder(jcfg.AutoEncoderConfig.notebook_variant())
    variables = flax_variables(jmod, x)
    model = load(tae.AutoEncoder(tcfg.AutoEncoderConfig.notebook_variant(), device="cpu"), variables)
    with torch.no_grad():
        latent, recon = model.eval()(torch.from_numpy(x))
    want = jmod.apply(variables, x)
    assert latent.shape == want[0].shape == (1, 1, 1, 512)
    close(recon.numpy(), want[1])
