"""The port's augmentations, resize, layouts and synthetic generators
against the JAX package's.

torch cannot reproduce ``jax.random`` streams, so each augmentation is
held to JAX on JAX's own draws: the test splits the key as the JAX
function does, makes the same draws with ``jax.random``, turns them into
tensors and calls the port's ``*_with`` form, then compares with the JAX
function on that key. fp32; flip, rot90 and blackout exactly, crop-resize
and jitter (and the suites that run them) within 1e-5 absolute. The
public forms (generator in, augmented batch out) are checked for their
draws' ranges and for giving the same batch from the same seed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu import config as jcfg
from tchvp_tpu import layout as jlayout
from tchvp_tpu.data import pipeline as jpipe
from tchvp_tpu.data import synthetic as jsyn
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import layout as tlayout
from tchvp_tpu_torch.data import pipeline as tpipe
from tchvp_tpu_torch.data import synthetic as tsyn
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SHAPES = [(3, 20, 20, 3), (2, 3, 16, 24, 3)]  # 4-D square, 5-D non-square
SQUARE = [(3, 20, 20, 3), (2, 3, 20, 20, 3)]
SEEDS = range(4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(tree):
    """JAX arrays (in tuples and dicts) as tensors."""
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _exact(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got: torch.Tensor, want, atol=1e-5) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def _reference(draws, fn, draw_args, fn_args):
    """One compiled JAX program per case: for a stack of keys, the draws
    and the JAX function's output on each key."""
    def one(key, x):
        return draws(key, *draw_args), fn(key, x, *fn_args)

    return jax.jit(jax.vmap(one, in_axes=(0, None)))


def _cases(draws, fn, x, draw_args, fn_args, n=len(SEEDS)):
    """(draws as tensors, JAX's output) for the keys PRNGKey(0..n-1)."""
    keys = jnp.stack([jax.random.PRNGKey(seed) for seed in range(n)])
    d, out = jax.tree.map(np.asarray, _reference(draws, fn, draw_args, fn_args)(keys, jnp.asarray(x)))
    for i in range(n):
        yield _t(jax.tree.map(lambda a: a[i], d)), out[i]


# JAX's draws, split from the key exactly as each JAX function splits it.


def _hflip_draws(key, prob):
    return (jax.random.bernoulli(key, prob),)


def _blackout_draws(key, h, w, max_patches, patch):
    k_count, key = jax.random.split(key)
    n_active = jax.random.randint(k_count, (), 0, max_patches + 1)
    r0, c0 = [], []
    for _ in range(max_patches):
        key, kx, ky = jax.random.split(key, 3)
        r0.append(jax.random.randint(kx, (), 0, h - patch + 1))
        c0.append(jax.random.randint(ky, (), 0, w - patch + 1))
    return n_active, jnp.stack(r0), jnp.stack(c0)


def _rot90_draws(key, b, prob):
    k_gate, k_k = jax.random.split(key)
    ks = jax.random.randint(k_k, (b,), 0, 4)
    return (jnp.where(jax.random.bernoulli(k_gate, prob, (b,)), ks, 0),)


def _crop_draws(key, shape, prob, frac):
    b, h, w = shape[0], shape[-3], shape[-2]
    ch, cw = tpipe.crop_size(h, w, frac)
    k_gate, k_off = jax.random.split(key)
    off_h = jax.random.randint(k_off, (b,), 0, h - ch + 1)
    off_w = jax.random.randint(jax.random.fold_in(k_off, 1), (b,), 0, w - cw + 1)
    return off_h, off_w, jax.random.bernoulli(k_gate, prob, (b,))


def _jitter_draws(key, b, prob, strength):
    k_gate, kb, kc, ks = jax.random.split(key, 4)
    u = lambda k, lo, hi: jax.random.uniform(k, (b,), jnp.float32, lo, hi)  # noqa: E731
    return (u(kb, -strength, strength), u(kc, 1 - strength, 1 + strength),
            u(ks, 1 - strength, 1 + strength), jax.random.bernoulli(k_gate, prob, (b,)))


def _geometric_draws(key, shape, cfg):
    draws = {}
    if cfg.rot90_prob > 0.0:
        key, k = jax.random.split(key)
        draws["rot90"] = _rot90_draws(k, shape[0], cfg.rot90_prob)
    if cfg.crop_prob > 0.0:
        key, k = jax.random.split(key)
        draws["crop"] = _crop_draws(k, shape, cfg.crop_prob, cfg.crop_frac)
    if cfg.jitter_prob > 0.0:
        key, k = jax.random.split(key)
        draws["jitter"] = _jitter_draws(k, shape[0], cfg.jitter_prob, cfg.jitter_strength)
    return draws


def _denoising_draws(key, shape, cfg):
    k_flip, k_noise_gate, k_noise, k_patch_gate, k_patch = jax.random.split(key, 5)
    return {
        "flip": _hflip_draws(k_flip, cfg.hflip_prob),
        "noise_gate": jax.random.bernoulli(k_noise_gate, cfg.noise_prob),
        "noise": jax.random.normal(k_noise, shape, jnp.float32),
        "patch_gate": jax.random.bernoulli(k_patch_gate, 0.5),
        "blackout": _blackout_draws(k_patch, shape[-3], shape[-2], cfg.max_blackout_patches,
                                    cfg.blackout_size),
    }


# ------------------------------------------------------------- augmentations


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_hflip_matches_jax(shape, prob):
    x = _x(shape)
    for draws, want in _cases(_hflip_draws, jpipe.random_hflip, x, (prob,), (prob,)):
        _exact(tpipe.hflip_with(torch.from_numpy(x), *draws), want)


@pytest.mark.parametrize("shape,max_patches,patch", [(SHAPES[0], 3, 8), (SHAPES[1], 2, 32)])
def test_blackout_matches_jax(shape, max_patches, patch):
    """Patches that fit and patches larger than the image."""
    x = _x(shape)
    h, w = shape[-3], shape[-2]
    for draws, want in _cases(_blackout_draws, jpipe.random_blackout, x, (h, w, max_patches, patch),
                              (max_patches, patch)):
        _exact(tpipe.blackout_with(torch.from_numpy(x), *draws, patch), want)


@pytest.mark.parametrize("shape", SQUARE)
@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_rot90_matches_jax(shape, prob):
    x = _x(shape)
    seen = set()
    for (ks,), want in _cases(_rot90_draws, jpipe.random_rot90, x, (shape[0], prob), (prob,), n=16):
        seen |= set(ks.tolist())
        _exact(tpipe.rot90_with(torch.from_numpy(x), ks), want)
    assert seen == {0, 1, 2, 3}


def test_rot90_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        tpipe.random_rot90(torch.Generator(), torch.zeros(2, 4, 6, 3), 0.5)


@pytest.mark.parametrize("shape,frac", [(SHAPES[0], 0.875), (SHAPES[1], 0.5), (SHAPES[1], 1.0)])
def test_crop_resize_matches_jax(shape, frac):
    x = _x(shape)
    for draws, want in _cases(_crop_draws, jpipe.random_crop_resize, x, (shape, 0.5, frac), (0.5, frac)):
        _close(tpipe.crop_resize_with(torch.from_numpy(x), *draws, frac), want)


def test_crop_is_shared_across_a_clips_frames():
    x = torch.from_numpy(_x((2, 3, 20, 20, 3)))
    x[:, 1] = x[:, 0]
    off = torch.tensor([1, 4])
    got = tpipe.crop_resize_with(x, off, off.flip(0), torch.tensor([True, True]), 0.75)
    torch.testing.assert_close(got[:, 1], got[:, 0], rtol=0, atol=0)
    assert not torch.equal(got, x)


@pytest.mark.parametrize("shape,strength", [(SHAPES[0], 0.2), (SHAPES[1], 0.6)])
def test_color_jitter_matches_jax(shape, strength):
    x = _x(shape)
    for draws, want in _cases(_jitter_draws, jpipe.color_jitter, x, (shape[0], 0.5, strength),
                              (0.5, strength)):
        _close(tpipe.jitter_with(torch.from_numpy(x), *draws), want)


@pytest.mark.parametrize("shape,kwargs", [
    (SQUARE[0], dict(rot90_prob=0.5, crop_prob=0.5, jitter_prob=0.5)),
    (SQUARE[1], dict(rot90_prob=1.0, crop_prob=1.0, crop_frac=0.6, jitter_prob=0.5)),
    (SQUARE[1], {}),
])
def test_augment_geometric_matches_jax(shape, kwargs):
    x = _x(shape)
    jc, tc = jcfg.AugmentConfig(**kwargs), tcfg.AugmentConfig(**kwargs)
    for draws, want in _cases(_geometric_draws, jpipe.augment_geometric, x, (shape, tc), (jc,)):
        _close(tpipe.augment_geometric_with(torch.from_numpy(x), tc, draws), want)


@pytest.mark.parametrize("shape,kwargs", [(SHAPES[0], {}), (SHAPES[1], dict(noise_prob=0.5, blackout_size=8))])
def test_augment_denoising_matches_jax(shape, kwargs):
    """Every combination of the flip, noise and blackout gates that 40 keys
    give, including the reference's quirk: when the noise gate fires, the
    noise goes onto the unflipped image, so the flip is dropped."""
    x = _x(shape)
    jc, tc = jcfg.AugmentConfig(**kwargs), tcfg.AugmentConfig(**kwargs)
    cases = set()
    for draws, want in _cases(_denoising_draws, jpipe.augment_denoising, x, (shape, tc), (jc,), n=40):
        gates = (bool(draws["flip"][0]), bool(draws["noise_gate"]), bool(draws["patch_gate"]))
        cases.add(gates)
        got = tpipe.augment_denoising_with(torch.from_numpy(x), tc, draws)
        _close(got, want, atol=1e-6)
        if gates[0] and gates[1]:
            unflipped = tpipe.noise_with(torch.from_numpy(x), draws["noise"], tc.noise_std)
            if gates[2]:
                unflipped = tpipe.blackout_with(unflipped, *draws["blackout"], tc.blackout_size)
            torch.testing.assert_close(got, unflipped, rtol=0, atol=0)
    assert {(True, True), (True, False), (False, False), (False, True)} == {c[:2] for c in cases}


@pytest.mark.parametrize("shape", SHAPES)
def test_corrupt_for_test_matches_jax(shape):
    x = _x(shape)
    jc, tc = jcfg.AugmentConfig(), tcfg.AugmentConfig()
    h, w, n, size = shape[-3], shape[-2], tc.max_blackout_patches, tc.test_blackout_size
    for draws, want in _cases(_blackout_draws, jpipe.corrupt_for_test, x, (h, w, n, size), (jc,)):
        _exact(tpipe.blackout_with(torch.from_numpy(x), *draws, size), want)


def _public(name, x, gen):
    cfg = tcfg.AugmentConfig(rot90_prob=0.5, crop_prob=0.5, jitter_prob=0.5)
    return {
        "hflip": lambda: tpipe.random_hflip(gen, x),
        "blackout": lambda: tpipe.random_blackout(gen, x),
        "rot90": lambda: tpipe.random_rot90(gen, x, 0.5),
        "crop": lambda: tpipe.random_crop_resize(gen, x, 0.5, 0.875),
        "jitter": lambda: tpipe.color_jitter(gen, x, 0.5, 0.2),
        "geometric": lambda: tpipe.augment_geometric(gen, x, cfg),
        "denoising": lambda: tpipe.augment_denoising(gen, x, cfg),
        "corrupt": lambda: tpipe.corrupt_for_test(gen, x, cfg),
    }[name]()


@pytest.mark.parametrize("name", ["hflip", "blackout", "rot90", "crop", "jitter", "geometric",
                                  "denoising", "corrupt"])
def test_public_forms_are_seeded_and_keep_shape(name):
    x = torch.from_numpy(_x((4, 2, 24, 24, 3)))
    a = _public(name, x, torch.Generator().manual_seed(3))
    b = _public(name, x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == x.shape and a.dtype == x.dtype
    outs = [_public(name, x, torch.Generator().manual_seed(s)) for s in range(16)]
    assert any(not torch.equal(o, outs[0]) for o in outs), "the draws never change the batch"


def test_draws_stay_in_jax_ranges():
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(4096, 20, 28, 3)
    n, r0, c0 = tpipe.blackout_draws(gen, x, 3, 16)
    assert 0 <= int(n) <= 3 and r0.max() <= 20 - 16 and c0.max() <= 28 - 16
    n, r0, c0 = tpipe.blackout_draws(gen, x, 3, 32)  # no room: corners at 0, as JAX gives
    assert r0.abs().max() == 0 and c0.abs().max() == 0
    (ks,) = tpipe.rot90_draws(gen, x, 0.25)
    assert set(ks.tolist()) == {0, 1, 2, 3} and 0.7 < float((ks == 0).float().mean()) < 0.85
    off_h, off_w, gate = tpipe.crop_draws(gen, x, 0.5, 0.75)
    assert off_h.max() == 20 - 15 and off_w.max() == 28 - 21 and off_h.min() == off_w.min() == 0
    assert 0.45 < float(gate.float().mean()) < 0.55
    bright, contrast, sat, gate = tpipe.jitter_draws(gen, x, 0.5, 0.2)
    assert -0.2 <= float(bright.min()) and float(bright.max()) < 0.2
    assert 0.8 <= float(torch.minimum(contrast, sat).min()) and float(torch.maximum(contrast, sat).max()) < 1.2


# ------------------------------------------------------- resize and layouts


@pytest.mark.parametrize("size", [(16, 10), (40, 36), (28, 20), (13, 30)])
@pytest.mark.parametrize("lead", [(2,), (2, 3)])
def test_resize_bilinear_matches_jax(size, lead):
    """Upscale and downscale of (..., H, W, C), edges included."""
    x = _x(lead + (20, 28, 3))
    want = jax.image.resize(jnp.asarray(x), lead + size + (3,), "bilinear")
    _close(tpipe.resize_bilinear(torch.from_numpy(x), size), want)


@pytest.mark.parametrize("name,shape", [
    ("ncthw_to_nthwc", (2, 3, 4, 5, 6)),
    ("ntchw_to_nthwc", (2, 3, 4, 5, 6)),
    ("nthwc_to_ntchw", (2, 3, 4, 5, 6)),
    ("nchw_to_nhwc", (2, 3, 4, 5)),
    ("nhwc_to_nchw", (2, 3, 4, 5)),
])
def test_layout_matches_jax(name, shape):
    x = _x(shape)
    _exact(getattr(tlayout, name)(torch.from_numpy(x)), getattr(jlayout, name)(jnp.asarray(x)))


# -------------------------------------------------------------- synthetic


@pytest.mark.parametrize("name,args", [
    ("SyntheticImages", (2, 8, 3)),
    ("SyntheticImageMasks", (2, 8, 3)),
    ("SyntheticClips", (2, 3, 8, 3)),
])
def test_synthetic_generators_match_jax(name, args):
    got, want = getattr(tsyn, name)(*args, seed=5), getattr(jsyn, name)(*args, seed=5)
    assert len(got) == len(want) == args[-1]
    for a, b in zip(got, want):
        for u, v in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert u.dtype == v.dtype == np.uint8
            np.testing.assert_array_equal(u, v)


# ------------------------------------------------------------ train step


def test_train_step_runs_with_augment_config():
    """A non-default AugmentConfig reaches the step: it runs, learns, and
    its augmentations draw from the state's noise generator."""
    cfg = tcfg.flagship_video_config(image_size=32, num_heads=8, hidden_dim=32, attn_impl="flash")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout_rate=0.0),
                              temporal=dataclasses.replace(cfg.temporal, dropout_rate=0.0))
    batch = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8))
    aug = tcfg.AugmentConfig(rot90_prob=0.5, crop_prob=0.5, jitter_prob=0.5)
    losses = {}
    for name, a in (("aug", aug), ("none", tcfg.AugmentConfig())):
        model = tvideo.VideoHybridNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        state = tstate.create_train_state(model, tstate.make_optimizer(1e-3), rng=3)
        before = [p.detach().clone() for p in model.parameters()]
        state, metrics = tsteps.make_video_train_step(32, loss="mse", aug=a)(state, batch)
        assert state.step == 1 and np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["psnr"]))
        assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), before))
        losses[name] = float(metrics["loss"])
    assert losses["aug"] != losses["none"]
