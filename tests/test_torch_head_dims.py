"""Head dims past 1280 and the banded/halo forwards' tiling rule.

The flagship's head dim is (image_size / 4)^2 / 8, so ``--image-size 416``
gives Dh 1352. The JAX package's ``mha``, ``windowed_mha`` and
``windowed_mha_halo`` take any head dim; so do the port's, on the CUDA
kernels as on their plain versions. Here the port (plain versions on the
CPU) is held to JAX's Pallas kernels in interpret mode at Dh 1352: forward
atol 1e-5, gradients 1e-4 x the largest gradient.

``window_plan`` is the one rule for the tensor-core banded and halo
forwards' scratch (``csrc/window_fwd.cuh``): the C launchers take its
``span_cols`` (the logits pass's 64-key tiles, and where each scratch row's
tile maxima start) and ``scratch_cols`` as they are. The tests check on a
grid of (S, window, has_prev), ragged S and windows 16 does not divide
included, that the 64-row query tiles' key spans (``window_key_span``, the
kernels' ``key_span``) cover every pair of ``band_mask`` and
``halo_band_mask``, stay inside the keys, and fit ``span_cols`` and the
scratch (logits and per-tile row maxima).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu_torch.kernels import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FWD_ATOL, GRAD_RTOL = 1e-5, 1e-4
DH = 1352  # the flagship at 416^2
SCALE = DH ** -0.5  # logits of unit spread, as the flagship's (whose scale is smaller still)
B, H, S, W = 1, 2, 32, 8


@pytest.mark.parametrize("dh", [1352, 4608])
def test_check_inputs_takes_head_dims_past_1280(dh):
    q = torch.zeros(2, 4, dh)
    tfa._check_inputs(q, None, q=q, k=q, v=q)
    tfa._check_inputs(q, 2, q=q, k=q, v=q)


def test_check_inputs_still_refuses_an_empty_head_dim():
    q = torch.zeros(2, 4, 0)
    with pytest.raises(ValueError, match="head dims >= 1"):
        tfa._check_inputs(q, None, q=q)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for shape in shapes]


def _jax(fn, q, k, v, ct, **kw):
    def f(q, k, v):
        out = fn(q, k, v, scale=SCALE, interpret=True, **kw)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(fn, q, k, v, ct, **kw):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = fn(qt, kt, vt, scale=SCALE, **kw)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _close(got, want):
    out, grads = got
    np.testing.assert_allclose(out, want[0], atol=FWD_ATOL, rtol=0, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, want[1]):
        assert g.shape == w.shape
        gmax = np.abs(w).max()
        assert np.abs(g - w).max() <= GRAD_RTOL * gmax, (name, np.abs(g - w).max(), gmax)


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 5)])
def test_mha_at_dh_1352_matches_jax_interpret(rate, seed):
    q, k, v, ct = _arrays([(B, H, S, DH)] * 4, seed=1)
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    _close(_torch(tfa.mha, q, k, v, ct, **kw), _jax(jfa.mha, q, k, v, ct, **kw))


@pytest.mark.parametrize("s", [32, 36])  # whole windows; a partial last window
def test_windowed_mha_at_dh_1352_matches_jax_interpret(s):
    q, k, v, ct = _arrays([(B, H, s, DH)] * 4, seed=2)
    kw = dict(window_size=W, dropout_rate=0.1, dropout_seed=3)
    _close(_torch(tfa.windowed_mha, q, k, v, ct, **kw), _jax(jfa.windowed_mha, q, k, v, ct, **kw))


@pytest.mark.parametrize("has_prev", [0, 1])
def test_windowed_mha_halo_at_dh_1352_matches_jax_interpret(has_prev):
    q, ke, ve, ct = _arrays([(B, H, S, DH), (B, H, S + W, DH), (B, H, S + W, DH), (B, H, S, DH)], seed=4)
    kw = dict(window_size=W, has_prev=has_prev, dropout_rate=0.1, dropout_seed=6)
    _close(_torch(tfa.windowed_mha_halo, q, ke, ve, ct, **kw),
           _jax(jfa.windowed_mha_halo, q, ke, ve, ct, **kw))


def _tile_spans(s, window, halo, no_prev):
    """(first row, last row, lo, hi) of each 64-row query tile."""
    rows = tfa.WIN_BLOCK_Q
    for q0 in range(0, s, rows):
        last = min(s, q0 + rows) - 1
        yield (q0, last) + tfa.window_key_span(q0, last, s, window, halo, no_prev)


def _check_plan(s, window, halo, masks):
    plan = tfa.window_plan(s, window, halo)
    keys = s + window if halo else s
    key_tiles = -(-plan.span_cols // tfa.WIN_BLOCK_K)  # the launcher's logits grid.y
    assert plan.scratch_cols % 4 == 0 and 1 <= plan.span_cols <= keys
    # the span's logits, then the row's max over each key tile
    assert plan.span_cols + key_tiles <= plan.scratch_cols
    for no_prev, mask in masks:
        covered = torch.zeros(s, keys, dtype=torch.bool)
        for first, last, lo, hi in _tile_spans(s, window, halo, no_prev):
            assert 0 <= lo < hi <= keys, (first, lo, hi)
            assert hi - lo <= plan.span_cols
            covered[first:last + 1, lo:hi] = True
        assert mask.shape == covered.shape
        assert not (mask & ~covered).any(), f"pairs outside every tile's span (no_prev {no_prev})"


# (S, window): one window, whole windows, ragged S, windows 16 does not
# divide, a window wider than a 64-row tile, tiles straddling windows.
GRID = [(1, 1), (40, 16), (64, 64), (72, 24), (96, 24), (100, 7), (200, 64), (256, 64),
        (256, 200), (130, 130)]


@pytest.mark.parametrize("s,window", GRID)
def test_window_plan_covers_the_band(s, window):
    w = min(window, s)  # the wrapper's window for the band
    _check_plan(s, w, False, [(False, tfa.band_mask(s, w, torch.device("cpu")))])


@pytest.mark.parametrize("s,window", GRID + [(128, 64), (72, 100)])
def test_window_plan_covers_the_halo_band(s, window):
    cpu = torch.device("cpu")
    _check_plan(s, window, True, [(has_prev == 0, tfa.halo_band_mask(s, window, has_prev, cpu))
                                  for has_prev in (0, 1)])


def test_window_plan_at_the_main_paths_shapes():
    # Config 2 (S 256, w 64, Dh 1152) and its shard (S 128, k_ext 192).
    assert tfa.window_plan(256, 64, False) == tfa.WindowPlan(128, 132)
    assert tfa.window_plan(128, 64, True) == tfa.WindowPlan(128, 132)
    # A span wider than a tile: S 256, w 200 -> the last tile sees all 256 keys.
    assert tfa.window_plan(256, 200, False) == tfa.WindowPlan(256, 260)
