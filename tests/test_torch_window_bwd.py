"""The banded and halo backward's tiling rule, launchers and plain passes.

The tensor-core backward (``csrc/window_bwd.cuh``) runs in three passes
over a scratch: pass A forms dS and P_drop of each 64-row query tile's key
tiles, pass B forms dq from them per query tile and dk/dv per key tile.
Which tiles those are comes from one rule, ``window_bwd_plan`` with
``window_tile_span`` and ``window_query_span`` (the kernels' key_span and
query_span); the C launchers take its numbers as they are. Here, without a
GPU:

* (a) the rule covers every pair of JAX's ``_band_mask`` and, for has_prev
  0 and 1, ``_halo_band_mask`` exactly once, from the query tiles' side
  (pass A and dq) and from the key tiles' side (dk/dv), on a grid of (S, w)
  with ragged S and windows 64 does not divide; the spans fit the scratch
  and the key tiles cover k; with has_prev 0 the halo's tiles are the
  band's shifted by w, so the two walk the same pairs in the same order;
* (b) each C launcher's parameter count, parsed from the ``extern "C"``
  blocks of ``csrc/*.cu``, equals the argument types the port binds, for
  all five libraries;
* (c) the wrappers refuse, before any build or launch, the inputs the
  launchers do not take;
* (d) the passes' plain versions chained (scratch, then dq and dk/dv from
  it) give the windowed plain versions' gradients, and JAX's Pallas
  kernels' in interpret mode (atol 1e-5 and 1e-4 x the largest gradient).
"""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.kernels import fused_tail as tft
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = tfa.WIN_BLOCK_K
CSRC = Path(tfa.__file__).parent / "csrc"

# (S, window): one window, whole windows, ragged S, windows 16 or 64 does
# not divide, a window wider than a tile, the main path's shapes.
GRID = [(1, 1), (40, 16), (64, 64), (72, 24), (96, 24), (100, 7), (200, 64), (256, 64),
        (256, 200), (130, 130), (128, 64), (200, 200), (80, 32)]


def _jax_band(s, w):
    return np.asarray(jfa._band_mask((s, s), 0, 0, w, s))


def _jax_halo(s, w, no_prev):
    return np.asarray(jfa._halo_band_mask((s, s + w), 0, 0, w, s, jnp.asarray(no_prev)))


def _query_side(s, w, halo, no_prev, plan, keys):
    """How often pass A (and dq) visits each (row, key) pair."""
    seen = np.zeros((s, keys), dtype=np.int64)
    for q0 in range(0, s, TILE):
        base, n = tfa.window_tile_span(q0, s, w, halo, no_prev)
        assert 1 <= n <= plan.span_tiles, (q0, n)
        assert (base - plan.tile_base) % TILE == 0
        for j in range(n):
            k0 = base + j * TILE
            seen[q0:q0 + TILE, max(k0, 0):max(min(k0 + TILE, keys), 0)] += 1
    return seen


def _key_side(s, w, halo, no_prev, plan, keys):
    """How often dk/dv visits each (row, key) pair: each key tile walks the
    query tiles of its query span whose key span holds it."""
    seen = np.zeros((s, keys), dtype=np.int64)
    assert plan.tile_base + plan.key_tiles * TILE >= keys > plan.tile_base + (plan.key_tiles - 1) * TILE
    for j in range(plan.key_tiles):
        k0 = plan.tile_base + j * TILE
        lo, hi = tfa.window_query_span(max(k0, 0), min(k0 + TILE, keys) - 1, s, w, halo, no_prev)
        for qt in range(lo // TILE, -(-hi // TILE) if hi > lo else lo // TILE):
            base, n = tfa.window_tile_span(qt * TILE, s, w, halo, no_prev)
            if base <= k0 < base + n * TILE:
                seen[qt * TILE:(qt + 1) * TILE, max(k0, 0):min(k0 + TILE, keys)] += 1
    return seen


def _check_cover(mask, seen):
    assert mask.shape == seen.shape
    assert (seen[mask] == 1).all(), "a pair of the band is visited other than once"


@pytest.mark.parametrize("s,window", GRID)
def test_window_bwd_plan_covers_jax_band_once(s, window):
    w = min(window, s)  # the wrapper's window for the band
    plan = tfa.window_bwd_plan(s, w, False)
    assert plan.tile_base == 0 and plan.scratch_cols == plan.span_tiles * TILE
    mask = _jax_band(s, w)
    _check_cover(mask, _query_side(s, w, False, False, plan, s))
    _check_cover(mask, _key_side(s, w, False, False, plan, s))


@pytest.mark.parametrize("s,window", GRID + [(72, 100), (64, 96)])
@pytest.mark.parametrize("has_prev", [0, 1])
def test_window_bwd_plan_covers_jax_halo_band_once(s, window, has_prev):
    plan = tfa.window_bwd_plan(s, window, True)
    assert -TILE < plan.tile_base <= 0 and (window - plan.tile_base) % TILE == 0
    mask = _jax_halo(s, window, has_prev == 0)
    no_prev = has_prev == 0
    _check_cover(mask, _query_side(s, window, True, no_prev, plan, s + window))
    _check_cover(mask, _key_side(s, window, True, no_prev, plan, s + window))


@pytest.mark.parametrize("s,window", [(sw[0], sw[1]) for sw in GRID if sw[1] <= sw[0]])
def test_halo_without_prev_walks_the_bands_tiles(s, window):
    """With has_prev 0 the halo's spans are the band's on the local
    sequence, shifted by w, tile for tile: the same pairs in the same order,
    so the kernels' sums are the same."""
    for q0 in range(0, s, TILE):
        base, n = tfa.window_tile_span(q0, s, window, False)
        assert tfa.window_tile_span(q0, s, window, True, no_prev=True) == (base + window, n)
    band, halo = tfa.window_bwd_plan(s, window, False), tfa.window_bwd_plan(s, window, True)
    for j in range(band.key_tiles):
        k0 = j * TILE
        first, last = k0, min(k0 + TILE, s) - 1
        assert (tfa.window_query_span(first, last, s, window, False)
                == tfa.window_query_span(first + window, last + window, s, window, True, no_prev=True))
        assert (k0 + window - halo.tile_base) % TILE == 0


def test_window_bwd_plan_at_the_main_paths_shapes():
    # Config 2 and windowed training (S 256, w 64) and their shards (S 128, k_ext 192).
    assert tfa.window_bwd_plan(256, 64, False) == tfa.WindowBwdPlan(2, 4, 0)
    assert tfa.window_bwd_plan(128, 64, True) == tfa.WindowBwdPlan(2, 3, 0)
    assert tfa.window_bwd_plan(72, 24, True) == tfa.WindowBwdPlan(3, 3, -40)


def _c_launchers(source: str) -> dict:
    """{launcher: parameter count} of the extern "C" block of a .cu file."""
    block = source[source.index('extern "C" {'):]
    found = {}
    for name, params in re.findall(r"(tchvp_\w+)\(([^)]*)\)\s*\{", block):
        found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def _bound_launchers(lib_name: str) -> dict:
    if lib_name == "fused_tail":
        fake = types.SimpleNamespace(tchvp_fused_tail=types.SimpleNamespace(),
                                     tchvp_cuda_error_string=types.SimpleNamespace())
        tft.bind(fake)
        return {"tchvp_fused_tail": len(fake.tchvp_fused_tail.argtypes),
                "tchvp_cuda_error_string": len(fake.tchvp_cuda_error_string.argtypes)}
    bound = {fn: len(types_) for fn, types_ in tfa._LAUNCHERS[lib_name].items()}
    bound["tchvp_cuda_error_string"] = 1  # _kernel_lib binds it as (int)
    return bound


@pytest.mark.parametrize("lib_name", ["flash_fwd", "flash_bwd", "band_attention", "halo_attention", "fused_tail"])
def test_launcher_parameter_counts_match_the_sources(lib_name):
    in_source = _c_launchers((CSRC / f"{lib_name}.cu").read_text())
    assert in_source == _bound_launchers(lib_name)


def _band_args(bh=2, s=40, dh=8, dtype=torch.float32):
    q, k, v, do = (torch.zeros(bh, s, dh, dtype=dtype) for _ in range(4))
    lse, delta = torch.zeros(bh, s), torch.zeros(bh, s)
    return [q, k, v, do, lse, delta, 0.3, 16, 0.0, 0]


def _halo_args(bh=2, s=32, dh=8, w=16):
    q, do = torch.zeros(bh, s, dh), torch.zeros(bh, s, dh)
    k, v = torch.zeros(bh, s + w, dh), torch.zeros(bh, s + w, dh)
    return [q, k, v, do, torch.zeros(bh, s), torch.zeros(bh, s), 0.3, w, 1, 0.0, 0]


def _with(args, i, value):
    args = list(args)
    args[i] = value
    return args


REFUSED_DS = [
    ("fp16", lambda: _band_args(dtype=torch.float16), TypeError, "float32 or bfloat16"),
    ("do shape", lambda: _with(_band_args(), 3, torch.zeros(2, 41, 8)), ValueError, "does not match q"),
    ("k dtype", lambda: _with(_band_args(), 1, torch.zeros(2, 40, 8, dtype=torch.bfloat16)), ValueError,
     "does not match q"),
    ("strided q", lambda: _with(_band_args(), 0, torch.zeros(2, 8, 40).transpose(1, 2)), ValueError,
     "contiguous"),
    ("window 0", lambda: _with(_band_args(), 7, 0), ValueError, "window >= 1"),
    ("lse shape", lambda: _with(_band_args(), 4, torch.zeros(2, 41)), ValueError, "lse"),
    ("delta dtype", lambda: _with(_band_args(), 5, torch.zeros(2, 40, dtype=torch.float64)), ValueError, "delta"),
    ("cpu tensors", _band_args, ValueError, "CUDA tensors"),
]


@pytest.mark.parametrize("case", REFUSED_DS, ids=[c[0] for c in REFUSED_DS])
def test_band_pass_a_refuses_on_the_cpu_side(case):
    _, make, error, match = case
    with pytest.raises(error, match=match):
        tfa.band_bwd_ds_cuda(*make())


REFUSED_HALO = [
    ("k_ext of S rows", lambda: _with(_with(_halo_args(), 1, torch.zeros(2, 32, 8)), 2, torch.zeros(2, 32, 8)),
     ValueError, "k_ext"),
    ("do shape", lambda: _with(_halo_args(), 3, torch.zeros(2, 33, 8)), ValueError, "does not match q"),
    ("cpu tensors", _halo_args, ValueError, "CUDA tensors"),
]


@pytest.mark.parametrize("case", REFUSED_HALO, ids=[c[0] for c in REFUSED_HALO])
def test_halo_pass_a_refuses_on_the_cpu_side(case):
    _, make, error, match = case
    with pytest.raises(error, match=match):
        tfa.halo_bwd_ds_cuda(*make())


def _scratch(bh, s, w, halo, dtype=torch.float32, cols=None):
    plan = tfa.window_bwd_plan(s, w, halo)
    return torch.zeros(2, bh, s, plan.scratch_cols if cols is None else cols, dtype=dtype)


REFUSED_B = [
    ("band dq: scratch width", lambda: tfa.band_bwd_dq_cuda(_scratch(2, 40, 16, False, cols=192),
                                                            torch.zeros(2, 40, 8), 16), "scratch"),
    ("band dq: k rows", lambda: tfa.band_bwd_dq_cuda(_scratch(2, 40, 16, False), torch.zeros(2, 41, 8), 16), "k:"),
    ("band dq: cpu", lambda: tfa.band_bwd_dq_cuda(_scratch(2, 40, 16, False), torch.zeros(2, 40, 8), 16),
     "CUDA tensors"),
    ("band dkv: scratch dtype", lambda: tfa.band_bwd_dkv_cuda(_scratch(2, 40, 16, False, torch.bfloat16),
                                                              torch.zeros(2, 40, 8), torch.zeros(2, 40, 8), 16),
     "scratch"),
    ("band dkv: do shape", lambda: tfa.band_bwd_dkv_cuda(_scratch(2, 40, 16, False), torch.zeros(2, 40, 8),
                                                         torch.zeros(2, 40, 9), 16), "does not match q"),
    ("halo dq: k_ext rows", lambda: tfa.halo_bwd_dq_cuda(_scratch(2, 32, 16, True), torch.zeros(2, 32, 8), 16, 1),
     "k:"),
    ("halo dkv: scratch of the band", lambda: tfa.halo_bwd_dkv_cuda(_scratch(2, 32, 24, False), torch.zeros(2, 32, 8),
                                                                    torch.zeros(2, 32, 8), 24, 1), "scratch"),
    ("halo dkv: cpu", lambda: tfa.halo_bwd_dkv_cuda(_scratch(2, 32, 16, True), torch.zeros(2, 32, 8),
                                                    torch.zeros(2, 32, 8), 16, 1), "CUDA tensors"),
]


@pytest.mark.parametrize("case", REFUSED_B, ids=[c[0] for c in REFUSED_B])
def test_pass_b_refuses_on_the_cpu_side(case):
    _, call, match = case
    with pytest.raises(ValueError, match=match):
        call()


def _inputs(bh, s, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((bh, s, dh), (bh, kv, dh), (bh, kv, dh), (bh, s, dh))]


# (BH, S, Dh, window, has_prev or None, dropout): ragged S, w not dividing 64,
# a span of several key tiles, the halo with and without its context window.
CHAIN_CASES = [(2, 40, 8, 16, None, 0.1), (2, 96, 6, 24, None, 0.0), (1, 130, 4, 100, None, 0.1),
               (2, 72, 6, 24, 0, 0.1), (2, 72, 6, 24, 1, 0.1), (1, 64, 5, 80, 1, 0.0)]


@pytest.mark.parametrize("bh,s,dh,w,has_prev,rate", CHAIN_CASES)
def test_plain_passes_give_the_windowed_gradients(bh, s, dh, w, has_prev, rate):
    halo = has_prev is not None
    q, k, v, do = _inputs(bh, s, s + w if halo else s, dh, seed=s + w)
    if halo:
        out, lse = tfa.windowed_mha_halo_reference(q, k, v, 0.3, w, has_prev, rate, 9)
    else:
        out, lse = tfa.windowed_mha_reference(q, k, v, 0.3, w, rate, 9)
    delta = (do * out).sum(-1)
    scratch = tfa.window_bwd_scratch_reference(q, k, v, do, lse, delta, 0.3, w, rate, 9, has_prev)
    plan = tfa.window_bwd_plan(s, w if halo else min(w, s), halo)
    assert scratch.shape == (2, bh, s, plan.scratch_cols)
    got = (tfa.window_bwd_dq_reference(scratch, k, w, has_prev),) + tfa.window_bwd_dkv_reference(
        scratch, q, do, w, has_prev)
    if halo:
        args = (q, k, v, do, lse, delta, 0.3, w, has_prev, rate, 9)
        want = (tfa.windowed_mha_halo_bwd_dq_reference(*args),) + tfa.windowed_mha_halo_bwd_dkv_reference(*args)
    else:
        args = (q, k, v, do, lse, delta, 0.3, w, rate, 9)
        want = (tfa.windowed_mha_bwd_dq_reference(*args),) + tfa.windowed_mha_bwd_dkv_reference(*args)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == ref.shape
        torch.testing.assert_close(g, ref, atol=1e-5, rtol=0, msg=name)
    if halo and has_prev == 0:  # the masked context window has no gradient
        assert not got[1][:, :w].any() and not got[2][:, :w].any()


def _jax_grads(fn, q, k, v, ct, **kw):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v, scale=0.3, interpret=True, **kw) * ct)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))]


@pytest.mark.parametrize("has_prev", [None, 0, 1])
def test_plain_passes_match_jax_interpret(has_prev):
    """The chained plain passes against ``jax.grad`` of JAX's Pallas band or
    halo kernels in interpret mode, with dropout: 1e-4 x the largest
    gradient."""
    bh, s, dh, w, rate, seed = 2, 48, 8, 16, 0.1, 7
    halo = has_prev is not None
    q, k, v, ct = _inputs(bh, s, s + w if halo else s, dh, seed=11)
    if halo:
        out, lse = tfa.windowed_mha_halo_reference(q, k, v, 0.3, w, has_prev, rate, seed)
        want = _jax_grads(jfa.windowed_mha_halo, *(t[None] for t in (q, k, v)), ct.numpy()[None],
                          window_size=w, has_prev=has_prev, dropout_rate=rate, dropout_seed=seed)
    else:
        out, lse = tfa.windowed_mha_reference(q, k, v, 0.3, w, rate, seed)
        want = _jax_grads(jfa.windowed_mha, *(t[None] for t in (q, k, v)), ct.numpy()[None],
                          window_size=w, dropout_rate=rate, dropout_seed=seed)
    delta = (ct * out).sum(-1)
    scratch = tfa.window_bwd_scratch_reference(q, k, v, ct, lse, delta, 0.3, w, rate, seed, has_prev)
    got = (tfa.window_bwd_dq_reference(scratch, k, w, has_prev),) + tfa.window_bwd_dkv_reference(
        scratch, q, ct, w, has_prev)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        ref = ref[0]
        assert g.shape == ref.shape
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), name
