"""The port's autotuner (``tchvp_tpu_torch/kernels/autotune.py``) against the
JAX package's (``tchvp_tpu/kernels/autotune.py``), and the kernels' block
arguments on the CPU.

* the cache key is JAX's string for the same device kind, shape, window
  and dtype; record/lookup round-trip; precedence explicit > tuned > the
  shipped defaults (as ``tests/test_autotune.py`` holds JAX's);
  ``TCHVP_AUTOTUNE_CACHE=0`` ignores entries; a block outside the
  instantiated candidates raises;
* the tuner loop, its measure function replaced by a stub, records the
  fastest candidate and skips one that raises; ``tune`` exits on the CPU;
* ``mha``, ``windowed_mha`` and ``windowed_mha_halo`` with every candidate
  give the plain versions' results on the CPU, forward and gradients; the
  plain plans and pass-A scratch at 128-row tiles cover the band once and
  unpack to the same gradients.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import autotune as jautotune
from tchvp_tpu_torch import cli
from tchvp_tpu_torch.kernels import autotune, build
from tchvp_tpu_torch.kernels import flash_attention as fa
from tchvp_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SHAPE = (2, 2, 256, 64)


@pytest.fixture
def tuned_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("TCHVP_AUTOTUNE_CACHE", path)
    autotune.reload()
    yield path
    autotune.reload()


@pytest.mark.parametrize("kernel,shape,window,tdtype,jdtype", [
    ("flash", (8, 8, 2048, 64), 0, torch.bfloat16, jnp.bfloat16),
    ("band", (2, 8, 256, 512), 64, torch.float32, jnp.float32),
    ("halo", (4, 8, 128, 1152), 64, "bfloat16", "bfloat16"),
])
def test_key_is_jaxs_for_the_same_device_kind(monkeypatch, kernel, shape, window, tdtype, jdtype):
    monkeypatch.setattr(jautotune, "_device_kind", lambda: "NVIDIA_H100_80GB_HBM3")
    monkeypatch.setattr(autotune, "_device_kind", lambda device=None: "NVIDIA_H100_80GB_HBM3")
    assert autotune._key(kernel, shape, window, tdtype) == jautotune._key(kernel, shape, window, jdtype)


def test_device_kind_of_a_cpu_tensor_is_cpu():
    assert autotune._device_kind(torch.device("cpu")) == "cpu"
    assert autotune._key("flash", SHAPE, 0, torch.float32, "cpu") == "cpu|flash|2x2x256x64|w0|float32"


def test_candidates_are_the_sources_instantiations():
    """FLASH_BLOCKS and WIN_BLOCKS are the one list of candidates: no CUDA
    source defines its own, the build compiles one translation unit a
    candidate, and each source's instantiation lines, preprocessed with a
    unit's header, instantiate that unit's candidate and (in unit 0, which
    holds the launchers) declare the others extern."""
    import subprocess

    assert (fa.FLASH_BLOCKS, fa.WIN_BLOCKS) == (build.FLASH_BLOCKS, build.WIN_BLOCKS)
    assert fa.FLASH_BLOCKS[0] == (fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)
    assert fa.WIN_BLOCKS[0] == fa.DEFAULT_BAND_ROWS
    assert build.UNIT_BLOCKS == {"flash_fwd": fa.FLASH_BLOCKS, "flash_bwd": fa.FLASH_BLOCKS,
                                 "band_attention": fa.WIN_BLOCKS, "halo_attention": fa.WIN_BLOCKS}
    for path in build.CSRC.iterdir():
        assert not re.search(r"#define TCHVP_(FLASH|WIN)_BLOCKS", path.read_text()), path
    for path, inst, lib in (("flash_fwd.cu", "TCHVP_FWD_INST", "flash_fwd"),
                            ("flash_bwd.cu", "TCHVP_BWD_INST", "flash_bwd"),
                            ("window_fwd.cuh", "TCHVP_WIN_FWD_INST", "band_attention"),
                            ("window_bwd.cuh", "TCHVP_WIN_BWD_INST", "band_attention")):
        lines = [ln for ln in (build.CSRC / path).read_text().splitlines()
                 if re.match(rf"(#define {inst}_(DEF|EXTERN)\(|TCHVP_(UNIT|EXTERN)_BLOCKS\({inst}_)", ln)]
        assert len(lines) == 4, path
        blocks = build.UNIT_BLOCKS[lib]
        for unit in range(len(blocks)):
            text = (build.unit_header(blocks, unit) + f"#define {inst}(PREFIX, ...) PREFIX<__VA_ARGS__>;\n"
                    + "\n".join(lines) + "\n")
            made = subprocess.run(["cpp", "-P", "-x", "c++", "-"], input=text, capture_output=True,
                                  text=True, check=True).stdout
            made = [m for m in re.sub(r"\s", "", made).split(";") if m]
            want = [f"<{','.join(map(str, b)) if isinstance(b, tuple) else b}>" for b in blocks]
            assert made == ([want[unit]] + [f"extern{w}" for w in want[1:]] if unit == 0
                            else [want[unit]]), (path, unit, made)


def test_record_lookup_roundtrip(tuned_cache):
    assert autotune.lookup("band", SHAPE, 64, torch.bfloat16, "cpu") is None
    autotune.record("band", SHAPE, 64, torch.bfloat16, {"block_rows": 128}, 1.23, "fwdbwd", "cpu")
    assert autotune.lookup("band", SHAPE, 64, torch.bfloat16, "cpu") == {"block_rows": 128}
    for near in (("halo", SHAPE, 64, torch.bfloat16), ("band", SHAPE, 32, torch.bfloat16),
                 ("band", SHAPE, 64, torch.float32)):
        assert autotune.lookup(*near, "cpu") is None
    autotune.reload()
    assert autotune.lookup("band", SHAPE, 64, torch.bfloat16, "cpu") == {"block_rows": 128}
    with open(tuned_cache) as f:
        data = json.load(f)
    (key,) = data
    assert key == "cpu|band|2x2x256x64|w64|bfloat16"
    assert data[key] == {"params": {"block_rows": 128}, "ms": 1.23, "mode": "fwdbwd"}


def test_resolution_precedence(tuned_cache):
    assert autotune.band_rows("band", SHAPE, 64, torch.bfloat16, None, "cpu") == fa.DEFAULT_BAND_ROWS == 64
    assert autotune.flash_blocks(SHAPE, torch.bfloat16, None, None, "cpu") == (
        fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K) == (64, 64)
    autotune.record("band", SHAPE, 64, torch.bfloat16, {"block_rows": 128}, 1.0, "fwd", "cpu")
    autotune.record("flash", SHAPE, 0, torch.bfloat16, {"block_q": 128, "block_k": 32}, 1.0, "fwd", "cpu")
    assert autotune.band_rows("band", SHAPE, 64, torch.bfloat16, None, "cpu") == 128
    assert autotune.flash_blocks(SHAPE, torch.bfloat16, None, None, "cpu") == (128, 32)
    assert autotune.band_rows("band", SHAPE, 64, torch.bfloat16, 64, "cpu") == 64
    assert autotune.flash_blocks(SHAPE, torch.bfloat16, 64, 64, "cpu") == (64, 64)
    # A partial explicit pair takes the other half from the cache, as JAX's.
    assert autotune.flash_blocks(SHAPE, torch.bfloat16, 64, None, "cpu") == (64, 32)


def test_disabled_cache_ignores_entries(tuned_cache, monkeypatch):
    autotune.record("band", SHAPE, 64, torch.bfloat16, {"block_rows": 128}, 1.0, "fwd", "cpu")
    monkeypatch.setenv("TCHVP_AUTOTUNE_CACHE", "0")
    autotune.reload()
    assert autotune.cache_path() is None
    assert autotune.lookup("band", SHAPE, 64, torch.bfloat16, "cpu") is None
    assert autotune.band_rows("band", SHAPE, 64, torch.bfloat16, None, "cpu") == fa.DEFAULT_BAND_ROWS


@pytest.mark.parametrize("call", [
    lambda: autotune.flash_blocks(SHAPE, torch.float32, 256, 64, "cpu"),
    lambda: autotune.flash_blocks(SHAPE, torch.float32, 128, 128, "cpu"),
    lambda: autotune.band_rows("band", SHAPE, 64, torch.float32, 256, "cpu"),
    lambda: fa.mha(*torch.zeros(3, 1, 2, 40, 8), block_q=32, block_k=64),
    lambda: fa.windowed_mha(*torch.zeros(3, 1, 2, 40, 8), window_size=8, block_rows=32),
], ids=["flash 256x64", "flash 128x128", "band 256", "mha", "windowed_mha"])
def test_a_block_outside_the_candidates_raises(tuned_cache, call):
    with pytest.raises(ValueError, match="not instantiated"):
        call()


def test_a_cached_block_outside_the_candidates_raises(tuned_cache):
    autotune.record("flash", SHAPE, 0, torch.float32, {"block_q": 512, "block_k": 64}, 1.0, "fwd", "cpu")
    with pytest.raises(ValueError, match="not instantiated"):
        autotune.flash_blocks(SHAPE, torch.float32, None, None, "cpu")


def test_tuner_records_the_fastest_and_skips_a_failure(tuned_cache, monkeypatch, capsys):
    times = {(64, 64): 2.0, (128, 64): 1.5, (64, 32): None, (128, 32): 3.0}
    seen = []

    def measure(fn, *args, mode, iters):
        out = fn(*args)  # the candidate's call runs (the plain version on the CPU)
        assert out.shape == args[0].shape and mode == "fwd" and iters == 3
        blocks = FakeBlocks.last
        seen.append(blocks)
        if times[blocks] is None:
            raise ValueError(f"blocks {blocks} do not fit")
        return times[blocks]

    class FakeBlocks:
        last = None

    real_mha = fa.mha

    def spy(*a, block_q=None, block_k=None, **k):
        FakeBlocks.last = (block_q, block_k)
        return real_mha(*a, block_q=block_q, block_k=block_k, **k)

    monkeypatch.setattr(autotune, "_measure", measure)
    monkeypatch.setattr(fa, "mha", spy)
    params, ms = autotune.tune_flash((1, 2, 100, 8), "float32", mode="fwd", iters=3, device="cpu")
    assert params == {"block_q": 128, "block_k": 64} and ms == 1.5
    assert seen == list(fa.FLASH_BLOCKS)
    assert "(64,32): FAILED ValueError" in capsys.readouterr().out
    assert autotune.lookup("flash", (1, 2, 100, 8), 0, "float32", "cpu") == params


def test_banded_tuner_records_halo_entries(tuned_cache, monkeypatch):
    monkeypatch.setattr(autotune, "_measure", lambda fn, *a, mode, iters: float(fn(*a).shape[2]) + 1.0)
    params, _ = autotune.tune_banded((1, 2, 32, 8), 8, "float32", halo=True, mode="fwd", iters=2, device="cpu",
                                     verbose=False)
    assert params == {"block_rows": 64}
    assert autotune.lookup("halo", (1, 2, 32, 8), 8, "float32", "cpu") == params


def test_every_candidate_failing_raises(tuned_cache, monkeypatch):
    def fail(*a, **k):
        raise ValueError("no")

    monkeypatch.setattr(autotune, "_measure", fail)
    with pytest.raises(RuntimeError, match="every flash candidate failed"):
        autotune.tune_flash((1, 1, 16, 8), "float32", device="cpu", verbose=False)


def test_tune_exits_without_a_card(monkeypatch, tuned_cache):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["tune", "--kernels", "flash,band,halo", "--window", "64"])
    with pytest.raises(SystemExit, match="--shape must be"):
        cli.main(["tune", "--shape", "8x8x64"])


def test_timeit_times_the_card_only():
    with pytest.raises(ValueError, match="CUDA tensor"):
        timing.timeit(lambda x: x, torch.zeros(2))


def test_bump_keeps_leaves_and_integer_steps():
    x = torch.zeros(3, requires_grad=True)
    assert timing._bump(x, 2).requires_grad and timing._bump(x, 2).is_leaf
    assert torch.equal(timing._bump(torch.zeros(2, dtype=torch.int32), 3), torch.ones(2, dtype=torch.int32))
    assert timing._bump(torch.zeros(2, dtype=torch.bool), 1).all()


# ------------------------------------------------------------ the wrappers


def _qkv(shape, seed, extra=0):
    rng = np.random.default_rng(seed)
    b, h, s, dh = shape
    q = torch.from_numpy(rng.standard_normal((b, h, s, dh), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, s + extra, dh), dtype=np.float32)) for _ in range(2))
    return [t.requires_grad_() for t in (q, k, v)]


def _out_and_grads(fn, tensors):
    out = fn(*tensors)
    grads = torch.autograd.grad((out ** 2).sum(), tensors)
    return [out.detach()] + list(grads)


@pytest.mark.parametrize("blocks", fa.FLASH_BLOCKS, ids=lambda b: f"{b[0]}x{b[1]}")
def test_mha_with_blocks_gives_the_plain_result(tuned_cache, blocks):
    tensors = _qkv((1, 2, 70, 8), 0)
    got = _out_and_grads(lambda q, k, v: fa.mha(q, k, v, dropout_rate=0.1, dropout_seed=3, block_q=blocks[0],
                                                block_k=blocks[1]), tensors)
    want = _out_and_grads(lambda q, k, v: fa.mha(q, k, v, dropout_rate=0.1, dropout_seed=3), tensors)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("rows", fa.WIN_BLOCKS)
@pytest.mark.parametrize("halo", [False, True], ids=["band", "halo"])
def test_windowed_wrappers_with_block_rows_give_the_plain_result(tuned_cache, rows, halo):
    w = 8
    if halo:
        tensors = _qkv((1, 2, 32, 8), 1, extra=w)

        def fn(q, k, v, rows_=None):
            return fa.windowed_mha_halo(q, k, v, window_size=w, has_prev=1, block_rows=rows_)
        ref = fa.windowed_mha_halo_reference
        want_out = ref(*(t.detach().reshape(2, *t.shape[2:]) for t in tensors), 8 ** -0.5, w, 1)[0]
    else:
        tensors = _qkv((1, 2, 40, 8), 1)

        def fn(q, k, v, rows_=None):
            return fa.windowed_mha(q, k, v, window_size=w, block_rows=rows_)
        want_out = fa.windowed_mha_reference(*(t.detach().reshape(2, 40, 8) for t in tensors), 8 ** -0.5, w)[0]
    got = _out_and_grads(lambda *t: fn(*t, rows), tensors)
    want = _out_and_grads(fn, tensors)
    torch.testing.assert_close(got[0].reshape(want_out.shape), want_out, atol=1e-6, rtol=0)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=0, rtol=0)


@pytest.mark.parametrize("s,window,halo", [(256, 64, False), (200, 24, False), (128, 64, True), (72, 24, True)])
def test_plans_at_128_rows_cover_the_band_and_unpack_to_its_gradients(s, window, halo):
    """Pass A's plain scratch at 128-row tiles holds every pair of the band
    once and unpacks to the dense dS and P_drop, as at 64."""
    rng = np.random.default_rng(2)
    keys = s + window if halo else s
    q, do = (torch.from_numpy(rng.standard_normal((2, s, 8), dtype=np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, keys, 8), dtype=np.float32)) for _ in range(2))
    has_prev = 1 if halo else None
    if halo:
        out, lse = fa.windowed_mha_halo_reference(q, k, v, 0.3, window, 1, 0.1, 5)
    else:
        out, lse = fa.windowed_mha_reference(q, k, v, 0.3, window, 0.1, 5)
    delta = (do * out).sum(-1)
    dense = {}
    for rows in fa.WIN_BLOCKS:
        plan = fa.window_bwd_plan(s, window, halo, rows)
        scratch = fa.window_bwd_scratch_reference(q, k, v, do, lse, delta, 0.3, window, 0.1, 5, has_prev, rows)
        assert scratch.shape == (2, 2, s, plan.scratch_cols)
        dense[rows] = fa.window_bwd_unpack(scratch, keys, window, has_prev, rows)
        dq = fa.window_bwd_dq_reference(scratch, k, window, has_prev, rows)
        dk, dv = fa.window_bwd_dkv_reference(scratch, q, do, window, has_prev, rows)
        dense[rows] += (dq, dk, dv)
        assert fa.window_plan(s, window, halo, rows).span_cols >= fa.window_plan(s, window, halo).span_cols
    for a, b in zip(dense[64], dense[128]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
