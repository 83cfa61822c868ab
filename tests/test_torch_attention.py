"""The port's attention cores and dispatch against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.ops import attention as jatt
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import dispatch_trace


def _tokens(b=2, s=12, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d), dtype=np.float32) for _ in range(3)]


def test_split_and_merge_heads_match_jax():
    x = _tokens()[0]
    split = tatt._split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(split.numpy(), np.asarray(jatt._split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tatt._merge_heads(split).numpy(), x)


@pytest.mark.parametrize("with_mask", [False, True])
def test_sdpa_xla_matches_jax(with_mask):
    q, k, v = (t.reshape(2, 12, 4, 4).transpose(0, 2, 1, 3) for t in _tokens())
    mask = None
    if with_mask:
        mask = np.random.default_rng(1).random((2, 1, 12, 12)) > 0.3
    want = jatt.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.25,
                         mask=None if mask is None else jnp.asarray(mask))
    got = tatt.sdpa_xla(*(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)),
                        scale=0.25, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sdpa_xla_dropout_draws_from_the_generator():
    q, k, v = (torch.from_numpy(t).reshape(2, 12, 4, 4).transpose(1, 2) for t in _tokens())
    outs = [tatt.sdpa_xla(q, k, v, dropout_rate=0.5, deterministic=False,
                          generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("impl,markers", [
    ("auto", {"sdpa_xla"}),
    ("xla", {"sdpa_xla"}),
    ("flash", {"flash_mha", "flash_mha_plain"}),
])
def test_dispatch_records_the_core_that_ran(impl, markers):
    q, k, v = (torch.from_numpy(t) for t in _tokens())
    with dispatch_trace.capture() as seen:
        out = tatt.multi_head_attention(q, k, v, 4, impl=impl, scale=0.25)
    assert seen == markers
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want = jatt.multi_head_attention(qj, kj, vj, 4, impl="xla", scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_flash_with_mask_takes_the_dense_core_as_in_jax():
    q, k, v = (torch.from_numpy(t) for t in _tokens())
    mask = torch.ones(2, 1, 12, 12, dtype=torch.bool)
    with dispatch_trace.capture() as seen:
        tatt.multi_head_attention(q, k, v, 4, impl="flash", mask=mask)
    assert seen == {"sdpa_xla"}


def test_flash_dropout_seed_comes_from_the_generator():
    q, k, v = (torch.from_numpy(t) for t in _tokens())

    def run(seed):
        return tatt.multi_head_attention(
            q, k, v, 4, impl="flash", dropout_rate=0.5, deterministic=False,
            generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="Generator"):
        tatt.multi_head_attention(q, k, v, 4, impl="flash", dropout_rate=0.5, deterministic=False)


@pytest.mark.parametrize("kwargs", [
    {"impl": "windowed", "window_size": 4, "seq_axis": "seq"},
    {"impl": "windowed", "seq_axis": "seq"},
    {"impl": "flash", "window_size": 4, "seq_axis": "seq"},
    {"impl": "auto", "window_size": 4, "seq_axis": "seq"},
    {"impl": "ring", "seq_axis": None},
    {"impl": "flash", "seq_axis": "seq"},
])
def test_unported_cores_raise(kwargs):
    q, k, v = (torch.from_numpy(t) for t in _tokens())
    with dispatch_trace.capture() as seen, pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tatt.multi_head_attention(q, k, v, 4, **kwargs)
    assert not seen
