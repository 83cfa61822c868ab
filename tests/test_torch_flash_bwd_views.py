"""The port's flash backward on ``mha``'s strided views, against JAX.

The backward kernels read q, k, v and do as the (B, H, S, Dh) views that
``mha`` gets from ``ops.attention._split_heads`` and write each gradient
into a (B, S, H, Dh) buffer, so ``_residuals`` copies nothing. On the CPU the
port runs the plain versions, which take the same views; these tests hold
the gradients on views to the contiguous path's (bit for bit) and to the
JAX package's ``mha`` gradients with its kernels in Pallas interpret mode,
fp32, atol 1e-5 x the largest gradient, over FCT's small head dims, odd and
wide ones, ragged S and dropout 0 and 0.1 (the mask is JAX's
``attention_dropout_mask`` bit for bit, so dropout changes no tolerance).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import dispatch_trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GRAD_RTOL = 1e-5

# (B, H, S, Dh, dropout, seed): FCT's Dh 4 and 8, an odd Dh (element loads on
# the card), Dh 64 and 98 (8-byte rows in fp32); S ragged against the
# kernels' 64-row tiles.
CASES = [
    (1, 2, 70, 4, 0.1, 3),
    (2, 2, 33, 7, 0.0, 0),
    (1, 2, 130, 8, 0.1, 5),
    (2, 2, 40, 64, 0.0, 0),
    (1, 2, 50, 98, 0.1, 9),
    (1, 3, 67, 98, 0.0, 0),
]


def _tokens(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d), dtype=np.float32) for _ in range(4)]  # q, k, v, cotangent


def _jax_grads(q, k, v, ct, scale, rate, seed):
    def f(q, k, v):
        out = jfa.mha(q, k, v, scale=scale, interpret=True, dropout_rate=rate,
                      dropout_seed=seed if rate > 0 else None)
        return jnp.sum(out * ct)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))]


@pytest.mark.parametrize("b,h,s,dh,rate,seed", CASES)
def test_grads_on_split_heads_views_match_contiguous_and_jax(b, h, s, dh, rate, seed):
    xq, xk, xv, xct = _tokens(b, s, h * dh, seed=100 + s)
    scale = 0.7 * dh ** -0.5
    tokens = [torch.from_numpy(t).requires_grad_() for t in (xq, xk, xv)]
    q4, k4, v4 = (tatt._split_heads(t, h) for t in tokens)
    ct4 = tatt._split_heads(torch.from_numpy(xct), h)
    with dispatch_trace.capture() as seen:
        out = tfa.mha(q4, k4, v4, scale=scale, dropout_rate=rate, dropout_seed=seed)
        grads = torch.autograd.grad(out, (q4, k4, v4), ct4)
    assert seen == {"flash_mha_plain", "flash_mha_bwd_plain"}
    assert all(g.shape == (b, h, s, dh) for g in grads)

    copies = [t.detach().contiguous().requires_grad_() for t in (q4, k4, v4)]
    want = tfa.mha(*copies, scale=scale, dropout_rate=rate, dropout_seed=seed)
    want_grads = torch.autograd.grad(want, copies, ct4.contiguous())
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    j_grads = _jax_grads(*(t.detach().numpy() for t in (q4, k4, v4)), ct4.numpy(), scale, rate, seed)
    atol = GRAD_RTOL * max(np.abs(w).max() for w in j_grads)
    for name, g, w in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0, err_msg=f"d{name}")


def _saved(b, h, s, dh, seed=0):
    """A context as _FlashAttention.forward leaves it, on _split_heads views."""
    xq, xk, xv, xo = _tokens(b, s, h * dh, seed)
    q4, k4, v4, out4 = (tatt._split_heads(torch.from_numpy(t), h) for t in (xq, xk, xv, xo))
    lse = torch.from_numpy(np.random.default_rng(seed).standard_normal((b * h, s), dtype=np.float32))
    return types.SimpleNamespace(saved_tensors=(q4, k4, v4, out4, lse, None), seed=5)


def test_residuals_copy_no_unit_stride_view():
    b, h, s, dh = 2, 3, 10, 4
    ctx = _saved(b, h, s, dh)
    do4 = tatt._split_heads(torch.randn(b, s, h * dh), h)
    (q, k, v, do, lse, delta), seed = tfa._residuals(ctx, do4, views=True)
    for got, saved in zip((q, k, v, do), ctx.saved_tensors[:3] + (do4,)):
        assert got.data_ptr() == saved.data_ptr() and got.stride() == saved.stride()
    assert seed == 5 and lse is ctx.saved_tensors[4]
    out4 = ctx.saved_tensors[3]
    want = (do4 * out4).sum(-1).reshape(b * h, s)
    assert delta.shape == (b * h, s) and delta.is_contiguous() and delta.dtype == torch.float32
    torch.testing.assert_close(delta, want, rtol=0, atol=0)


def test_residuals_copy_a_do_strided_along_the_head_dim_and_keep_the_window_path_contiguous():
    b, h, s, dh = 1, 2, 6, 4
    ctx = _saved(b, h, s, dh, seed=1)
    do_strided = torch.randn(b, h, s, 2 * dh)[..., ::2]
    (q, _, _, do, _, _), _ = tfa._residuals(ctx, do_strided, views=True)
    assert q.data_ptr() == ctx.saved_tensors[0].data_ptr()
    assert do.stride(-1) == 1 and torch.equal(do, do_strided)
    flat = types.SimpleNamespace(
        saved_tensors=tuple(t.reshape(b * h, s, dh) for t in ctx.saved_tensors[:4]) + ctx.saved_tensors[4:],
        seed=0)
    tensors, _ = tfa._residuals(flat, do_strided.reshape(b * h, s, dh))
    assert all(t.is_contiguous() for t in tensors)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_versions_take_views_and_return_their_shape(rate):
    b, h, s, dh = 2, 2, 21, 6
    views = [tatt._split_heads(torch.from_numpy(t), h) for t in _tokens(b, s, h * dh, seed=4)]
    flat = [t.reshape(b * h, s, dh).contiguous() for t in views]
    rng = np.random.default_rng(2)
    lse, delta = (torch.from_numpy(rng.standard_normal((b * h, s), dtype=np.float32)) for _ in range(2))
    args = (lse, delta, 0.4, rate, 17)
    dq = tfa.mha_bwd_dq_reference(*views, *args)
    dk, dv = tfa.mha_bwd_dkv_reference(*views, *args)
    want = tfa.mha_bwd_reference(*flat, *args)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == (b, h, s, dh)
        torch.testing.assert_close(got.reshape(b * h, s, dh), w, rtol=0, atol=0)


def test_grad_buffer_is_a_view_of_a_heads_last_buffer():
    q4 = tatt._split_heads(torch.zeros(2, 5, 12), 3)
    g = tfa.grad_buffer(q4)
    assert g.shape == (2, 3, 5, 4) and g.transpose(1, 2).is_contiguous() and g._base is not None
    flat = tfa.grad_buffer(torch.zeros(6, 5, 4, dtype=torch.bfloat16))
    assert flat.shape == (6, 5, 4) and flat.is_contiguous() and flat.dtype == torch.bfloat16


def test_check_flash_bwd_inputs_takes_views_and_refuses_what_the_kernels_do_not():
    q4 = tatt._split_heads(torch.zeros(2, 6, 16), 4)
    stats = torch.zeros(8, 6)
    tfa._check_flash_bwd_inputs(q4, q4, q4, q4, stats, stats)
    with pytest.raises(ValueError, match="do must have unit stride"):
        tfa._check_flash_bwd_inputs(q4, q4, q4, torch.zeros(2, 4, 6, 8)[..., ::2], stats, stats)
    with pytest.raises(ValueError, match="does not match q"):
        tfa._check_flash_bwd_inputs(q4, q4, q4, q4[:1], stats, stats)
    with pytest.raises(ValueError, match="lse must be contiguous fp32"):
        tfa._check_flash_bwd_inputs(q4, q4, q4, q4, torch.zeros(2, 4, 6), stats)
    with pytest.raises(ValueError, match="delta must be contiguous fp32"):
        tfa._check_flash_bwd_inputs(q4, q4, q4, q4, stats, torch.zeros(6, 8).t())
