"""The port's ``mha`` on the strided views of the main path, against JAX.

The flash forward takes ``ops.attention._split_heads``' (B, H, S, Dh) views
of (B, S, D) tokens as they are and returns the (B, H, S, Dh) view of a
(B, S, H, Dh) buffer, so the heads' split and merge copy nothing on the
card; without a gradient to track, ``mha`` skips the autograd Function. On
the CPU the port runs its plain version, so these tests hold the layout
handling and the no-grad path to the contiguous launch (bit for bit) and to
the JAX package's ``mha`` in Pallas interpret mode (forward atol 1e-5,
gradients 1e-4 x the largest gradient), including FCT's small head dims
over ragged sequences with dropout, where the mask must equal JAX's
``attention_dropout_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tchvp_tpu.kernels import flash_attention as jfa
from tchvp_tpu.ops import attention as jatt
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.models.transformer import TokenMultiheadAttention
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import dispatch_trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FWD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _tokens(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d), dtype=np.float32) for _ in range(4)]


def _jax_mha(q, k, v, ct, scale, rate, seed):
    """JAX's mha (interpret mode) on (B, H, S, Dh): output and the gradients of sum(out * ct)."""
    def f(q, k, v):
        out = jfa.mha(q, k, v, scale=scale, interpret=True, dropout_rate=rate,
                      dropout_seed=seed if rate > 0 else None)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_grads_close(got, want):
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_RTOL * scale, rtol=0)


# (B, H, S, Dh, dropout, seed): a flagship-like head dim, then FCT's Dh 4 and 8
# over ragged sequences (S 300 and 257: partial 64-key tiles) with dropout.
CASES = [(2, 2, 40, 24, 0.0, 0), (1, 2, 300, 4, 0.1, 7), (2, 2, 257, 8, 0.1, 3)]


@pytest.mark.parametrize("b,h,s,dh,rate,seed", CASES)
def test_mha_on_split_heads_views_matches_contiguous_and_jax(b, h, s, dh, rate, seed):
    xq, xk, xv, xct = _tokens(b, s, h * dh, seed=s)
    scale = dh ** -0.5
    tokens = [torch.from_numpy(t).requires_grad_() for t in (xq, xk, xv)]
    q4, k4, v4 = (tatt._split_heads(t, h) for t in tokens)
    assert not q4.is_contiguous() and q4.stride(-1) == 1
    ct4 = tatt._split_heads(torch.from_numpy(xct), h)
    out = tfa.mha(q4, k4, v4, scale=scale, dropout_rate=rate, dropout_seed=seed)
    (out * ct4).sum().backward()
    strided_grads = [tatt._split_heads(t.grad, h) for t in tokens]

    copies = [t.detach().contiguous().requires_grad_() for t in (q4, k4, v4)]
    want = tfa.mha(*copies, scale=scale, dropout_rate=rate, dropout_seed=seed)
    (want * ct4).sum().backward()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for got_g, c in zip(strided_grads, copies):
        torch.testing.assert_close(got_g, c.grad, rtol=0, atol=0)

    j_out, j_grads = _jax_mha(*(t.detach().numpy() for t in (q4, k4, v4)), ct4.numpy(), scale, rate, seed)
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=FWD_ATOL, rtol=0)
    _assert_grads_close([g.numpy() for g in strided_grads], j_grads)


@pytest.mark.parametrize("b,h,s,dh,rate,seed", CASES)
def test_no_grad_path_equals_the_autograd_path(b, h, s, dh, rate, seed):
    q, k, v = (torch.from_numpy(t).reshape(b, s, h, dh).transpose(1, 2) for t in _tokens(b, s, h * dh, seed)[:3])
    with torch.no_grad():
        plain = tfa.mha(q, k, v, dropout_rate=rate, dropout_seed=seed)
    tracked = tfa.mha(q.clone().requires_grad_(), k, v, dropout_rate=rate, dropout_seed=seed)
    assert plain.grad_fn is None and tracked.grad_fn is not None
    torch.testing.assert_close(plain, tracked.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("s,dh,seed", [(300, 4, 7), (257, 8, 3)])
def test_fct_head_dims_keep_jax_dropout_mask(s, dh, seed):
    """With value rows 0..Dh-1 one-hot and the others 0, out[.., r, c] is
    the dropped weight of key c < Dh: 0 exactly where JAX's mask drops (r, c)."""
    rate, bh = 0.1, 1
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((1, 2, s, dh), dtype=np.float32) for _ in range(2))
    v = np.zeros((1, 2, s, dh), np.float32)
    v[:, :, :dh] = np.eye(dh, dtype=np.float32)
    out = tfa.mha(*(torch.from_numpy(t) for t in (q, k, v)), scale=0.5, dropout_rate=rate,
                  dropout_seed=seed).numpy()
    keep = np.asarray(jfa.attention_dropout_mask(seed, bh, s, s, rate))[:, :dh]
    np.testing.assert_array_equal(out[0, bh] == 0.0, ~keep)
    want = jfa.mha(*(jnp.asarray(t) for t in (q, k, v)), scale=0.5, interpret=True, dropout_rate=rate,
                   dropout_seed=seed)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_layer_tokens_unchanged_by_the_view_merge(rate):
    """The transformer's attention layer on "flash": its tokens equal, bit
    for bit, the pre-view path (contiguous (BH, S, Dh) copies through the
    plain forward, heads merged by a copy), and JAX's layer on "xla" with
    dropout off."""
    b, s, d, heads = 2, 24, 32, 4
    layer = TokenMultiheadAttention(d, heads, attn_dropout=rate, attn_impl="flash").train(rate > 0)
    torch.manual_seed(0)
    for lin in (layer.q_linear, layer.k_linear, layer.v_linear, layer.out_linear):
        torch.nn.init.normal_(lin.weight, std=d ** -0.5)
    x = torch.from_numpy(_tokens(b, s, d, seed=5)[0])
    draw = torch.tensor([11], dtype=torch.int32) if rate > 0 else None
    with torch.no_grad(), dispatch_trace.capture() as seen:
        got = layer(x, dropout_draw=draw)
    assert "flash_mha_plain" in seen

    with torch.no_grad():
        q, k, v = (torch.relu(lin(x)) for lin in (layer.q_linear, layer.k_linear, layer.v_linear))
        flat = [tatt._split_heads(t, heads).reshape(b * heads, s, d // heads).contiguous() for t in (q, k, v)]
        out, _ = tfa.mha_reference(*flat, d ** -0.5, rate, 11 if rate > 0 else 0)
        want = layer.out_linear(tatt._merge_heads(out.reshape(b, heads, s, d // heads).contiguous()))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if rate == 0.0:
        jax_out = jatt.multi_head_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), heads, impl="xla",
                                            scale=d ** -0.5)
        jax_tokens = np.asarray(jax_out) @ layer.out_linear.weight.detach().numpy().T \
            + layer.out_linear.bias.detach().numpy()
        np.testing.assert_allclose(got.numpy(), jax_tokens, atol=FWD_ATOL, rtol=0)


def test_check_flash_inputs_takes_views_and_refuses_a_strided_head_dim():
    x = torch.zeros(2, 6, 16)
    q4 = tatt._split_heads(x, 4)
    tfa._check_flash_inputs(q4, q4, q4)
    tfa._check_flash_inputs(x, x, x)
    assert tfa._strides4(q4) == (96, 4, 16) and tfa._strides4(x) == (0, 96, 16)
    strided = torch.zeros(2, 4, 6, 8)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        tfa._check_flash_inputs(strided, strided, strided)
    with pytest.raises(ValueError, match="does not match q"):
        tfa._check_flash_inputs(q4, q4[:1], q4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check_flash_inputs(q4.half(), q4.half(), q4.half())
