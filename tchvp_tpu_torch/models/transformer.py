"""Temporal transformer of the flagship.

Counterparts of ``tchvp_tpu/models/transformer.py``'s
``TokenMultiheadAttention`` and ``TransformerEncoder``, keeping the
reference's structure: separate q/k/v/out projections, ReLU on the
projected q/k/v (``relu_qkv``), a 1/sqrt(d) scale over the FULL model dim,
one LayerNorm per layer applied to both branch outputs before their
residual adds (``x = x + LN(branch(x))``), the x sqrt(0.5) output scale
(its constant rounded to the activations' dtype first, as JAX does) and
the trailing dropout. Dropout acts in train mode only; its randomness is
drawn from the caller's ``torch.Generator`` up front
(:meth:`TransformerEncoder.draw_dropout`), so a recompute under
``torch.utils.checkpoint`` applies the same masks.

``seq_axis`` (sequence parallelism): under a mesh carrying the axis the
tokens are this rank's block of the sequence, the attention takes its halo
from the left neighbour (``ops/attention.py``), and the dropout draws are
made for the whole sequence, the same on every rank, each keeping its part.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn as nn

from tchvp_tpu_torch.config import TransformerConfig
from tchvp_tpu_torch.ops.attention import (
    attention_core,
    draw_attention_dropout,
    multi_head_attention,
    resolve_impl,
)
from tchvp_tpu_torch.ops.blocks import Dense, draw_keep, dropout
from tchvp_tpu_torch.parallel.mesh import axis_shards

LN_EPS = 1e-5


def scale_out(x: torch.Tensor) -> torch.Tensor:
    """``x * sqrt(0.5)`` with the constant first rounded to x's dtype
    (0.70703125 in bf16), as ``jnp.asarray(math.sqrt(0.5), x.dtype)``."""
    return x * torch.tensor(math.sqrt(0.5), dtype=x.dtype).item()


@dataclasses.dataclass
class TransformerDraws:
    """One train-mode pass's dropout randomness, per layer: the attention
    draw (a kernel seed, or the dense core's or dense band's keep mask) and
    the keep mask of the trailing dropout; None where that dropout is off."""

    attention: List[Optional[torch.Tensor]]
    layer_keep: List[Optional[torch.Tensor]]


class TokenMultiheadAttention(nn.Module):
    """Multi-head self-attention over (B, S, dim) tokens."""

    def __init__(self, dim: int, num_heads: int, relu_qkv: bool = True,
                 attn_dropout: float = 0.1, attn_impl: str = "xla",
                 window_size: int = 0, seq_axis: Optional[str] = None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"input dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.relu_qkv = relu_qkv
        self.attn_dropout = attn_dropout
        self.attn_impl = attn_impl
        self.window_size = window_size
        self.seq_axis = seq_axis
        self.q_linear = Dense(dim, dim)
        self.k_linear = Dense(dim, dim)
        self.v_linear = Dense(dim, dim)
        self.out_linear = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = x.shape[-1]
        q, k, v = self.q_linear(x), self.k_linear(x), self.v_linear(x)
        if self.relu_qkv:
            q, k, v = torch.relu(q), torch.relu(k), torch.relu(v)
        if mask is not None:
            # (B, Sq, Sk) -> (B, 1, Sq, Sk), broadcast across heads.
            mask = (mask != 0)[:, None, :, :]
        out = multi_head_attention(
            q, k, v, self.num_heads,
            impl=self.attn_impl,
            window_size=self.window_size,
            scale=1.0 / math.sqrt(d),  # the full model dim
            mask=mask,
            dropout_rate=self.attn_dropout,
            generator=generator,
            deterministic=not self.training,
            seq_axis=self.seq_axis,
            dropout_draw=dropout_draw,
        )
        return self.out_linear(out)


class TransformerLayer(nn.Module):
    """Attention and FFN branches sharing ONE LayerNorm."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.input_dim
        self.attention = TokenMultiheadAttention(
            d, cfg.num_heads, relu_qkv=cfg.relu_qkv, attn_dropout=cfg.dropout_rate,
            attn_impl=cfg.attn_impl, window_size=cfg.window_size, seq_axis=cfg.seq_axis,
        )
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.ffn1 = Dense(d, cfg.hidden_dim)
        self.ffn2 = Dense(cfg.hidden_dim, d)


def _norm(layer: TransformerLayer, h: torch.Tensor) -> torch.Tensor:
    """The layer's LayerNorm of ``h``, handed on in h's dtype: autocast
    returns it in fp32, flax's ``LayerNorm(dtype)`` rounds it to the compute
    dtype (a no-op outside autocast)."""
    return layer.norm(h).to(h.dtype)


class TransformerEncoder(nn.Module):
    """Stack of :class:`TransformerLayer` over (B, S, input_dim) tokens."""

    def __init__(self, config: TransformerConfig = TransformerConfig()):
        super().__init__()
        if config.num_experts >= 2:
            raise NotImplementedError(
                "the routed MoE FFN (num_experts >= 2) is not ported yet "
                "(ROADMAP.md, modules to port, item 11: ops/moe.py)"
            )
        if config.input_dim % config.num_heads != 0:
            raise ValueError(
                f"input dim {config.input_dim} not divisible by num_heads {config.num_heads}"
            )
        self.config = config
        self.layers = nn.ModuleList(TransformerLayer(config) for _ in range(config.num_layers))

    def draw_dropout(self, x_shape: torch.Size, generator: Optional[torch.Generator],
                     device: torch.device, has_mask: bool = False) -> TransformerDraws:
        """The train-mode dropout randomness of one pass over (B, S, D)
        tokens, drawn from ``generator`` in layer order. Under a mesh
        carrying ``seq_axis`` the tokens are this rank's block of n: the
        draws are made for all n blocks and this rank's part kept."""
        cfg = self.config
        rate = cfg.dropout_rate
        n = cfg.num_layers
        if rate <= 0.0:
            return TransformerDraws([None] * n, [None] * n)
        b, s, d = x_shape
        impl = resolve_impl(cfg.attn_impl, device.type == "cuda", has_mask, cfg.window_size)
        core = attention_core(impl, has_mask, cfg.window_size)
        shards, i = axis_shards(cfg.seq_axis)
        attention, layer_keep = [], []
        for _ in range(n):
            attention.append(draw_attention_dropout(core, (b, cfg.num_heads, s), rate, generator,
                                                    device, cfg.window_size, (shards, i)))
            keep = draw_keep((b, shards * s, d), rate, generator, device)
            layer_keep.append(keep[:, i * s:(i + 1) * s])
        return TransformerDraws(attention, layer_keep)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[TransformerDraws] = None) -> torch.Tensor:
        """``draws`` (train mode): randomness drawn beforehand; without it
        the pass draws its own from ``generator``."""
        cfg = self.config
        rate = cfg.dropout_rate
        if self.training and draws is None:
            draws = self.draw_dropout(x.shape, generator, x.device, mask is not None)
        for i, layer in enumerate(self.layers):
            attn_draw = draws.attention[i] if self.training else None
            x = x + _norm(layer, layer.attention(x, mask=mask, generator=generator,
                                                 dropout_draw=attn_draw))
            h = layer.ffn2(torch.relu(layer.ffn1(x)))
            x = x + _norm(layer, h)
            if cfg.scale_out:
                x = scale_out(x)
            if self.training and rate > 0.0:
                x = dropout(x, rate, None, keep=draws.layer_keep[i])
        return x
