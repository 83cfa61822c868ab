"""Temporal transformer of the flagship.

Counterparts of ``tchvp_tpu/models/transformer.py``'s
``TokenMultiheadAttention`` and ``TransformerEncoder``, keeping the
reference's structure: separate q/k/v/out projections, ReLU on the
projected q/k/v (``relu_qkv``), a 1/sqrt(d) scale over the FULL model dim,
one LayerNorm per layer applied to both branch outputs before their
residual adds (``x = x + LN(branch(x))``), the x sqrt(0.5) output scale
and the trailing dropout. Dropout acts in train mode only and draws from
the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from tchvp_tpu_torch.config import TransformerConfig
from tchvp_tpu_torch.ops.attention import multi_head_attention
from tchvp_tpu_torch.ops.blocks import dropout

LN_EPS = 1e-5


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
        self.q_linear = nn.Linear(dim, dim)
        self.k_linear = nn.Linear(dim, dim)
        self.v_linear = nn.Linear(dim, dim)
        self.out_linear = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        self.ffn1 = nn.Linear(d, cfg.hidden_dim)
        self.ffn2 = nn.Linear(cfg.hidden_dim, d)


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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        rate = cfg.dropout_rate
        for layer in self.layers:
            x = x + layer.norm(layer.attention(x, mask=mask, generator=generator))
            h = layer.ffn2(torch.relu(layer.ffn1(x)))
            x = x + layer.norm(h)
            if cfg.scale_out:
                x = x * math.sqrt(0.5)
            if self.training and rate > 0.0:
                x = dropout(x, rate, generator)
        return x
