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
from the left neighbour or runs the ring (``ops/attention.py``), and the
dropout draws are made for the whole sequence, the same on every rank, each
keeping its part.

``tp_axis`` (tensor parallelism, ``parallel/tp.py``): under a mesh
carrying the axis (size n), q, k and v are column-parallel, each rank
computing its block of heads (H/n of them, whole heads: the features split
on head boundaries), and runs the attention core on them at the full
model dim's scale; the output projection is row-parallel, one sum over the
group. The dense FFN is ``ffn1`` column-parallel and ``ffn2`` row-parallel.
Tokens between the layers are whole on every rank. The attention dropout
draws a keep mask for every head and keeps this rank's block (the dense
cores), or one seed per rank (the kernels, whose hash cannot be offset to
another rank's heads). The routed MoE pool runs whole on every rank.

``num_experts >= 2`` builds the routed FFN pool ``moe_{layer}``
(:class:`~tchvp_tpu_torch.ops.moe.MoEFFN`) in place of ``ffn1_``/``ffn2_``,
as JAX's encoder does; a forward given ``moe_sink`` appends each MoE
layer's load-balance loss and dropped fraction to it.
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
from tchvp_tpu_torch.ops.moe import MoEFFN, MoEStats
from tchvp_tpu_torch.parallel import tp
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
                 window_size: int = 0, seq_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"input dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.relu_qkv = relu_qkv
        self.attn_dropout = attn_dropout
        self.attn_impl = attn_impl
        self.window_size = window_size
        self.seq_axis = seq_axis
        self.tp_axis = tp_axis
        self.q_linear = Dense(dim, dim)
        self.k_linear = Dense(dim, dim)
        self.v_linear = Dense(dim, dim)
        self.out_linear = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = x.shape[-1]
        shards = tp.tp_shards(self.tp_axis)
        heads = self.num_heads
        if shards is None:
            q, k, v = self.q_linear(x), self.k_linear(x), self.v_linear(x)
        else:
            if heads % shards[0]:
                raise ValueError(f"{heads} heads not divisible by {self.tp_axis}={shards[0]}")
            heads //= shards[0]
            q, k, v = (tp.linear_columns(lin, x, self.tp_axis)
                       for lin in (self.q_linear, self.k_linear, self.v_linear))
        if self.relu_qkv:
            q, k, v = torch.relu(q), torch.relu(k), torch.relu(v)
        if mask is not None:
            # (B, Sq, Sk) -> (B, 1, Sq, Sk), broadcast across heads.
            mask = (mask != 0)[:, None, :, :]
        out = multi_head_attention(
            q, k, v, heads,
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
        return self.out_linear(out) if shards is None else tp.linear_rows(self.out_linear, out, self.tp_axis)


class TransformerLayer(nn.Module):
    """Attention and FFN branches sharing ONE LayerNorm; :meth:`forward` is
    one layer of :class:`TransformerEncoder` (the pipeline's stages call it
    on their stacked weights, ``parallel/pipeline.py``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.dropout_rate = cfg.dropout_rate
        self.scale_out = cfg.scale_out
        d = cfg.input_dim
        self.attention = TokenMultiheadAttention(
            d, cfg.num_heads, relu_qkv=cfg.relu_qkv, attn_dropout=cfg.dropout_rate,
            attn_impl=cfg.attn_impl, window_size=cfg.window_size, seq_axis=cfg.seq_axis,
            tp_axis=cfg.tp_axis,
        )
        self.tp_axis = cfg.tp_axis
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        if cfg.num_experts >= 2:
            self.moe = MoEFFN(d, cfg.num_experts, cfg.hidden_dim, cfg.expert_capacity_factor,
                              cfg.router_top_k, ep_axis=cfg.ep_axis, seq_axis=cfg.seq_axis)
        else:
            self.ffn1 = Dense(d, cfg.hidden_dim)
            self.ffn2 = Dense(cfg.hidden_dim, d)

    def ffn(self, x: torch.Tensor, sink: Optional[List[MoEStats]] = None) -> torch.Tensor:
        """The FFN branch: the routed pool, or Dense -> ReLU -> Dense."""
        if hasattr(self, "moe"):
            return self.moe(x, sink)
        if tp.tp_shards(self.tp_axis) is None:
            return self.ffn2(torch.relu(self.ffn1(x)))
        h = torch.relu(tp.linear_columns(self.ffn1, x, self.tp_axis))
        return tp.linear_rows(self.ffn2, h, self.tp_axis)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, attn_draw: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None, moe_sink: Optional[List[MoEStats]] = None) -> torch.Tensor:
        """``x + LN(attention(x))``, then ``+ LN(ffn(.))``, the x sqrt(0.5)
        scale and, in train mode, the trailing dropout with its drawn
        ``keep`` mask (``attn_draw``: the attention's draw)."""
        x = x + _norm(self, self.attention(x, mask=mask, generator=generator, dropout_draw=attn_draw))
        x = x + _norm(self, self.ffn(x, moe_sink))
        if self.scale_out:
            x = scale_out(x)
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, None, keep=keep)
        return x


def _norm(layer: TransformerLayer, h: torch.Tensor) -> torch.Tensor:
    """The layer's LayerNorm of ``h``, handed on in h's dtype: autocast
    returns it in fp32, flax's ``LayerNorm(dtype)`` rounds it to the compute
    dtype (a no-op outside autocast)."""
    return layer.norm(h).to(h.dtype)


class TransformerEncoder(nn.Module):
    """Stack of :class:`TransformerLayer` over (B, S, input_dim) tokens."""

    def __init__(self, config: TransformerConfig = TransformerConfig()):
        super().__init__()
        if config.input_dim % config.num_heads != 0:
            raise ValueError(
                f"input dim {config.input_dim} not divisible by num_heads {config.num_heads}"
            )
        self.config = config
        self.layers = nn.ModuleList(TransformerLayer(config) for _ in range(config.num_layers))

    def draw_dropout(self, x_shape: torch.Size, generator: Optional[torch.Generator],
                     device: torch.device, has_mask: bool = False,
                     layers: Optional[int] = None) -> TransformerDraws:
        """The train-mode dropout randomness of one pass over (B, S, D)
        tokens, drawn from ``generator`` in layer order, for ``layers``
        layers (default: all of them). Under a mesh carrying ``seq_axis``
        the tokens are this rank's block of n: the draws are made for all n
        blocks and this rank's part kept."""
        return draw_layer_dropout(self.config, x_shape, generator, device, has_mask, layers)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[TransformerDraws] = None,
                moe_sink: Optional[List[MoEStats]] = None) -> torch.Tensor:
        """``draws`` (train mode): randomness drawn beforehand; without it
        the pass draws its own from ``generator``. ``moe_sink``: a list the
        MoE layers append their :class:`MoEStats` to."""
        if self.training and draws is None:
            draws = self.draw_dropout(x.shape, generator, x.device, mask is not None)
        for i, layer in enumerate(self.layers):
            x = layer(x, mask=mask, generator=generator,
                      attn_draw=draws.attention[i] if self.training else None,
                      keep=draws.layer_keep[i] if self.training else None, moe_sink=moe_sink)
        return x


def draw_layer_dropout(cfg: TransformerConfig, x_shape: torch.Size, generator: Optional[torch.Generator],
                       device: torch.device, has_mask: bool = False,
                       layers: Optional[int] = None) -> TransformerDraws:
    """:meth:`TransformerEncoder.draw_dropout` of a ``cfg`` encoder, for
    ``layers`` of its layers (a pipeline stage's)."""
    rate = cfg.dropout_rate
    n = cfg.num_layers if layers is None else layers
    if rate <= 0.0:
        return TransformerDraws([None] * n, [None] * n)
    b, s, d = x_shape
    impl = resolve_impl(cfg.attn_impl, device.type == "cuda", has_mask, cfg.window_size)
    core = attention_core(impl, has_mask, cfg.window_size)
    shards, i = axis_shards(cfg.seq_axis)
    heads = axis_shards(cfg.tp_axis)
    attention, layer_keep = [], []
    for _ in range(n):
        attention.append(draw_attention_dropout(core, (b, cfg.num_heads, s), rate, generator,
                                                device, cfg.window_size, (shards, i), heads))
        keep = draw_keep((b, shards * s, d), rate, generator, device)
        layer_keep.append(keep[:, i * s:(i + 1) * s])
    return TransformerDraws(attention, layer_keep)
