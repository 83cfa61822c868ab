"""GPipe pipeline parallelism over the ``pipe`` mesh axis.

Counterpart of ``tchvp_tpu/parallel/pipeline.py``, with its names. The
stages of a deep stack live on the ranks of the ``pipe`` axis, one stage a
rank; microbatches stream through them, and the activations hop one rank
forward a tick (``collectives.ppermute``). With P stages and M microbatches
the schedule runs M + P - 1 ticks (:func:`schedule_ticks`); the bubble
fraction is (P - 1) / (M + P - 1), and :func:`pick_microbatches` aims for
M = 4P.

JAX runs the schedule as one SPMD program in ``shard_map``; here every rank
is a process that runs the same ticks eagerly. Every rank does the same
work each tick, as JAX's does: a rank with no microbatch of its own (the
warm-up and drain ticks) computes its stage on a placeholder, and selects
between the feed and the hop with ``torch.where``, so that every rank's
autograd graph holds the same collectives in the same order and the
backward's reverse hops pair up. The statistics a stage reports
(``extras``: the routed MoE's load-balance loss and dropped fraction) are
masked to the ticks that carry a real microbatch, as JAX's ``extras`` are.
The last stage's outputs reach every rank of the axis (a masked sum whose
adjoint hands the last stage one copy of the cotangent), since the CNN
decoder and the loss run on each rank, as GSPMD replicates them in JAX; the
input enters through ``replicated_to_varying``, whose adjoint sums the
ranks' cotangents (stage 0's alone is not zero), so every rank's CNN
encoder gets the whole gradient.

The flagship's pipelined layout (:class:`PipelinedVideoNet`): the CNN
encoder and decoder under ``rest`` and the temporal layers stacked under
``stages``, each stacked parameter of shape (P, ...) or, with k > 1 layers
a stage, (P, k, ...) (:func:`group_stages`), of which a rank holds its row:
the parameter is placed on the axis (``parallel/fsdp.py::placement``), so
its optimizer moments are the stage's too, checkpoints are shard-wise, and
a whole read of one gives JAX's ``{"rest", "stages"}`` layout under the
port's names (``rest.encoder.*``, ``stages.attention.q_linear.weight``).
A stage runs the port's :class:`~tchvp_tpu_torch.models.transformer.TransformerLayer`
on its rows of the stacked weights (``torch.func.functional_call``).
"""

from __future__ import annotations

import copy
import hashlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.parallel.collectives import all_reduce_sum_replicated, ppermute, replicated_to_varying
from tchvp_tpu_torch.parallel.mesh import ambient_mesh, axis_group, axis_size, with_current_mesh

TEMPORAL = "temporal.layers."


def schedule_ticks(microbatches: int, n_stages: int) -> int:
    """GPipe tick count for ``M`` microbatches over ``P`` stages: M + P - 1."""
    return microbatches + n_stages - 1


def pick_microbatches(batch: int, n_stages: int, data_size: int = 1, target_mult: int = 4) -> int:
    """The largest microbatch count M <= min(batch, target_mult * n_stages)
    that divides ``batch`` (the global batch) into microbatches whose rows
    split over a data axis of ``data_size``; raises when none does."""
    cap = min(batch, max(1, target_mult) * n_stages)
    feasible = [m for m in range(cap, 0, -1) if batch % m == 0 and (batch // m) % data_size == 0]
    if not feasible:
        raise ValueError(f"batch {batch} cannot split into microbatches over data axis size {data_size}")
    return feasible[0]


def stack_layer_params(layer_params: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-layer parameter dicts (the same names) stacked along a new
    leading layer dim."""
    return {k: torch.stack([p[k] for p in layer_params]) for k in layer_params[0]}


def group_stages(stacked: Dict[str, torch.Tensor], n_stages: int) -> Dict[str, torch.Tensor]:
    """L stacked layers regrouped into ``n_stages`` stages of L / n
    consecutive layers: leading dim (L, ...) -> (n_stages, L / n, ...)."""
    n_layers = next(iter(stacked.values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} stages")
    k = n_layers // n_stages
    return {name: t.reshape((n_stages, k) + tuple(t.shape[1:])) for name, t in stacked.items()}


def fold_generator(generator: torch.Generator, *indices: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded from its state and
    ``indices`` (JAX's ``fold_in``), without drawing from it: the same
    indices give the same generator on every call (a recompute too), other
    indices another."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()[:16]
    seq = np.random.SeedSequence(int.from_bytes(digest, "little"), spawn_key=tuple(int(i) for i in indices))
    return torch.Generator(generator.device).manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)


def chain_stage_fn(layer_fn: Callable, layers_per_stage: int, with_rng: bool = False,
                   with_extras: bool = False) -> Callable:
    """A stage function applying ``layers_per_stage`` stacked layers in
    order (its parameters carry a leading layer dim of that size, the
    layout :func:`group_stages` gives a stage). ``with_rng``: the layers
    take a generator, folded per layer from the stage's; ``with_extras``:
    each layer returns (x, extras) and the stage the sum of its layers'."""

    def fn(p, x, generator=None):
        ext = None
        for i in range(layers_per_stage):
            pi = {k: t[i] for k, t in p.items()}
            args = (pi, x, fold_generator(generator, i)) if with_rng else (pi, x)
            out = layer_fn(*args)
            if with_extras:
                x, e = out
                ext = e if ext is None else ext + e
            else:
                x = out
        return (x, ext) if with_extras else x

    return fn


def resolve_microbatches(batch: int, axis: str = "pipe", batch_axis: Optional[str] = None,
                         microbatches: Optional[int] = None, mesh=None) -> int:
    """The microbatch count of a pipeline over ``axis`` of ``mesh`` (the
    ambient one by default) on this rank's ``batch`` rows: ``microbatches``,
    or :func:`pick_microbatches` of the global batch over ``batch_axis``."""
    if microbatches is not None:
        return microbatches
    mesh = mesh if mesh is not None else ambient_mesh()
    d = axis_size(mesh, batch_axis) if batch_axis is not None and batch_axis in mesh.mesh_dim_names else 1
    return pick_microbatches(batch * d, axis_size(mesh, axis), d)


def pipeline_apply(
    stage_fn: Callable,
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh=None,
    axis: str = "pipe",
    stages: Optional[int] = None,
    microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
    extras: int = 0,
):
    """Run ``stage_fn`` P times over ``x`` as a P-stage GPipe pipeline over
    ``axis`` of ``mesh`` (default: the ambient mesh); returns
    ``stage_{P-1}(... stage_0(x))`` on every rank of the axis.

    ``stage_fn(params, mb[, generator])`` is ONE stage on one microbatch,
    keeping its shape. ``stacked_params``: a dict of tensors with a leading
    stage dim, of which this rank takes its row; or, with ``stages`` (the
    stage count), this rank's own stage's parameters, passed as they are
    (None for a stage function that holds its own). With ``generator`` the
    stage is called with a generator folded from it by (tick, stage)
    (:func:`fold_generator`): distinct per microbatch and per stage.
    ``x`` is this rank's batch (under ``batch_axis`` its block of the
    global batch), the same on every rank of ``axis``; ``microbatches``
    defaults to :func:`pick_microbatches` of the global batch. ``remat``
    checkpoints the stage body (its recompute carries the mesh).
    ``extras`` > 0: ``stage_fn`` returns ``(mb, e)`` with ``e`` a float32
    vector of that length, and the call returns ``(out, e summed over every
    valid (stage, microbatch) pair)``."""
    mesh = mesh if mesh is not None else ambient_mesh()
    n, idx, group = axis_size(mesh, axis), mesh.get_local_rank(axis), axis_group(mesh, axis)
    if stages is None:
        stages = next(iter(stacked_params.values())).shape[0]
        params = {k: t[idx] for k, t in stacked_params.items()}
    else:
        params = stacked_params
    if stages != n:
        raise ValueError(f"{stages} stacked stages over a {n}-device '{axis}' axis: one stage per device "
                         f"required (group layers into {n} stage functions, or use a {stages}-device axis)")
    b = x.shape[0]
    d = axis_size(mesh, batch_axis) if batch_axis is not None and batch_axis in mesh.mesh_dim_names else 1
    m = resolve_microbatches(b, axis, batch_axis, microbatches, mesh)
    if (b * d) % m:
        raise ValueError(f"batch {b * d} not divisible into {m} microbatches")
    if b % m:
        raise ValueError(f"a microbatch of {b * d // m} rows does not split over {batch_axis}={d}")
    dispatch_trace.record("pipeline_shard_map")
    mb = b // m
    xs = replicated_to_varying(x, group).reshape((m, mb) + tuple(x.shape[1:]))
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n - 1, device=x.device)

    def call(p, inp, t):
        if generator is None:
            return stage_fn(p, inp)
        return stage_fn(p, inp, fold_generator(generator, t, idx))

    body = call
    if remat:
        inner = with_current_mesh(call)

        def body(p, inp, t):
            return checkpoint(inner, p, inp, t, use_reentrant=False, preserve_rng_state=False)

    act = torch.zeros_like(xs[0])
    outs = []
    ext = None
    for t in range(schedule_ticks(m, n)):
        recv = ppermute(act, group)  # the activations hop one stage on
        inp = torch.where(first, xs[min(t, m - 1)], recv)
        res = body(params, inp, t)
        if extras:
            act, e = res
            # Stage idx holds microbatch t - idx this tick; any other tick
            # computed a placeholder, whose statistics must not count.
            valid = torch.tensor(0 <= t - idx < m, device=e.device)
            e = torch.where(valid, e.float(), torch.zeros_like(e, dtype=torch.float32))
            ext = e if ext is None else ext + e
        else:
            act = res
        if t >= n - 1:  # the last stage finished microbatch t - (n - 1)
            outs.append(torch.where(last, act, torch.zeros_like(act)))
    out = all_reduce_sum_replicated(torch.stack(outs), group).reshape(x.shape)
    if not extras:
        return out
    return out, all_reduce_sum_replicated(ext, group)


# ---------------------------------------------------------------------------
# The flagship's pipelined layout: "rest" (the CNN) and "stages" (the
# temporal layers stacked), as JAX's create_pipelined_train_state has it.


def split_video_params(params: Dict[str, torch.Tensor], num_layers: int
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A ``VideoHybridNet`` state_dict (or any dict of its names: moments,
    an EMA) split into ``(rest, stacked)``: every entry outside the
    temporal stack, and the layers' entries stacked along a leading layer
    dim (:func:`stack_layer_params`). Inverse: :func:`merge_video_params`."""
    rest = {k: v for k, v in params.items() if not k.startswith("temporal.")}
    layers = [{k[len(f"{TEMPORAL}{i}."):]: v for k, v in params.items() if k.startswith(f"{TEMPORAL}{i}.")}
              for i in range(num_layers)]
    return rest, stack_layer_params(layers)


def merge_video_params(rest: Dict[str, torch.Tensor], stacked: Dict[str, torch.Tensor],
                       num_layers: int) -> Dict[str, torch.Tensor]:
    """The ``VideoHybridNet`` state_dict of the pipelined layout's parts
    (``stacked`` may be stage-grouped, (n_stages, k, ...))."""
    out = dict(rest)
    for name, t in stacked.items():
        if t.shape[0] != num_layers:
            t = t.reshape((num_layers,) + tuple(t.shape[2:]))
        for i in range(num_layers):
            out[f"{TEMPORAL}{i}.{name}"] = t[i]
    return out


def is_pipelined_params(params: Dict[str, Any]) -> bool:
    """Whether a state_dict is the pipelined layout: every entry under
    ``rest.`` or ``stages.``, and a stacked (at least 2-D) LayerNorm scale
    among the stages."""
    if not params or not all(k.startswith(("rest.", "stages.")) for k in params):
        return False
    norm = params.get("stages.norm.weight")
    return norm is not None and norm.dim() >= 2


def pipelined_layout(params: Dict[str, torch.Tensor], num_layers: int, n_stages: int
                     ) -> Dict[str, torch.Tensor]:
    """A ``VideoHybridNet`` state_dict in the pipelined layout of
    ``n_stages`` stages: ``rest.<name>`` and ``stages.<name>`` (stacked,
    grouped where a stage holds several layers)."""
    rest, stacked = split_video_params(params, num_layers)
    if num_layers // n_stages > 1:
        stacked = group_stages(stacked, n_stages)
    return {**{f"rest.{k}": v for k, v in rest.items()}, **{f"stages.{k}": v for k, v in stacked.items()}}


def merge_pipelined_params(params: Dict[str, torch.Tensor], num_layers: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """Pipelined layout -> ``VideoHybridNet`` state_dict; the layer count,
    unless given, read off the stacked LayerNorm scale ((P, d) or (P, k, d))."""
    if num_layers is None:
        ref = params["stages.norm.weight"]
        num_layers = ref.shape[0] * (ref.shape[1] if ref.dim() == 3 else 1)
    rest = {k[len("rest."):]: v for k, v in params.items() if k.startswith("rest.")}
    stacked = {k[len("stages."):]: v for k, v in params.items() if k.startswith("stages.")}
    return merge_video_params(rest, stacked, num_layers)


def _check_stack(cfg, n: int, axis: str) -> None:
    """JAX's refusals of a temporal stack it cannot pipeline over ``n``."""
    if cfg.num_layers % n:
        raise ValueError(f"{cfg.num_layers} temporal layers over a {n}-device '{axis}' axis: num_layers "
                         f"must be a multiple of the stage count")
    if cfg.num_experts >= 2 and cfg.ep_axis is not None:
        raise ValueError("pp x ep inside a stage is unsupported: use ep_axis=None for pipelined MoE "
                         "training (experts live stage-local; the aux is the per-microbatch estimator)")
    if cfg.seq_axis is not None:
        raise ValueError("pp x sp inside a stage is unsupported: use seq_axis=None for pipelined training")


class PipelinedVideoNet(nn.Module):
    """A ``VideoHybridNet`` in the pipelined layout on this rank of the
    ``axis`` of ``mesh``: ``rest`` (its encoder and decoder, replicated over
    the axis) and ``stages`` (its temporal layers of this rank's stage,
    stacked as the module docstring says). Built from a whole model, the
    same on every rank, whose encoder and decoder it shares and whose
    temporal layers of this rank's stage it copies (the model itself is
    left as it was).

    :meth:`forward` is the flagship's forward with the temporal stack run
    by :func:`pipeline_apply`; train mode draws the CNN's dropout as the
    monolithic model does (the same first draws of the generator) and the
    stages' from generators folded by (tick, stage)."""

    def __init__(self, model: nn.Module, mesh=None, axis: str = "pipe"):
        super().__init__()
        mesh = mesh if mesh is not None else ambient_mesh()
        cfg = model.config.temporal
        n, idx, group = axis_size(mesh, axis), mesh.get_local_rank(axis), axis_group(mesh, axis)
        _check_stack(cfg, n, axis)
        self.config = model.config
        self.mesh = mesh
        self.axis = axis
        self.n_stages = n
        self.k = cfg.num_layers // n
        self.rest = nn.ModuleDict({"encoder": model.encoder, "decoder": model.decoder})
        layers = list(model.temporal.layers)[idx * self.k:(idx + 1) * self.k]
        stacked = stack_layer_params([dict(layer.named_parameters()) for layer in layers])
        template = copy.deepcopy(layers[0]).to("meta")
        self.stages = copy.deepcopy(template)
        for name, t in stacked.items():
            p = nn.Parameter(t.detach().reshape((1,) + ((self.k,) if self.k > 1 else ()) + tuple(t.shape[1:]))
                             .clone().to(t.device))
            p.pipe_axis, p.pipe_mesh, p.pipe_group = axis, mesh, group
            owner, leaf = _owner(self.stages, name)
            setattr(owner, leaf, p)
        # Not submodules: the template runs a layer on the stacked rows; the
        # lender, a shallow copy of the model without its temporal stack
        # (``model`` is left as it was), lends its clip methods, whose
        # encoder and decoder are ``rest``'s.
        lender = copy.copy(model)
        lender._modules = {k: m for k, m in model._modules.items() if k != "temporal"}
        lender._posenc = {}
        object.__setattr__(self, "_template", template)
        object.__setattr__(self, "_net", lender)

    @property
    def compute_dtype(self):
        return self._net.compute_dtype

    def stage(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, extras: bool = False):
        """This rank's stage on one microbatch of tokens: its k layers on
        their rows of the stacked weights (:func:`chain_stage_fn`); train
        mode draws each layer's dropout from a generator folded from
        ``generator`` by the layer's place in the stage. With ``extras``,
        also the stage's float32 [load-balance loss, dropped fraction]
        summed over its MoE layers (zeros for dense ones)."""
        from tchvp_tpu_torch.models.transformer import draw_layer_dropout
        from tchvp_tpu_torch.ops.moe import total_load_balance_loss

        cfg = self.config.temporal
        template = self._template.train(self.training)
        rng = self.training and cfg.dropout_rate > 0.0

        def layer(p, h, g=None):
            sink: Optional[list] = [] if extras else None
            kwargs = {"moe_sink": sink}
            if rng:
                draws = draw_layer_dropout(cfg, h.shape, g, h.device, layers=1)
                kwargs.update(attn_draw=draws.attention[0], keep=draws.layer_keep[0])
            h = torch.func.functional_call(template, p, (h,), kwargs)
            if not extras:
                return h
            dropped = sum(s.dropped.float() for s in sink) if sink else torch.zeros((), dtype=torch.float32)
            return h, torch.stack([total_load_balance_loss(sink).to(h.device), torch.as_tensor(dropped).to(h.device)])

        # A stage's parameters with a leading layer dim of k: (1, ...) is
        # one layer's, (1, k, ...) k layers'.
        params = {name: t if self.k == 1 else t[0] for name, t in self.stages.named_parameters()}
        return chain_stage_fn(layer, self.k, with_rng=rng, with_extras=extras)(params, x, generator)

    def temporal_mix(self, tokens: torch.Tensor, *, microbatches: Optional[int] = None,
                     batch_axis: Optional[str] = None, generator: Optional[torch.Generator] = None,
                     remat: bool = False, extras: bool = False):
        """The positional encoding, then the temporal stack as a pipeline
        over the axis (:func:`pipeline_apply`); with ``extras`` also the
        [aux, dropped] sums over every layer and microbatch."""
        net = self._net
        with net._compute(tokens):
            if self.config.use_posenc:
                tokens = tokens + net._posenc_for(tokens)[None]
            fn = (lambda _, mb, g=None: self.stage(mb, g, extras))
            return pipeline_apply(fn, None, tokens, mesh=self.mesh, axis=self.axis, stages=self.n_stages,
                                  microbatches=microbatches, batch_axis=batch_axis, generator=generator,
                                  remat=remat, extras=2 if extras else 0)

    def draw_latent_keep(self, clip_shape, generator: Optional[torch.Generator], device: torch.device):
        """The encoder's Dropout2d mask of a train-mode pass: the monolithic
        model's first draw (``VideoHybridNet.draw_dropout``)."""
        from tchvp_tpu_torch.models.transformer import TransformerDraws
        from tchvp_tpu_torch.models.video import VideoDraws

        b, t = clip_shape[:2]
        return VideoDraws(self.rest["encoder"].draw_dropout(b * t, generator, device), TransformerDraws([], []))

    def forward(self, clip: torch.Tensor, generator: Optional[torch.Generator] = None,
                microbatches: Optional[int] = None, batch_axis: Optional[str] = None,
                remat: bool = False, extras: bool = False):
        """clip (B, T, H, W, C) -> (tokens, recon), as ``VideoHybridNet``'s;
        with ``extras`` also the MoE sums (:meth:`temporal_mix`). Train mode
        draws the CNN's dropout from ``generator`` first, then folds the
        stages' generators from it where the temporal dropout is on."""
        draws = None
        stage_gen = None
        if self.training:
            draws = self.draw_latent_keep(clip.shape, generator, clip.device)
            if self.config.temporal.dropout_rate > 0.0:
                stage_gen = fold_generator(generator, 1)
                torch.randint(2, (1,), generator=generator, device=generator.device)  # moves it on
        tokens, hw = self._net.encode_clip(clip, draws=draws)
        out = self.temporal_mix(tokens, microbatches=microbatches, batch_axis=batch_axis,
                                generator=stage_gen, remat=remat, extras=extras)
        tokens, ext = out if extras else (out, None)
        recon = self._net.decode_tokens(tokens, hw)
        return (tokens, recon, ext) if extras else (tokens, recon)


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def pipeline_state_shardings(state, mesh, axis: str = "pipe", fsdp_axis: Optional[str] = None
                             ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The spec of each entry of a pipelined model's ``state_dict`` by name
    (JAX's NamedShardings, as ``fsdp.state_shardings`` gives them): the
    stacked stages' leading dim on ``axis``; the rest replicated or, with
    ``fsdp_axis``, by ``fsdp.fsdp_leaf_spec`` (a rest parameter already held
    as slices, by its placement). Moments and EMA share their parameter's."""
    from tchvp_tpu_torch.parallel.fsdp import fsdp_leaf_spec, sliced_spec

    model = getattr(state, "model", state)
    params = dict(model.named_parameters())
    d = axis_size(mesh, fsdp_axis) if fsdp_axis is not None and fsdp_axis in mesh.mesh_dim_names else 1
    out = {}
    for k, v in model.state_dict().items():
        if k.startswith("stages."):
            out[k] = (axis,) + (None,) * (v.dim() - 1)
        elif d > 1 and k in params:
            held = sliced_spec(params[k])
            out[k] = held if held is not None else fsdp_leaf_spec(tuple(v.shape), fsdp_axis, d)
        else:
            out[k] = ()
    return out


def create_pipelined_train_state(model: nn.Module, tx, rng: int = 0, *, mesh=None, axis: str = "pipe",
                                 fsdp_axis: Optional[str] = None):
    """A step-0 state of ``model`` (a ``VideoHybridNet``, the same on every
    rank) in the pipelined layout: this rank's stage and the rest, the
    optimizer moments of both; with ``fsdp_axis`` the rest's parameters and
    moments ZeRO-sharded over that (data) axis too."""
    from tchvp_tpu_torch.parallel import fsdp
    from tchvp_tpu_torch.train.state import create_train_state

    mesh = mesh if mesh is not None else ambient_mesh()
    state = create_train_state(PipelinedVideoNet(model, mesh, axis), tx, rng=rng)
    if fsdp_axis is not None:
        fsdp.shard_train_state(state, mesh, fsdp_axis)
    return state


def pipelined_video_infer(model: nn.Module, clip: torch.Tensor, *, mesh=None, axis: str = "pipe",
                          microbatches: Optional[int] = None, batch_axis: Optional[str] = None):
    """The flagship's deterministic forward with its temporal stack run as
    a GPipe pipeline over ``axis``: ``(tokens, recon)`` as the model's own
    forward gives them. ``model``: a :class:`PipelinedVideoNet`, or a
    ``VideoHybridNet`` (the same on every rank), made one here, which takes
    its layers. ``clip``: this rank's block of the batch under
    ``batch_axis``, the same on every rank of ``axis``."""
    if not isinstance(model, PipelinedVideoNet):
        model = PipelinedVideoNet(model, mesh, axis)
    model.eval()
    m = resolve_microbatches(clip.shape[0], model.axis, batch_axis, microbatches, model.mesh)
    return model(clip, microbatches=m, batch_axis=batch_axis)
