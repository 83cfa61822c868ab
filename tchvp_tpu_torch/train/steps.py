"""Train and eval steps of the flagship video model (and the frame AEs run
as video models), of the denoising autoencoders and of the segmentation
models.

Counterpart of ``tchvp_tpu/train/steps.py``'s ``make_video_train_step``,
``make_video_eval_step``, ``make_denoising_train_step``,
``make_denoising_eval_step``, ``make_inpainting_test_step``,
``make_segmentation_train_step``, ``make_segmentation_eval_step`` and
``_loss_fn_by_name``. The denoising steps (image -> image) and the
segmentation steps (image -> mask) are at the end of this module; what
follows describes the video step. A step takes a uint8
clip (B, T, H, W, 3) on the model's device and runs, eagerly:
preprocess -> the geometric augmentations (``aug``, off by default) ->
Gaussian input noise -> the train-mode forward -> the loss
over frames folded into the batch -> backward -> one optimizer update. The
BatchNorm running stats move inside the forward, once per (micro)batch.
Metrics come back as device tensors: the step never waits for the device.

Randomness. The JAX step splits its key up front (``k_geo``, ``k_noise``,
``k_drop``); here the augmentations' draws and the noise come from
``state.noise_generator`` and every dropout draw
of a (micro)batch (attention seeds, the Dropout2d mask, the transformer
dropout masks) from ``state.dropout_generator``, all before the forward
runs. ``torch.utils.checkpoint`` replays only the default generators, so
drawing first is what makes a recomputed region apply the same masks.

Remat policies map to ``torch.utils.checkpoint`` (non-reentrant):
``"full"`` checkpoints the whole forward; ``"stages"`` checkpoints
``encode_clip``, ``temporal_mix`` and ``decode_tokens`` each, keeping only
the stage-boundary tokens (JAX's ``encoder_tokens``/``temporal_tokens``);
``"dots"`` keeps only the outputs of unbatched matrix products (``mm``,
``addmm``) and recomputes the rest. A recompute leaves the BatchNorm
running stats alone, so they move once per forward as in JAX. A frame AE
(``models/frame_ae.py``) has no stages: ``"stages"`` recomputes its whole
forward, as JAX's policy, saving no named tensor there, does.

The routed MoE (``moe_aux_weight > 0``): the objective is the loss plus
``moe_aux_weight`` x the MoE layers' summed load-balance loss, and the
metrics gain ``moe_aux`` and ``moe_drop_frac`` (means over microbatches).
JAX sows both; here each checkpointed region collects them in a sink of its
own and returns them as outputs, so the aux loss's gradient reaches the
router under every remat policy and a recompute appends nothing the step
reads.

Sequence parallelism: when the model's ``config.temporal.seq_axis`` is on
an ambient mesh with size > 1 (``parallel.mesh.mesh_with_axis``), every
rank is given the same global clip and keeps its block of the frames. The
noise and the dropout draws are made at the global shape from the shared
generators, the same on every rank, and each rank keeps its part. Each rank
backpropagates its local loss; the collectives' adjoints carry the other
ranks' cotangents, so the gradients' mean over the axis, all-reduced once a
step before clipping and the update, is the global loss's gradient, and the
parameters stay bit-equal across ranks. Loss, MSE and PSNR come back
global. Every remat policy and ``accum_steps`` hold there: a recompute
runs the halo exchange, the ring hops and the BatchNorm all-reduces again,
in the same order on every rank, and moves no running stat; a microbatch
is a slice of the batch dim, so it is the global clip's microbatch's frames.

Data parallelism: when an ambient mesh carries ``data`` with size > 1
(``parallel.mesh.DATA_AXIS``), ``batch`` is this rank's block of the global
batch (``parallel.input.GlobalBatchLoader``). Train-mode BatchNorm takes
its statistics over the axis (``ops/blocks.py``), the gradients' mean over
the axis is all-reduced once a step (each rank's loss is the mean over its
equal share, so the mean of the ranks' gradients is the global loss's,
the BatchNorm all-reduces' adjoints carrying the other ranks' part), and
the loss and metrics come back as the global batch's: means over the axis,
PSNR from the global MSE, dice and IoU from the global sums. The noise and
dropout draws come from generators of this data rank, forked each step from
the state's (:func:`_step_generators`), as JAX's sharded draws differ per
shard; the state's generators advance alike on every rank, so rank 0's
checkpoint resumes every rank. On a ``data`` x
``seq`` mesh a rank holds its data block's frames; on ``data`` x
``expert`` its data block, and the experts' gradients are averaged over
the data axis too. With ``accum_steps`` a microbatch is a slice of the
global batch, as in JAX: each rank's batch is then its share of every one,
in order (``parallel.input.local_rows``, as the loaders give it).

FSDP (``parallel/fsdp.py``): a state sharded by ``fsdp.shard_train_state``
holds only this rank's slices of its large parameters between steps. A
step gathers them whole first (one all-gather), runs as the replicated
step does, and after the backward reduce-scatters their gradients to the
mean over the data axis, each rank keeping its slice
(``fsdp.constrain_gradients``, the ``fsdp_constrain`` marker), where the
replicated step all-reduces; the optimizer then updates the slices. The
eval steps gather the parameters for their forward. ``fsdp_axis`` without
a mesh carrying it is dormant, as in JAX.

Tensor parallelism (``parallel/tp.py``, the ``model`` axis): every rank of
the axis is given the same batch and computes its blocks of heads and
channels; the gradients of the parameters it used through a slice are
summed over the axis (``tp.sum_gradients``) before the data mean. It
composes with sequence and spatial parallelism and with conv-only QAT.

Spatial partitioning (``parallel/spatial.py``, the ``spatial`` axis): every
rank of the axis is given the same batch, so the noise and the dropout
draws are the whole clip's, and the model runs its conv stacks on this
rank's block of the rows; the loss is taken on the reconstruction gathered
whole, the same on every rank, and the conv stacks' gradients (each rank's
rows' part) are summed over the axis (``spatial.sum_gradients``) before the
data mean. A rank's step is one process's.

Expert parallelism: when ``config.temporal.ep_axis`` is on an ambient mesh,
each rank runs the whole model on the whole batch but only its experts
(``ops/moe.py``); everything outside the experts is computed alike on every
rank, so the replicated parameters' gradients are averaged over the axis
(which keeps them bit-equal) and the experts' are the rank's own. The
global-norm clip sums the experts' squares over the axis
(``train/state.py``).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tchvp_tpu_torch import losses
from tchvp_tpu_torch.config import AugmentConfig
from tchvp_tpu_torch.data import pipeline
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.ops.blocks import frozen_batch_stats, with_current_hook
from tchvp_tpu_torch.ops.moe import mean_dropped_fraction, moe_layers, total_load_balance_loss
from tchvp_tpu_torch.parallel import fsdp, spatial, tp
from tchvp_tpu_torch.parallel.collectives import all_reduce_mean_, all_reduce_sum
from tchvp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_shards,
    axis_size,
    mesh_with_axis,
    shard_frames,
    with_current_mesh,
)
from tchvp_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]
# Called at the step's phase boundaries ("data", "forward", "backward",
# "optimizer") when given; chip_smoke.py records CUDA events there.
Mark = Optional[Callable[[str], None]]

REMAT_POLICIES = ("none", "full", "stages", "dots")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _loss_fn_by_name(name: str, alpha: float = 0.5, beta: float = 0.5,
                     data_range: float = 1.0) -> Callable:
    """``data_range`` 1.0 is right for [0, 1] images; 255.0 reproduces the
    reference's pytorch_msssim default."""
    if name == "mixed":
        return functools.partial(losses.mixed_loss, alpha=alpha, beta=beta, data_range=data_range)
    if name == "mse":
        return losses.mse
    if name == "dice":
        return losses.dice_loss
    raise ValueError(f"unknown loss {name!r}")


def _stats_once(module: torch.nn.Module, fn: Callable) -> Callable:
    """``fn`` whose second and later calls (the recompute of a checkpointed
    region) leave ``module``'s BatchNorm running stats alone."""
    calls = 0

    def run(*args):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*args)
        with frozen_batch_stats(module):
            return fn(*args)

    return run


def _seq_axis(model: torch.nn.Module) -> Optional[str]:
    """The video model's sequence-parallel axis when an ambient mesh carries
    it (a frame AE has none)."""
    temporal = getattr(getattr(model, "config", None), "temporal", None)
    axis = temporal.seq_axis if temporal is not None else None
    return axis if mesh_with_axis(axis) is not None else None


def _refuse_qat_dense_under_tp(model: torch.nn.Module, qat: bool, qat_dense: bool) -> None:
    """QAT of the Dense layers under tensor parallelism: the column and row
    products of ``parallel/tp.py`` take slices of the Dense weights
    directly, past the Dense interceptor, so they would train in fp."""
    temporal = getattr(getattr(model, "config", None), "temporal", None)
    if qat and qat_dense and temporal is not None and mesh_with_axis(temporal.tp_axis) is not None:
        raise ValueError("--qat-dense under tensor parallelism: the tensor-parallel projections take "
                         "their weight slices past the Dense interceptor; use conv-only --qat")


def _ep_axis(model: torch.nn.Module) -> Optional[str]:
    """The model's expert-parallel axis when an ambient mesh carries it."""
    temporal = getattr(getattr(model, "config", None), "temporal", None)
    axis = temporal.ep_axis if temporal is not None else None
    return axis if mesh_with_axis(axis) is not None and moe_layers(model) else None


def _global_mean(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """A per-rank mean over equal shares as the mean over each of ``axes``
    that the ambient mesh carries."""
    for axis in axes:
        mesh = mesh_with_axis(axis)
        if mesh is not None:
            x = all_reduce_sum(x.detach(), axis_group(mesh, axis)) / axis_size(mesh, axis)
    return x


def _data_group():
    """The data axis's group when the ambient mesh carries it, else None."""
    mesh = mesh_with_axis(DATA_AXIS)
    return axis_group(mesh, DATA_AXIS) if mesh is not None else None


def _fork(generator: torch.Generator, index: int) -> torch.Generator:
    """A generator of data rank ``index`` seeded from ``generator``'s state,
    which moves on to a seed of its own: the same on every rank, read on the
    host (no device sync)."""
    digest = int.from_bytes(hashlib.sha256(generator.get_state().numpy().tobytes()).digest()[:16], "little")
    generator.manual_seed(int(np.random.SeedSequence(digest).generate_state(1, np.uint64)[0]) >> 1)
    seed = int(np.random.SeedSequence(digest, spawn_key=(index,)).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(generator.device).manual_seed(seed)


def _step_generators(state: TrainState) -> Tuple[torch.Generator, torch.Generator]:
    """The step's (noise, dropout) generators: the state's; under a data
    mesh, this data rank's forks of them (module docstring)."""
    n, i = axis_shards(DATA_AXIS)
    if n == 1:
        return state.noise_generator, state.dropout_generator
    return _fork(state.noise_generator, i), _fork(state.dropout_generator, i)


def _mean_grads_over_data(model: torch.nn.Module) -> None:
    """Under a data mesh, every gradient becomes its mean over the axis."""
    group = _data_group()
    if group is not None:
        all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None], group)


@contextlib.contextmanager
def _whole_params(model: torch.nn.Module):
    """The scope of a step: an FSDP-sharded model's parameters whole
    (``fsdp.gather_params``), their slices back at its end, also on an
    error. Yields the parameters gathered (none for a replicated model)."""
    params = fsdp.gather_params(model)
    try:
        yield params
    finally:
        fsdp.reshard(params)


def _reduce_grads(model: torch.nn.Module, fsdp_axis: Optional[str], fsdp_mesh, gathered) -> None:
    """The gradients before the update: summed over the model axis where a
    tensor-parallel forward used a slice, then their mean over the data
    axis, reduce-scattered to the slices of an FSDP-sharded state
    (``fsdp.constrain_gradients``, which gives the parameters their slices
    back) or all-reduced. Those used on row blocks are summed over the
    spatial axis first (``spatial.sum_gradients``). The step has already
    taken the mean over ``seq`` and, for all but the experts, over
    ``expert``.

    Under several axes at once each gradient is combined over each axis
    whose ranks saw different frames, rows or slices of it, and over none
    whose ranks computed the same thing; the axes are independent, so the
    order does not matter. By parameter class and axis ("mean": the mean
    of the ranks' gradients, each of its own share of the loss; "sum": the
    ranks' parts added; "own": each rank keeps its slice's; "-": every rank
    already holds the whole gradient, which nothing combines):

    ============================== ====== ====== =========== ====== =======
    parameters                     data   seq    model       expert spatial
    ============================== ====== ====== =========== ====== =======
    convs, BatchNorm (the CNN)     mean   mean   sum, sliced mean   sum
    attention q, k, v, out; norms  mean   mean   sum, sliced mean   -
    the dense FFN                  mean   mean   sum, sliced mean   -
    the MoE router                 mean   mean   -           mean   -
    the experts' w1, b1, w2, b2    mean   mean   -           own    -
    ============================== ====== ====== =========== ====== =======

    "sum, sliced": summed where the rank used a slice (the parameter
    carries ``tp_group``: the heads, the FFN's hidden dim, a conv's block
    of output channels), else "-" (a narrow conv every rank computes
    whole). Under ``seq`` each rank's loss is its frames' mean and the
    collectives' adjoints carry the other ranks' cotangents, so the mean of
    the ranks' gradients is the global loss's; the MoE layer routes the
    gathered sequence on every seq rank, each rank's cotangent entering its
    own rows, and its aux loss, the same on every seq rank, is counted once
    by the mean. Under ``spatial`` the conv stacks' parameters get each
    rank's rows' part; the transformer runs on the gathered tokens, alike
    on every spatial rank."""
    tp.sum_gradients(model)
    spatial.sum_gradients(model)
    if gathered:
        fsdp.constrain_gradients(model, gathered[0].fsdp_axis, gathered[0].fsdp_mesh)
    elif fsdp_axis is not None:
        fsdp.constrain_gradients(model, fsdp_axis, fsdp_mesh)
    else:
        _mean_grads_over_data(model)


def _global_psnr(recon: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """PSNR of the global batch's MSE (a data mesh's ranks hold equal
    shares)."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(_global_mean(losses.mse(recon, clean), DATA_AXIS)))


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _qat_scope(qat: bool, dense: bool):
    """:func:`~tchvp_tpu_torch.train.qat.qat_fake_quant` when ``qat``."""
    if not qat:
        return contextlib.nullcontext()
    from tchvp_tpu_torch.train.qat import qat_fake_quant

    return qat_fake_quant(dense=dense)


def _moe_totals(sink) -> Tuple[torch.Tensor, torch.Tensor]:
    return total_load_balance_loss(sink), mean_dropped_fraction(sink)


def _remat_forward(model: torch.nn.Module, x: torch.Tensor, draws, policy: str, moe: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """(tokens, recon) of the train-mode forward under ``policy``; with
    ``moe``, (tokens, recon, aux, dropped fraction), each checkpointed
    region collecting the MoE stats in a sink of its own and returning
    them."""
    def whole(c):
        if not moe:
            return model(c, draws=draws)
        sink: list = []
        return model(c, draws=draws, moe_sink=sink) + _moe_totals(sink)

    def temporal(t):
        if not moe:
            return model.temporal_mix(t, draws=draws)
        sink: list = []
        return (model.temporal_mix(t, draws=draws, moe_sink=sink),) + _moe_totals(sink)

    if policy == "none":
        return whole(x)
    ckpt = functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)

    def region(fn):
        # A region carries the conv hook (QAT's fake quant) and the mesh in
        # scope now into its recompute, which runs on the autograd engine's
        # thread on CUDA; BatchNorm's running stats move once.
        return _stats_once(model, with_current_mesh(with_current_hook(fn)))

    if policy == "full" or (policy == "stages" and not hasattr(model, "temporal_mix")):
        return ckpt(region(whole), x)
    if policy == "dots":
        return ckpt(region(whole), x,
                    context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    # "stages": only the clip and the two stage-boundary token tensors stay.
    tokens, hw = ckpt(region(lambda c: model.encode_clip(c, draws=draws)), x)
    mixed = ckpt(region(temporal), tokens)
    tokens, rest = (mixed[0], mixed[1:]) if moe else (mixed, ())
    recon = ckpt(region(lambda t: model.decode_tokens(t, hw)), tokens)
    return (tokens, recon) + tuple(rest)


def make_video_train_step(
    image_size: int,
    loss: str = "mixed",
    alpha: float = 0.3,
    beta: float = 0.7,
    noise_std: float = 0.05,
    aug: AugmentConfig = AugmentConfig(),
    remat: bool = False,
    remat_policy: str = "none",
    data_range: float = 1.0,
    moe_aux_weight: float = 0.0,
    fsdp_axis: Optional[str] = None,
    fsdp_mesh=None,
    accum_steps: int = 1,
    qat: bool = False,
    qat_dense: bool = False,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """The flagship's train step: gaussian input noise (``noise_std``), the
    mixed loss alpha * (1 - MS-SSIM) + beta * MSE by default, over frames
    folded into the batch.

    ``remat``/``remat_policy``: ``"none"``, ``"full"`` (``remat=True``
    alone), ``"stages"`` or ``"dots"`` (module docstring).
    ``accum_steps`` > 1 splits the batch into that many microbatches along
    dim 0; their gradients, losses and MSEs are averaged and ONE update is
    applied. As in JAX, the BatchNorm stats update once per microbatch, in
    order, and each microbatch draws fresh dropout randomness.

    ``moe_aux_weight`` > 0 adds that times the MoE layers' load-balance
    loss to the objective (and so to ``loss``) and reports ``moe_aux`` and
    ``moe_drop_frac`` (module docstring).

    ``qat=True``: quantization-aware training; every conv (and, with
    ``qat_dense``, every Dense) runs on fake-int8 input and kernel with STE
    gradients (:mod:`tchvp_tpu_torch.train.qat`), so the fp32 weights train
    against the int8 serving engine's arithmetic.

    ``fsdp_axis``/``fsdp_mesh``: the axis (and mesh) of a state sharded by
    ``fsdp.shard_train_state``; the step reduce-scatters over it (module
    docstring). A sharded state is stepped so with or without them.

    The returned ``step(state, batch, mark=None)`` updates ``state`` in
    place and returns ``(state, {"loss", "psnr"})``. Under sequence
    parallelism (module docstring) ``batch`` is the global clip; under data
    parallelism this rank's block of the global batch, with ``accum_steps``
    its share of each microbatch in order (``parallel.input.local_rows``).
    """
    want_aux = moe_aux_weight > 0.0
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if remat and remat_policy == "none":
        remat_policy = "full"
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be none|full|stages|dots, got {remat_policy!r}")
    loss_fn = _loss_fn_by_name(loss, alpha, beta, data_range)

    def step(state: TrainState, batch: torch.Tensor, mark: Mark = None) -> Tuple[TrainState, Metrics]:
        with _whole_params(state.model) as gathered:
            return _step(state, batch, mark, gathered)

    def _step(state: TrainState, batch: torch.Tensor, mark: Mark, gathered) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        _refuse_qat_dense_under_tp(model, qat, qat_dense)
        seq_axis = _seq_axis(model)
        ep_axis = _ep_axis(model)
        clean = pipeline.preprocess_clip(batch, image_size)
        noise_gen, drop_gen = _step_generators(state)
        clean = pipeline.augment_geometric(noise_gen, clean, aug)
        noisy = pipeline.gaussian_noise(noise_gen, clean, noise_std)
        if seq_axis is not None:
            mesh = mesh_with_axis(seq_axis)
            clean, noisy = (shard_frames(x, mesh, seq_axis) for x in (clean, noisy))
        b, t = clean.shape[0], clean.shape[1]
        if b % accum_steps != 0:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        mb = b // accum_steps
        for p in model.parameters():
            p.grad = None
        if mark:
            mark("data")
        loss_sum = mse_sum = aux_sum = drop_sum = None
        for i in range(accum_steps):
            x, y = noisy[i * mb:(i + 1) * mb], clean[i * mb:(i + 1) * mb]
            draws = model.draw_dropout(x.shape, drop_gen, x.device)
            with _qat_scope(qat, qat_dense):
                out = _remat_forward(model, x, draws, remat_policy, moe=want_aux)
            recon = out[1]
            # A compute_dtype model's bf16 recon meets the fp32 clip in the
            # loss at fp32, as jnp's type promotion has it in JAX.
            recon = recon.to(y.dtype)
            flat_r = recon.reshape((mb * t,) + recon.shape[2:])
            flat_c = y.reshape((mb * t,) + y.shape[2:])
            loss_val = loss_fn(flat_r, flat_c)
            if want_aux:
                aux, drop = out[2].to(loss_val.device), out[3].to(loss_val.device)
                loss_val = loss_val + moe_aux_weight * aux
                aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
                drop_sum = drop.detach() if drop_sum is None else drop_sum + drop.detach()
            mse_val = losses.mse(recon.detach(), y)
            if mark:
                mark("forward")
            loss_val.backward()
            if mark:
                mark("backward")
            loss_sum = loss_val.detach() if loss_sum is None else loss_sum + loss_val.detach()
            mse_sum = mse_val if mse_sum is None else mse_sum + mse_val
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            torch._foreach_mul_(grads, inv)
            loss_sum, mse_sum = loss_sum * inv, mse_sum * inv
            if want_aux:
                aux_sum, drop_sum = aux_sum * inv, drop_sum * inv
        if seq_axis is not None:
            all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None],
                             axis_group(mesh_with_axis(seq_axis), seq_axis))
            loss_sum, mse_sum = _global_mean(loss_sum, seq_axis), _global_mean(mse_sum, seq_axis)
        if ep_axis is not None:
            all_reduce_mean_([p.grad for p in model.parameters()
                              if p.grad is not None and getattr(p, "ep_group", None) is None],
                             axis_group(mesh_with_axis(ep_axis), ep_axis))
        _reduce_grads(model, fsdp_axis, fsdp_mesh, gathered)
        loss_sum, mse_sum = _global_mean(loss_sum, DATA_AXIS), _global_mean(mse_sum, DATA_AXIS)
        if want_aux:
            aux_sum, drop_sum = _global_mean(aux_sum, DATA_AXIS), _global_mean(drop_sum, DATA_AXIS)
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        psnr_val = 20.0 * torch.log10(1.0 / torch.sqrt(mse_sum))
        metrics = {"loss": loss_sum, "psnr": psnr_val}
        if want_aux:
            metrics["moe_aux"], metrics["moe_drop_frac"] = aux_sum, drop_sum
        return state, metrics

    return step


def make_pipelined_video_train_step(
    image_size: int,
    axis: str = "pipe",
    batch_axis: Optional[str] = None,
    microbatches: Optional[int] = None,
    loss: str = "mixed",
    alpha: float = 0.3,
    beta: float = 0.7,
    noise_std: float = 0.05,
    data_range: float = 1.0,
    aug: AugmentConfig = AugmentConfig(),
    remat: bool = False,
    fsdp_axis: Optional[str] = None,
    fsdp_mesh=None,
    accum_steps: int = 1,
    moe_aux_weight: float = 0.0,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """The flagship's train step with its temporal transformer run as a
    GPipe pipeline over ``axis`` of the ambient mesh
    (``parallel/pipeline.py``), on a state of
    ``pipeline.create_pipelined_train_state``: the objective, the
    augmentations and the noise of :func:`make_video_train_step`; the CNN's
    dropout draws are the monolithic step's, so with the temporal dropout
    off one step is the monolithic one; the stages draw theirs from
    generators folded by (tick, stage). Each rank of the axis holds one
    stage and its moments; the CNN runs on every rank of the axis, whose
    gradients are the same there. ``batch_axis``: the data axis, each
    rank's batch its block of the global one (the gradients' mean over it
    comes after). ``remat`` checkpoints the stage body (JAX's ``remat``,
    the ``full`` policy of the pipelined step). ``fsdp_axis``: the rest's
    parameters ZeRO-sharded over it, their gradients reduce-scattered.
    ``accum_steps`` wraps the pipeline: each microbatch of the batch
    streams the whole schedule. ``moe_aux_weight``: the objective adds that
    times the sum over layers of the mean over microbatches of the stages'
    load-balance losses (JAX's per-microbatch estimator)."""
    from tchvp_tpu_torch.parallel import pipeline as ppl

    want_aux = moe_aux_weight > 0.0
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = _loss_fn_by_name(loss, alpha, beta, data_range)

    def step(state: TrainState, batch: torch.Tensor, mark: Mark = None) -> Tuple[TrainState, Metrics]:
        with _whole_params(state.model) as gathered:
            return _step(state, batch, mark, gathered)

    def _step(state: TrainState, batch: torch.Tensor, mark: Mark, gathered) -> Tuple[TrainState, Metrics]:
        net = state.model.train()
        if want_aux and net.config.temporal.num_experts < 2:
            raise ValueError("moe_aux_weight set but the temporal config is dense (num_experts < 2)")
        clean = pipeline.preprocess_clip(batch, image_size)
        noise_gen, drop_gen = _step_generators(state)
        clean = pipeline.augment_geometric(noise_gen, clean, aug)
        noisy = pipeline.gaussian_noise(noise_gen, clean, noise_std)
        b, t = clean.shape[0], clean.shape[1]
        if b % accum_steps != 0:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        mb = b // accum_steps
        m = ppl.resolve_microbatches(mb, axis, batch_axis, microbatches)
        for p in net.parameters():
            p.grad = None
        if mark:
            mark("data")
        loss_sum = mse_sum = aux_sum = drop_sum = None
        for i in range(accum_steps):
            x, y = noisy[i * mb:(i + 1) * mb], clean[i * mb:(i + 1) * mb]
            out = net(x, generator=drop_gen, microbatches=m, batch_axis=batch_axis, remat=remat, extras=want_aux)
            recon = out[1].to(y.dtype)
            loss_val = loss_fn(recon.reshape((mb * t,) + recon.shape[2:]), y.reshape((mb * t,) + y.shape[2:]))
            if want_aux:
                ext = out[2].to(loss_val.device)
                aux, drop = ext[0] / m, ext[1] / (m * net.config.temporal.num_layers)
                loss_val = loss_val + moe_aux_weight * aux
                aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
                drop_sum = drop.detach() if drop_sum is None else drop_sum + drop.detach()
            mse_val = losses.mse(recon.detach(), y)
            if mark:
                mark("forward")
            loss_val.backward()
            if mark:
                mark("backward")
            loss_sum = loss_val.detach() if loss_sum is None else loss_sum + loss_val.detach()
            mse_sum = mse_val if mse_sum is None else mse_sum + mse_val
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            torch._foreach_mul_([p.grad for p in net.parameters() if p.grad is not None], inv)
            loss_sum, mse_sum = loss_sum * inv, mse_sum * inv
            if want_aux:
                aux_sum, drop_sum = aux_sum * inv, drop_sum * inv
        # The stages' gradients stay with their stage (JAX's pp_constrain);
        # the mean over the data axis, or FSDP's reduce-scatter, comes next.
        dispatch_trace.record("pp_constrain")
        _reduce_grads(net, fsdp_axis, fsdp_mesh, gathered)
        loss_sum, mse_sum = _global_mean(loss_sum, DATA_AXIS), _global_mean(mse_sum, DATA_AXIS)
        if want_aux:
            aux_sum, drop_sum = _global_mean(aux_sum, DATA_AXIS), _global_mean(drop_sum, DATA_AXIS)
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        metrics = {"loss": loss_sum, "psnr": 20.0 * torch.log10(1.0 / torch.sqrt(mse_sum))}
        if want_aux:
            metrics["moe_aux"], metrics["moe_drop_frac"] = aux_sum, drop_sum
        return state, metrics

    return step


def make_pipelined_video_eval_step(image_size: int, axis: str = "pipe", batch_axis: Optional[str] = None,
                                   microbatches: Optional[int] = None) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """No-grad PSNR through the pipelined forward (a state of the pipelined
    layout), of the global batch's MSE under ``batch_axis``."""
    from tchvp_tpu_torch.parallel import pipeline as ppl

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        net = state.model.eval()
        clean = pipeline.preprocess_clip(batch, image_size)
        m = ppl.resolve_microbatches(clean.shape[0], axis, batch_axis, microbatches)
        with torch.no_grad(), fsdp.gathered(net):
            _, recon = net(clean, microbatches=m, batch_axis=batch_axis)
            mse = _global_mean(losses.mse(recon, clean), DATA_AXIS)
        return {"psnr": 20.0 * torch.log10(1.0 / torch.sqrt(mse))}

    return step


def make_video_eval_step(image_size: int, qat: bool = False,
                         qat_dense: bool = False) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """No-grad PSNR of the eval-mode model on a uint8 clip (the global clip
    under sequence parallelism, this rank's block of the batch under data
    parallelism; the PSNR of the global MSE); with ``qat``, under the QAT
    step's fake-int8 forward."""

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        model = state.model.eval()
        clean = pipeline.preprocess_clip(batch, image_size)
        seq_axis = _seq_axis(model)
        if seq_axis is not None:
            clean = shard_frames(clean, mesh_with_axis(seq_axis), seq_axis)
        with torch.no_grad(), _qat_scope(qat, qat_dense), fsdp.gathered(model):
            _, recon = model(clean)
            mse = _global_mean(losses.mse(recon, clean), seq_axis, DATA_AXIS)
        return {"psnr": 20.0 * torch.log10(1.0 / torch.sqrt(mse))}

    return step


def denoising_draws(generator: torch.Generator, clean: torch.Tensor,
                    aug: AugmentConfig = AugmentConfig()) -> Dict[str, Dict[str, tuple]]:
    """The input draws of one denoising step, from ``generator``: the
    geometric augmentations' on the clean batch (JAX's ``k_geo``), then the
    corruption's (``k_aug``); :func:`make_denoising_train_step` applies
    them in their ``*_with`` forms."""
    return {"geometric": pipeline.geometric_draws(generator, clean, aug),
            "denoising": pipeline.denoising_draws(generator, clean, aug)}


def make_denoising_train_step(
    image_size: int,
    aug: AugmentConfig = AugmentConfig(),
    loss: str = "mixed",
    alpha: float = 0.5,
    beta: float = 0.5,
    data_range: float = 1.0,
    fsdp_axis: Optional[str] = None,
    fsdp_mesh=None,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """The denoising-AE step (Model.py:33-70): corrupt the input,
    reconstruct the clean image. The model returns ``(latent, recon)``
    (``AutoEncoder``, ``Autoencoder32K``).

    uint8 (B, H, W, 3) -> preprocess -> the geometric augmentations of the
    clean image (input and target move together; off by default) ->
    ``augment_denoising`` -> the train-mode forward (dropout from
    ``state.dropout_generator``) -> ``loss`` by name with ``alpha``,
    ``beta``, ``data_range`` against the clean image -> backward -> one
    optimizer update. The input draws come from ``state.noise_generator``
    (:func:`denoising_draws`) unless ``draws`` is given. The returned
    ``step(state, batch, mark=None, draws=None)`` updates ``state`` in
    place and returns ``(state, {"loss", "psnr"})`` as device tensors.
    ``fsdp_axis``: as :func:`make_video_train_step`'s."""
    loss_fn = _loss_fn_by_name(loss, alpha, beta, data_range)

    def step(state: TrainState, batch: torch.Tensor, mark: Mark = None,
             draws: Optional[Dict[str, Dict[str, tuple]]] = None) -> Tuple[TrainState, Metrics]:
        with _whole_params(state.model) as gathered:
            return _step(state, batch, mark, draws, gathered)

    def _step(state, batch, mark, draws, gathered) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        clean = pipeline.preprocess_images(batch, image_size)
        noise_gen, drop_gen = _step_generators(state)
        if draws is None:
            draws = denoising_draws(noise_gen, clean, aug)
        clean = pipeline.augment_geometric_with(clean, aug, draws["geometric"])
        corrupted = pipeline.augment_denoising_with(clean, aug, draws["denoising"])
        for p in model.parameters():
            p.grad = None
        if mark:
            mark("data")
        recon = model(corrupted, generator=drop_gen)[1]
        loss_val = loss_fn(recon, clean)
        if mark:
            mark("forward")
        loss_val.backward()
        if mark:
            mark("backward")
        _reduce_grads(model, fsdp_axis, fsdp_mesh, gathered)
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        return state, {"loss": _global_mean(loss_val.detach(), DATA_AXIS),
                       "psnr": _global_psnr(recon.detach(), clean)}

    return step


def make_denoising_eval_step(image_size: int) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """No-grad PSNR of the eval-mode model's reconstruction of the clean
    images (Model.py:75-92)."""

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        model = state.model.eval()
        clean = pipeline.preprocess_images(batch, image_size)
        with torch.no_grad(), fsdp.gathered(model):
            return {"psnr": _global_psnr(model(clean)[1], clean)}

    return step


def make_inpainting_test_step(image_size: int, aug: AugmentConfig = AugmentConfig()) -> Callable:
    """Test-time blackout inpainting (Model.py:96-135): 0-3 blackouts of
    ``aug.test_blackout_size`` drawn from ``generator`` (or given as
    ``draws``, ``pipeline.blackout_draws``'s triple), the eval-mode
    reconstruction against the clean images. The returned
    ``step(state, batch, generator, draws=None)`` returns ``({"psnr"},
    corrupted, prediction)`` for sample dumps."""

    def step(state: TrainState, batch: torch.Tensor, generator: Optional[torch.Generator],
             draws: Optional[tuple] = None):
        model = state.model.eval()
        clean = pipeline.preprocess_images(batch, image_size)
        if draws is None:
            draws = pipeline.blackout_draws(generator, clean, aug.max_blackout_patches,
                                            aug.test_blackout_size)
        corrupted = pipeline.blackout_with(clean, *draws, aug.test_blackout_size)
        with torch.no_grad(), fsdp.gathered(model):
            recon = model(corrupted)[1]
        return {"psnr": _global_psnr(recon, clean)}, corrupted, recon

    return step


def _seg_batch(batch, image_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 images (B, H, W, C), uint8 masks (B, H, W, 1)) -> both
    resized to ``image_size`` and scaled to [0, 1]."""
    image_u8, mask_u8 = batch
    return (pipeline.preprocess_images(image_u8, image_size),
            pipeline.preprocess_images(mask_u8, image_size))


def _seg_metrics(loss_fn: Callable, pred: torch.Tensor, y: torch.Tensor) -> Metrics:
    """The loss and IoU of the global batch: under a data mesh, dice and IoU
    from sums all-reduced over the axis (the dice's all-reduce adjoint
    carries the other ranks' part of its gradient), a mean loss as the mean
    over the axis."""
    group = _data_group()
    if group is None:
        return {"loss": loss_fn(pred, y), "iou": losses.jaccard_score(pred > 0.5, y > 0.5)}
    if loss_fn is losses.dice_loss:
        p, t = pred[..., 0].reshape(-1).float(), y[..., 0].reshape(-1).float()
        inter, sum_p, sum_t = all_reduce_sum(torch.stack([(p * t).sum(), p.sum(), t.sum()]), group)
        loss = 1.0 - (2.0 * inter + 1.0) / (sum_p + sum_t + 1.0)
    else:
        loss = loss_fn(pred, y)
    pb, tb = (pred[..., 0] > 0.5).reshape(-1), (y[..., 0] > 0.5).reshape(-1)
    counts = all_reduce_sum(torch.stack([(tb & pb).sum(), (tb | pb).sum()]).float(), group)
    return {"loss": loss, "iou": counts[0] / counts[1]}


def _select(out, output_index: Optional[int]):
    return out[output_index] if output_index is not None else out


def make_segmentation_train_step(
    image_size: int, loss: str = "dice", output_index: Optional[int] = None,
    fsdp_axis: Optional[str] = None, fsdp_mesh=None,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Supervised mask training step (FCT_FLOW.train, FCT.py:317-374): the
    train-mode forward on the preprocessed images, ``loss`` (dice by
    default, or any :func:`_loss_fn_by_name` loss) against the masks,
    backward, one optimizer update. Every dropout and drop-path draw comes
    from ``state.dropout_generator``; a model without BatchNorm carries no
    stats. The returned ``step(state, (images_u8, masks_u8), mark=None)``
    updates ``state`` in place and returns ``(state, {"loss", "iou"})``,
    IoU of ``pred > 0.5`` against ``mask > 0.5``, as device tensors.
    ``output_index`` picks the mask from a model that returns a tuple
    (``Autoencoder32K("mask")``'s ``(latent, mask)``: the transfer
    workload). Parameters that do not require a gradient (a frozen
    encoder) get none; train-mode BatchNorm moves their stats all the same.
    ``fsdp_axis``: as :func:`make_video_train_step`'s."""
    loss_fn = _loss_fn_by_name(loss)

    def step(state: TrainState, batch, mark: Mark = None) -> Tuple[TrainState, Metrics]:
        with _whole_params(state.model) as gathered:
            return _step(state, batch, mark, gathered)

    def _step(state: TrainState, batch, mark: Mark, gathered) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        x, y = _seg_batch(batch, image_size)
        for p in model.parameters():
            p.grad = None
        if mark:
            mark("data")
        pred = _select(model(x, generator=_step_generators(state)[1]), output_index)
        metrics = _seg_metrics(loss_fn, pred, y)
        if mark:
            mark("forward")
        metrics["loss"].backward()
        if mark:
            mark("backward")
        _reduce_grads(model, fsdp_axis, fsdp_mesh, gathered)
        if loss_fn is not losses.dice_loss:
            metrics["loss"] = _global_mean(metrics["loss"], DATA_AXIS)
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_segmentation_eval_step(
    image_size: int, loss: str = "dice", output_index: Optional[int] = None
) -> Callable[[TrainState, Tuple[torch.Tensor, torch.Tensor]], Metrics]:
    """No-grad ``loss`` and IoU of the eval-mode model on a batch
    (``output_index``: as the train step's)."""
    loss_fn = _loss_fn_by_name(loss)

    def step(state: TrainState, batch) -> Metrics:
        model = state.model.eval()
        x, y = _seg_batch(batch, image_size)
        with torch.no_grad(), fsdp.gathered(model):
            metrics = _seg_metrics(loss_fn, _select(model(x), output_index), y)
        if loss_fn is not losses.dice_loss:
            metrics["loss"] = _global_mean(metrics["loss"], DATA_AXIS)
        return metrics

    return step
