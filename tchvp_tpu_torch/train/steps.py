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

Sequence parallelism: when the model's ``config.temporal.seq_axis`` is on
an ambient mesh with size > 1 (``parallel.mesh.mesh_with_axis``), every
rank is given the same global clip and keeps its block of the frames. The
noise and the dropout draws are made at the global shape from the shared
generators, the same on every rank, and each rank keeps its part. Each rank
backpropagates its local loss; the collectives' adjoints carry the other
ranks' cotangents, so the gradients' mean over the axis, all-reduced before
clipping and the update, is the global loss's gradient, and the parameters
stay bit-equal across ranks. Loss, MSE and PSNR come back global. The
remat policies other than ``"none"`` and ``accum_steps > 1`` are not ported
there and raise.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tchvp_tpu_torch import losses
from tchvp_tpu_torch.config import AugmentConfig
from tchvp_tpu_torch.data import pipeline
from tchvp_tpu_torch.ops.blocks import frozen_batch_stats, with_current_hook
from tchvp_tpu_torch.parallel.collectives import all_reduce_mean_, all_reduce_sum
from tchvp_tpu_torch.parallel.mesh import axis_group, axis_size, mesh_with_axis, shard_frames
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


def _global_mean(x: torch.Tensor, seq_axis: Optional[str]) -> torch.Tensor:
    """A per-rank mean over equal shares as the mean over the axis."""
    if seq_axis is None:
        return x
    mesh = mesh_with_axis(seq_axis)
    return all_reduce_sum(x.detach(), axis_group(mesh, seq_axis)) / axis_size(mesh, seq_axis)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _qat_scope(qat: bool, dense: bool):
    """:func:`~tchvp_tpu_torch.train.qat.qat_fake_quant` when ``qat``."""
    if not qat:
        return contextlib.nullcontext()
    from tchvp_tpu_torch.train.qat import qat_fake_quant

    return qat_fake_quant(dense=dense)


def _remat_forward(model: torch.nn.Module, x: torch.Tensor, draws, policy: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, recon) of the train-mode forward under ``policy``."""
    if policy == "none":
        return model(x, draws=draws)
    # Each region carries the conv hook in scope now (QAT's fake quant)
    # into its recompute, which runs on the autograd engine's thread.
    ckpt = functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)
    if policy == "full" or (policy == "stages" and not hasattr(model, "temporal_mix")):
        return ckpt(_stats_once(model, with_current_hook(lambda c: model(c, draws=draws))), x)
    if policy == "dots":
        return ckpt(_stats_once(model, with_current_hook(lambda c: model(c, draws=draws))), x,
                    context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    # "stages": only the clip and the two stage-boundary token tensors stay.
    tokens, hw = ckpt(_stats_once(model, with_current_hook(lambda c: model.encode_clip(c, draws=draws))), x)
    tokens = ckpt(with_current_hook(lambda t: model.temporal_mix(t, draws=draws)), tokens)
    recon = ckpt(_stats_once(model, with_current_hook(lambda t: model.decode_tokens(t, hw))), tokens)
    return tokens, recon


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

    ``qat=True``: quantization-aware training; every conv (and, with
    ``qat_dense``, every Dense) runs on fake-int8 input and kernel with STE
    gradients (:mod:`tchvp_tpu_torch.train.qat`), so the fp32 weights train
    against the int8 serving engine's arithmetic.

    The returned ``step(state, batch, mark=None)`` updates ``state`` in
    place and returns ``(state, {"loss", "psnr"})``. Under sequence
    parallelism (module docstring) ``batch`` is the global clip.
    """
    if fsdp_axis is not None or fsdp_mesh is not None:
        raise NotImplementedError(
            "fsdp_axis is not ported yet (ROADMAP.md, modules to port, item 11: parallel/fsdp.py)")
    if moe_aux_weight > 0.0:
        raise NotImplementedError(
            "moe_aux_weight is not ported yet (ROADMAP.md, modules to port, item 11: ops/moe.py)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if remat and remat_policy == "none":
        remat_policy = "full"
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be none|full|stages|dots, got {remat_policy!r}")
    loss_fn = _loss_fn_by_name(loss, alpha, beta, data_range)

    def step(state: TrainState, batch: torch.Tensor, mark: Mark = None) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        seq_axis = _seq_axis(model)
        if seq_axis is not None and (remat_policy != "none" or accum_steps > 1):
            raise NotImplementedError(
                "remat policies and accum_steps > 1 under sequence parallelism are not ported yet "
                "(ROADMAP.md, modules to port, item 11: parallelism)")
        clean = pipeline.preprocess_clip(batch, image_size)
        clean = pipeline.augment_geometric(state.noise_generator, clean, aug)
        noisy = pipeline.gaussian_noise(state.noise_generator, clean, noise_std)
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
        loss_sum = mse_sum = None
        for i in range(accum_steps):
            x, y = noisy[i * mb:(i + 1) * mb], clean[i * mb:(i + 1) * mb]
            draws = model.draw_dropout(x.shape, state.dropout_generator, x.device)
            with _qat_scope(qat, qat_dense):
                _, recon = _remat_forward(model, x, draws, remat_policy)
            # A compute_dtype model's bf16 recon meets the fp32 clip in the
            # loss at fp32, as jnp's type promotion has it in JAX.
            recon = recon.to(y.dtype)
            flat_r = recon.reshape((mb * t,) + recon.shape[2:])
            flat_c = y.reshape((mb * t,) + y.shape[2:])
            loss_val = loss_fn(flat_r, flat_c)
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
        if seq_axis is not None:
            all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None],
                             axis_group(mesh_with_axis(seq_axis), seq_axis))
            loss_sum, mse_sum = _global_mean(loss_sum, seq_axis), _global_mean(mse_sum, seq_axis)
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        psnr_val = 20.0 * torch.log10(1.0 / torch.sqrt(mse_sum))
        return state, {"loss": loss_sum, "psnr": psnr_val}

    return step


def make_video_eval_step(image_size: int, qat: bool = False,
                         qat_dense: bool = False) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """No-grad PSNR of the eval-mode model on a uint8 clip (the global clip
    under sequence parallelism; the PSNR of the global MSE); with ``qat``,
    under the QAT step's fake-int8 forward."""

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        model = state.model.eval()
        clean = pipeline.preprocess_clip(batch, image_size)
        seq_axis = _seq_axis(model)
        if seq_axis is not None:
            clean = shard_frames(clean, mesh_with_axis(seq_axis), seq_axis)
        with torch.no_grad(), _qat_scope(qat, qat_dense):
            _, recon = model(clean)
            mse = _global_mean(losses.mse(recon, clean), seq_axis)
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
    place and returns ``(state, {"loss", "psnr"})`` as device tensors."""
    if fsdp_axis is not None or fsdp_mesh is not None:
        raise NotImplementedError(
            "fsdp_axis is not ported yet (ROADMAP.md, modules to port, item 11: parallel/fsdp.py)")
    loss_fn = _loss_fn_by_name(loss, alpha, beta, data_range)

    def step(state: TrainState, batch: torch.Tensor, mark: Mark = None,
             draws: Optional[Dict[str, Dict[str, tuple]]] = None) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        clean = pipeline.preprocess_images(batch, image_size)
        if draws is None:
            draws = denoising_draws(state.noise_generator, clean, aug)
        clean = pipeline.augment_geometric_with(clean, aug, draws["geometric"])
        corrupted = pipeline.augment_denoising_with(clean, aug, draws["denoising"])
        for p in model.parameters():
            p.grad = None
        if mark:
            mark("data")
        recon = model(corrupted, generator=state.dropout_generator)[1]
        loss_val = loss_fn(recon, clean)
        if mark:
            mark("forward")
        loss_val.backward()
        if mark:
            mark("backward")
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        return state, {"loss": loss_val.detach(), "psnr": losses.psnr(recon.detach(), clean)}

    return step


def make_denoising_eval_step(image_size: int) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """No-grad PSNR of the eval-mode model's reconstruction of the clean
    images (Model.py:75-92)."""

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        model = state.model.eval()
        clean = pipeline.preprocess_images(batch, image_size)
        with torch.no_grad():
            return {"psnr": losses.psnr(model(clean)[1], clean)}

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
        with torch.no_grad():
            recon = model(corrupted)[1]
        return {"psnr": losses.psnr(recon, clean)}, corrupted, recon

    return step


def _seg_batch(batch, image_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 images (B, H, W, C), uint8 masks (B, H, W, 1)) -> both
    resized to ``image_size`` and scaled to [0, 1]."""
    image_u8, mask_u8 = batch
    return (pipeline.preprocess_images(image_u8, image_size),
            pipeline.preprocess_images(mask_u8, image_size))


def _seg_metrics(loss_fn: Callable, pred: torch.Tensor, y: torch.Tensor) -> Metrics:
    return {"loss": loss_fn(pred, y), "iou": losses.jaccard_score(pred > 0.5, y > 0.5)}


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
    encoder) get none; train-mode BatchNorm moves their stats all the same."""
    if fsdp_axis is not None or fsdp_mesh is not None:
        raise NotImplementedError(
            "fsdp_axis is not ported yet (ROADMAP.md, modules to port, item 11: parallel/fsdp.py)")
    loss_fn = _loss_fn_by_name(loss)

    def step(state: TrainState, batch, mark: Mark = None) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        x, y = _seg_batch(batch, image_size)
        for p in model.parameters():
            p.grad = None
        if mark:
            mark("data")
        pred = _select(model(x, generator=state.dropout_generator), output_index)
        metrics = _seg_metrics(loss_fn, pred, y)
        if mark:
            mark("forward")
        metrics["loss"].backward()
        if mark:
            mark("backward")
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
        with torch.no_grad():
            return _seg_metrics(loss_fn, _select(model(x), output_index), y)

    return step
