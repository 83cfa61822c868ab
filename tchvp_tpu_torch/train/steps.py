"""Train and eval steps of the flagship video model.

Counterpart of ``tchvp_tpu/train/steps.py``'s ``make_video_train_step``,
``make_video_eval_step`` and ``_loss_fn_by_name``. A step takes a uint8
clip (B, T, H, W, 3) on the model's device and runs, eagerly:
preprocess -> Gaussian input noise -> the train-mode forward -> the loss
over frames folded into the batch -> backward -> one optimizer update. The
BatchNorm running stats move inside the forward, once per (micro)batch.
Metrics come back as device tensors: the step never waits for the device.

Randomness. The JAX step splits its key up front (``k_noise``, ``k_drop``);
here the noise comes from ``state.noise_generator`` and every dropout draw
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
running stats alone, so they move once per forward as in JAX.
"""

from __future__ import annotations

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
from tchvp_tpu_torch.ops.blocks import frozen_batch_stats
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


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_forward(model: torch.nn.Module, x: torch.Tensor, draws, policy: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, recon) of the train-mode forward under ``policy``."""
    if policy == "none":
        return model(x, draws=draws)
    ckpt = functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)
    if policy == "full":
        return ckpt(_stats_once(model, lambda c: model(c, draws=draws)), x)
    if policy == "dots":
        return ckpt(_stats_once(model, lambda c: model(c, draws=draws)), x,
                    context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    # "stages": only the clip and the two stage-boundary token tensors stay.
    tokens, hw = ckpt(_stats_once(model, lambda c: model.encode_clip(c, draws=draws)), x)
    tokens = ckpt(lambda t: model.temporal_mix(t, draws=draws), tokens)
    recon = ckpt(_stats_once(model, lambda t: model.decode_tokens(t, hw)), tokens)
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

    The returned ``step(state, batch, mark=None)`` updates ``state`` in
    place and returns ``(state, {"loss", "psnr"})``.
    """
    if qat:
        raise NotImplementedError(
            "qat is not ported yet (ROADMAP.md, modules to port, item 10: train/qat.py)")
    if fsdp_axis is not None or fsdp_mesh is not None:
        raise NotImplementedError(
            "fsdp_axis is not ported yet (ROADMAP.md, modules to port, item 11: parallel/fsdp.py)")
    if moe_aux_weight > 0.0:
        raise NotImplementedError(
            "moe_aux_weight is not ported yet (ROADMAP.md, modules to port, item 11: ops/moe.py)")
    if aug != AugmentConfig():
        raise NotImplementedError(
            "a non-default AugmentConfig is not ported yet "
            "(ROADMAP.md, modules to port, item 8: the augmentations)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if remat and remat_policy == "none":
        remat_policy = "full"
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be none|full|stages|dots, got {remat_policy!r}")
    loss_fn = _loss_fn_by_name(loss, alpha, beta, data_range)

    def step(state: TrainState, batch: torch.Tensor, mark: Mark = None) -> Tuple[TrainState, Metrics]:
        model = state.model.train()
        clean = pipeline.preprocess_clip(batch, image_size)
        clean = pipeline.augment_geometric(state.noise_generator, clean, aug)
        noisy = pipeline.gaussian_noise(state.noise_generator, clean, noise_std)
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
            _, recon = _remat_forward(model, x, draws, remat_policy)
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
        state.tx.step()
        state.step += 1
        if mark:
            mark("optimizer")
        psnr_val = 20.0 * torch.log10(1.0 / torch.sqrt(mse_sum))
        return state, {"loss": loss_sum, "psnr": psnr_val}

    return step


def make_video_eval_step(image_size: int, qat: bool = False,
                         qat_dense: bool = False) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """No-grad PSNR of the eval-mode model on a uint8 clip."""
    if qat:
        raise NotImplementedError(
            "qat is not ported yet (ROADMAP.md, modules to port, item 10: train/qat.py)")

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        model = state.model.eval()
        clean = pipeline.preprocess_clip(batch, image_size)
        with torch.no_grad():
            _, recon = model(clean)
        return {"psnr": losses.psnr(recon, clean)}

    return step
