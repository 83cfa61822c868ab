"""Worker bodies of the port's sequence-parallel tests.

:func:`run` is the target of ``torch.multiprocessing.spawn``: each rank
joins a gloo group over a ``file://`` rendezvous with a timeout (a failing
rank then ends the run instead of hanging the others), runs the port's
sequence-parallel paths on the numpy inputs the parent test made, and saves
what it got to ``<out_dir>/rank<r>.pt`` for the parent to compare with JAX
and with the port's unsharded paths. The ranks import the port, torch and
numpy, never JAX.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import torch

from tchvp_tpu_torch import parallel
from tchvp_tpu_torch.config import flagship_video_config as _FLAGSHIP
from tchvp_tpu_torch.config import TransformerConfig
from tchvp_tpu_torch.models.transformer import TransformerEncoder
from tchvp_tpu_torch.models.video import VideoHybridNet
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.parallel import collectives
from tchvp_tpu_torch.parallel.input import local_rows
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps


def _block(x: np.ndarray, dim: int, n: int, i: int) -> torch.Tensor:
    """Rank i's contiguous block of ``x`` along ``dim``."""
    step = x.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(np.take(x, range(i * step, (i + 1) * step), axis=dim)))


def _attention(inp, n, i):
    """Both routes of sdpa_windowed_seq_sharded: out and the gradients of
    sum(out**2) of this rank's block; and the flash route with dropout."""
    got = {}
    for route in ("dense", "flash"):
        q, k, v = (_block(t, 2, n, i).requires_grad_() for t in inp["qkv"])
        with dispatch_trace.capture() as seen:
            out = tatt.sdpa_windowed_seq_sharded(q, k, v, window_size=inp["window"], seq_axis="seq",
                                                 use_flash=route == "flash")
            (out ** 2).sum().backward()
        got[route] = {"out": out.detach(), "grads": [t.grad for t in (q, k, v)], "seen": seen}
    q, k, v = (_block(t, 2, n, i) for t in inp["qkv"])
    got["dropout"] = tatt.sdpa_windowed_seq_sharded(
        q, k, v, window_size=inp["window"], seq_axis="seq", use_flash=True, dropout_rate=0.2,
        generator=torch.Generator().manual_seed(5), deterministic=False)
    try:
        tatt.sdpa_windowed_seq_sharded(q, k, v, window_size=3, seq_axis="seq")
    except ValueError as e:
        got["bad_window"] = str(e)
    return got


def _dispatch(inp, n, i, world):
    """The seq_axis rows of JAX's dispatch matrix: (markers, this rank's
    output) of each; under a mesh without the axis the rank holds every
    token."""
    rows = {}
    for key, (impl, window, mesh_axes) in inp["rows"].items():
        x = torch.from_numpy(inp["x"])
        if "seq" in mesh_axes:
            x = _block(inp["x"], 1, n, i)
        mesh = parallel.make_mesh(mesh_axes, (world,))
        with parallel.activate_mesh(mesh), dispatch_trace.capture() as seen:
            out = tatt.multi_head_attention(x, x, x, inp["heads"], impl=impl, window_size=window,
                                            seq_axis="seq")
        rows[key] = (seen, out)
    x = _block(inp["x"], 1, n, i)
    with parallel.activate_mesh(parallel.make_mesh(("seq",), (world,))), dispatch_trace.capture() as seen:
        rows["ring"] = (seen, tatt.multi_head_attention(x, x, x, inp["heads"], impl="ring", seq_axis="seq"))
    return rows


def _transformer(inp, n, i):
    """TransformerEncoder(seq_axis="seq") on this rank's tokens, eval."""
    got = {}
    for impl in ("windowed", "flash"):
        model = TransformerEncoder(TransformerConfig(**inp["config"], attn_impl=impl, seq_axis="seq"))
        model.load_state_dict(inp["state"])
        with torch.no_grad():
            got[impl] = model.eval()(_block(inp["x"], 1, n, i))
    return got


def _video(inp, n, i):
    """One seq-parallel train step of the flagship (the global clip in),
    the cross-rank bit checks, the options that raise, then the eval
    forward of the loaded weights on this rank's frames and the eval step's
    PSNR."""
    config = inp["config"]
    model = VideoHybridNet(config, device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, torch.from_numpy(inp["batch"]))
    mesh = parallel.ambient_mesh()
    group = parallel.axis_group(mesh, "seq")
    named = dict(model.named_parameters())
    buffers = {k: b for k, b in model.named_buffers() if "running" in k}
    equal = collectives.equal_across(list(named.values()) + list(buffers.values()), group)
    got = {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen,
           "grads": {k: p.grad.clone() for k, p in named.items()},
           "state": {k: v.clone() for k, v in model.state_dict().items()},
           "equal_across": dict(zip(list(named) + list(buffers), equal))}
    # The remat policies and accum_steps under the mesh, each from the
    # loaded weights: their gradients, and the parameters' cross-rank bits.
    got["options"] = {}
    for policy, accum in (("stages", 1), ("none", 2)):
        model.load_state_dict(inp["state"], strict=True)
        opt_state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
        _, m = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, remat_policy=policy,
                                            accum_steps=accum)(opt_state, torch.from_numpy(inp["batch"]))
        got["options"][(policy, accum)] = {
            "loss": float(m["loss"]), "grads": {k: p.grad.clone() for k, p in named.items()},
            "stats": {k: b.clone() for k, b in model.named_buffers() if "running" in k},
            "equal": all(collectives.equal_across(list(named.values()), group))}
    # The eval forward of the loaded weights on this rank's frames: the
    # positional encoding must take the global rows of this block.
    model.load_state_dict(inp["state"], strict=True)
    clip = _block(inp["clip"], 1, n, i)
    with torch.no_grad():
        got["eval"] = model.eval()(clip)
    psnr = tsteps.make_video_eval_step(inp["size"])(state, torch.from_numpy(inp["batch"]))
    got["eval_psnr"] = float(psnr["psnr"])
    return got


def _collectives(n, i):
    """ppermute's forward (rank 0 gets zeros) and adjoint (the gradient goes
    back to the owner), all_reduce_sum's adjoint."""
    group = parallel.axis_group(parallel.ambient_mesh(), "seq")
    x = torch.full((2, 3), float(i + 1), requires_grad=True)
    y = collectives.ppermute(x, group)
    (y * (i + 1)).sum().backward()
    z = torch.full((4,), float(i + 1), requires_grad=True)
    s = collectives.all_reduce_sum(z, group)
    (s * (i + 1)).sum().backward()
    return {"ppermute": y.detach(), "ppermute_grad": x.grad, "all_reduce": s.detach(),
            "all_reduce_grad": z.grad}


def run(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    try:
        results = {}
        results["dispatch"] = _dispatch(inputs["dispatch"], world, rank, world)
        with parallel.activate_mesh(parallel.make_mesh(("data", "seq"), (1, world))):
            results["collectives"] = _collectives(world, rank)
            results["attention"] = _attention(inputs["attention"], world, rank)
            results["transformer"] = _transformer(inputs["transformer"], world, rank)
            results["video"] = _video(inputs["video"], world, rank)
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def flagship_without_dropout(*args, **kwargs):
    """``flagship_video_config`` with every dropout rate 0: the flash route
    of sharded windowed attention draws one dropout seed per shard, so only
    without dropout does a sharded step equal the unsharded one."""
    import dataclasses

    c = _FLAGSHIP(*args, **kwargs)
    return dataclasses.replace(c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
                               temporal=dataclasses.replace(c.temporal, dropout_rate=0.0))


def run_cli(rank: int, world: int, rendezvous: str, out_dir: str, argv: list) -> None:
    """One rank of ``python -m tchvp_tpu_torch.cli <argv>`` launched as the
    CLI's multi-process mode expects (``--coordinator``, ``--num-processes``,
    ``--process-id``), its model built without dropout
    (:func:`flagship_without_dropout`); saves the dispatch markers it
    recorded to ``<out_dir>/cli_rank<r>.pt``."""
    from tchvp_tpu_torch import cli, config

    torch.set_num_threads(1)
    config.flagship_video_config = flagship_without_dropout
    with dispatch_trace.capture() as seen:
        cli.main(list(argv) + ["--coordinator", f"file://{rendezvous}", "--num-processes", str(world),
                               "--process-id", str(rank)])
    torch.save({"seen": seen,
                "jax_loaded": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))},
               Path(out_dir) / f"cli_rank{rank}.pt")


# ------------------------------------------------ ring attention and experts


def _grads_of(fn, tensors):
    """fn(*tensors) and the gradients of sum(out**2) for each tensor."""
    leaves = [t.clone().requires_grad_() for t in tensors]
    out = fn(*leaves)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _ring(inp, n, i):
    """sdpa_ring_seq_sharded on this rank's blocks: each loop form with and
    without per-hop remat, dropout, the errors; multi_head_attention's ring
    and module 8 (the gathered full attention: the kernel's plain version,
    and the dense core with a mask)."""
    got = {}
    blocks = [_block(t, 2, n, i) for t in inp["qkv"]]
    for loop, remat in (("unroll", True), ("scan", True), ("auto", True), ("unroll", False)):
        with dispatch_trace.capture() as seen:
            out, grads = _grads_of(lambda q, k, v: tatt.sdpa_ring_seq_sharded(
                q, k, v, seq_axis="seq", scale=0.3, loop=loop, remat=remat), blocks)
        got[(loop, remat)] = {"out": out, "grads": grads, "seen": seen}
    for loop in ("unroll", "scan"):
        gen = torch.Generator().manual_seed(5)
        got[("dropout", loop)] = _grads_of(lambda q, k, v: tatt.sdpa_ring_seq_sharded(
            q, k, v, seq_axis="seq", dropout_rate=0.3, generator=gen, deterministic=False, loop=loop),
            blocks)
    for name, call in (("bad_loop", lambda: tatt.sdpa_ring_seq_sharded(*blocks, seq_axis="seq", loop="x")),
                       ("uneven", lambda: parallel.shard_frames(
                           torch.zeros(1, inp["qkv"][0].shape[2] - 1, 1), parallel.ambient_mesh(), "seq"))):
        try:
            call()
        except ValueError as e:
            got[name] = str(e)
    x = _block(inp["x"], 1, n, i)
    with dispatch_trace.capture() as seen:
        out = tatt.multi_head_attention(x, x, x, inp["heads"], impl="ring", seq_axis="seq")
    got["mha_ring"] = (seen, out)
    # Module 8: full attention over seq-sharded tokens.
    with dispatch_trace.capture() as seen:
        out, grads = _grads_of(lambda a, b, c: tatt.multi_head_attention(
            a, b, c, inp["heads"], impl="flash", seq_axis="seq"), [x, x * 0.5, x * 2.0])
    got["gathered_flash"] = (seen, out, grads)
    gen = torch.Generator().manual_seed(9)
    got["gathered_flash_dropout"] = tatt.multi_head_attention(
        x, x, x, inp["heads"], impl="flash", seq_axis="seq", dropout_rate=0.3, generator=gen,
        deterministic=False)
    with dispatch_trace.capture() as seen:
        out = tatt.multi_head_attention(x, x, x, inp["heads"], impl="xla", seq_axis="seq",
                                        mask=torch.from_numpy(inp["mask"]))
    got["gathered_mask"] = (seen, out)
    return got


def _moe_seq(inp, n, i):
    """The MoE encoder with seq_axis on this rank's block of the tokens:
    routing and capacity are per batch row over the whole sequence, so the
    layer gathers the sequence and keeps its rows. Rank r's objective is
    its rows' sum(out**2) plus aux / n, so the ranks' objectives sum to the
    unsharded one."""
    from tchvp_tpu_torch.ops import moe as tmoe

    enc = TransformerEncoder(TransformerConfig(**inp["encoder"], seq_axis="seq"))
    enc.load_state_dict(inp["encoder_state"])
    x = _block(inp["x_moe"], 1, n, i).requires_grad_()
    sink = []
    with dispatch_trace.capture() as seen:
        out = enc.eval()(x, moe_sink=sink)
    ((out ** 2).sum() + tmoe.total_load_balance_loss(sink) / n).backward()
    return {"seen": seen, "out": out.detach(), "x_grad": x.grad,
            "aux": float(tmoe.total_load_balance_loss(sink)),
            "grads": {k: p.grad.clone() for k, p in enc.named_parameters()}}


def _seq_steps(inp, n, i):
    """The seq-parallel step of a ring-attention flagship with remat
    "stages" and accum_steps=2 (the global clip in), and the bit checks."""
    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, remat_policy="stages",
                                        accum_steps=2)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, torch.from_numpy(inp["batch"]))
    group = parallel.axis_group(parallel.ambient_mesh(), "seq")
    named = dict(model.named_parameters())
    equal = collectives.equal_across(list(named.values()), group)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen, "all_equal": all(equal),
            "grads": {k: p.grad.clone() for k, p in named.items()}}


def _experts(inp, n, i):
    """Expert parallelism: the MoE encoder's forward and gradients, the
    train step through VideoFlow (with its whole-expert checkpoint and
    resume), the E % n error and a mesh without the axis."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.ops import moe as tmoe
    from tchvp_tpu_torch.train import checkpoint as ckpt
    from tchvp_tpu_torch.train.loops import VideoFlow

    got = {}
    enc = TransformerEncoder(TransformerConfig(**inp["encoder"], ep_axis="expert"))
    enc.load_state_dict(inp["encoder_state"])
    x = torch.from_numpy(inp["x_moe"]).requires_grad_()
    sink = []
    with dispatch_trace.capture() as seen:
        out = enc.eval()(x, moe_sink=sink)
    ((out ** 2).sum() + tmoe.total_load_balance_loss(sink)).backward()
    got["encoder"] = {"seen": seen, "out": out.detach(), "x_grad": x.grad,
                      "grads": {k: p.grad.clone() for k, p in enc.named_parameters()}}
    try:
        tmoe.MoEFFN(8, 3, 4, ep_axis="expert")(torch.zeros(1, 4, 8))
    except ValueError as e:
        got["indivisible"] = str(e)
    with parallel.activate_mesh(parallel.make_mesh(("seq",), (n,))), dispatch_trace.capture() as seen:
        tmoe.MoEFFN(8, 4, 4, ep_axis="expert")(torch.zeros(1, 4, 8))
    got["no_axis"] = seen
    # Whether to skip a non-finite update is decided by the ranks together:
    # only rank 0's expert gradient is NaN, and every rank skips.
    model = VideoHybridNet(inp["config"], device="cpu")
    names = tmoe.shard_experts(model, "expert")
    tx = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd",
                                                                skip_nonfinite_updates=1)).tx
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    if i == 0:
        dict(model.named_parameters())[names[0]].grad.view(-1)[0] = float("nan")
    got["skipped"] = not tx.step()
    # The train step through VideoFlow: sharded experts, one whole checkpoint.
    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    cfg = TrainConfig(model_name="video", loss="mse", lr=1.0, optimizer="sgd", device_prefetch=0,
                      checkpoint_dir=inp["ckpt_dir"], moe_aux_weight=0.01)
    flow = VideoFlow(model, cfg=cfg, image_size=inp["size"], mesh=parallel.ambient_mesh(),
                     ep_axis="expert")
    flow._train_step = flow._under_mesh(tsteps.make_video_train_step(
        inp["size"], loss="mse", noise_std=0.0, moe_aux_weight=0.01))
    flow.init_state(2)
    with dispatch_trace.capture() as seen:
        flow.state, metrics = flow._train_step(flow.state, torch.from_numpy(inp["batch"]))
    named = dict(model.named_parameters())
    got["step"] = {"seen": seen, "metrics": {k: float(v) for k, v in metrics.items()},
                   "grads": {k: p.grad.clone() for k, p in named.items()},
                   "params": {k: p.detach().clone() for k, p in named.items()},
                   "expert_names": list(flow.expert_names),
                   "shapes": {k: tuple(p.shape) for k, p in named.items()}}
    flow._save(1, 1, None)
    torch.distributed.barrier()
    ckpt.wait_for_async_saves()
    whole = ckpt.restore_state(f"{inp['ckpt_dir']}/step_1")
    got["whole"] = {k: tuple(v.shape) for k, v in whole["model"].items() if ".moe." in k}
    again = VideoHybridNet(inp["config"], device="cpu")
    flow2 = VideoFlow(again, cfg=cfg, image_size=inp["size"], mesh=parallel.ambient_mesh(),
                      ep_axis="expert")
    flow2.resume(2)
    got["resumed_equal"] = all(torch.equal(p, named[k]) for k, p in again.named_parameters())
    got["resumed_moments_equal"] = all(
        torch.equal(flow2.state.tx.core.state[p]["momentum_buffer"],
                    flow.state.tx.core.state[named[k]]["momentum_buffer"])
        for k, p in again.named_parameters() if named[k] in flow.state.tx.core.state)
    return got


class WireSpy:
    """Records, for every tensor the port hands to ``torch.distributed``'s
    communication calls, its device and the device its group's backend
    carries (``collectives._carrier``)."""

    CALLS = ("all_reduce", "all_gather", "batch_isend_irecv", collectives.FLAT_ALL_GATHER,
             collectives.FLAT_REDUCE_SCATTER)

    def __init__(self):
        self.seen = []

    def _wrap(self, name, real):
        def call(*args, **kwargs):
            if name == "batch_isend_irecv":
                pairs = [(op.tensor, op.group) for op in args[0]]
            else:
                tensors = list(args[0]) if isinstance(args[0], list) else [args[0]]
                tensors += [a for a in args[1:] if torch.is_tensor(a)]
                pairs = [(t, kwargs.get("group")) for t in tensors]
            self.seen += [(name, t.device, collectives._carrier(g)) for t, g in pairs]
            return real(*args, **kwargs)
        return call

    def __enter__(self):
        self.real = {n: getattr(torch.distributed, n) for n in self.CALLS}
        for n, real in self.real.items():
            setattr(torch.distributed, n, self._wrap(n, real))
        return self

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(torch.distributed, n, real)


def _gathers(n: int, i: int) -> dict:
    """The gathers and the reduce-scatter of ``collectives`` over the
    ambient mesh's group: tensor parallelism's channel gathers (forward and
    backward), FSDP's flat gather and reduce-scatter mean, and the
    BatchNorm statistics' gather; each rank holds i + 1 in its block."""
    group = parallel.axis_group(parallel.ambient_mesh(), "expert")
    x = torch.full((2, 3), float(i + 1), requires_grad=True)
    g = collectives.all_gather_dim(x, group, 1)
    (g * torch.arange(g.shape[1], dtype=torch.float32)).sum().backward()
    whole = collectives.all_gather_along([torch.full((2, 1), float(i + 1))], [1], group)[0]
    mean = collectives.reduce_scatter_mean([torch.arange(2.0 * n).reshape(2, n) * (i + 1)], [1], group)[0]
    part = torch.arange(2.0 * n).reshape(2, n).mul(i + 1).requires_grad_()
    summed = collectives.reduce_scatter_dim(part, group, 1)
    (summed * (i + 1)).sum().backward()
    return {"gathered": g.detach(), "grad": x.grad, "along": whole, "mean": mean,
            "cat": collectives.all_gather_cat(torch.tensor([float(i)]), group),
            "summed": summed.detach(), "summed_grad": part.grad}


def run_ring(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One rank of ``tests/test_torch_ring.py``: ring attention and module 8
    and the remat/accum seq step under a ``seq`` mesh, then expert
    parallelism under an ``expert`` mesh, every collective watched by a
    :class:`WireSpy`."""
    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    try:
        results = {}
        with WireSpy() as spy:
            with parallel.activate_mesh(parallel.make_mesh(("seq",), (world,))):
                results["ring"] = _ring(inputs["ring"], world, rank)
                results["steps"] = _seq_steps(inputs["steps"], world, rank)
                results["moe_seq"] = _moe_seq(inputs["experts"], world, rank)
            with parallel.activate_mesh(parallel.make_mesh(("expert",), (world,))):
                results["experts"] = _experts(inputs["experts"], world, rank)
                results["gathers"] = _gathers(world, rank)
        results["wire"] = spy.seen
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, Path(out_dir) / f"ring_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ data parallelism


def _dp_options(inp):
    """data=n: remat "stages" and accum_steps=2, each from the loaded weights:
    the loss, the state afterwards and the cross-rank bits."""
    got = {}
    for policy, accum in (("stages", 1), ("none", 2)):
        model = VideoHybridNet(inp["config"], device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
        step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, remat_policy=policy,
                                            accum_steps=accum)
        _, m = step(state, local_rows(torch.from_numpy(inp["batch"]), parallel.ambient_mesh(), microbatches=accum))
        shared = list(model.parameters()) + [b for k, b in model.named_buffers() if "running" in k]
        got[(policy, accum)] = {"loss": float(m["loss"]), "state": {k: v.clone() for k, v in model.state_dict().items()},
                                "equal": all(collectives.equal_across(shared, torch.distributed.group.WORLD))}
    return got


def _dp_video(inp, moe: bool = False):
    """One train step of the flagship (SGD lr 1, MSE, no noise) on this
    rank's block of the global batch under the ambient mesh; with ``moe``
    the experts sharded over ``expert`` and the aux loss on. Returns the
    metrics, the state afterwards and whether every rank holds the same
    parameters and BatchNorm stats."""
    from tchvp_tpu_torch.ops import moe as tmoe

    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    names = tmoe.shard_experts(model, "expert") if moe else []
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0,
                                        moe_aux_weight=inp.get("aux", 0.0))
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, parallel.shard_batch(torch.from_numpy(inp["batch"]), parallel.ambient_mesh()))
    shared = [p for k, p in model.named_parameters() if k not in names]
    shared += [b for k, b in model.named_buffers() if "running" in k]
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen, "expert_names": names,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "equal": all(collectives.equal_across(shared, torch.distributed.group.WORLD))}


class keep_everything:
    """Within the scope the port's dropout keeps every element
    (``ops.blocks.draw_keep``), as a draw of its own would not repeat across
    ranks; FCT's Wide-Focus dropout has a fixed rate."""

    def __enter__(self):
        from tchvp_tpu_torch.ops import blocks

        self.real = blocks.draw_keep
        blocks.draw_keep = lambda shape, rate, generator, device: torch.ones(shape, dtype=torch.bool, device=device)
        return self

    def __exit__(self, *exc):
        from tchvp_tpu_torch.ops import blocks

        blocks.draw_keep = self.real


def _dp_flows(inp):
    """data=n: the loaders' slices, the segmentation and denoising steps on
    this rank's block, and the flows' placement of a global batch."""
    from tchvp_tpu_torch.config import AugmentConfig
    from tchvp_tpu_torch.models.autoencoder import AutoEncoder
    from tchvp_tpu_torch.models.fct import FCT
    from tchvp_tpu_torch.parallel.input import GlobalBatchLoader, sharded_clippack_loader

    mesh = parallel.ambient_mesh()
    got = {"slices": [b.copy() for b in GlobalBatchLoader(inp["batches"], mesh)],
           "clippack": [np.asarray(b).copy() for b in sharded_clippack_loader(
               inp["clippack"], inp["clippack_batch"], mesh, shuffle=True, seed=3, prefer_native=False)],
           "host_slice": parallel.host_local_batch_slice(8),
           "replicated": parallel.replicate({"w": torch.full((3,), float(torch.distributed.get_rank()))})["w"],
           "slices_mb2": [b.copy() for b in GlobalBatchLoader(inp["batches"], mesh, microbatches=2)],
           "clippack_mb2": [np.asarray(b).copy() for b in sharded_clippack_loader(
               inp["clippack"], inp["clippack_batch"], mesh, shuffle=True, seed=3, prefer_native=False,
               microbatches=2)]}
    hybrid = parallel.make_hybrid_mesh(("data",), (1,), dcn_size=2)
    got["hybrid"] = (hybrid.mesh_dim_names, tuple(hybrid.shape), hybrid.get_local_rank("replica"))
    for key, dcn in (("hybrid_default", None), ("hybrid_error", 3)):
        try:
            parallel.make_hybrid_mesh(("data",), (1,), dcn_size=dcn)
        except ValueError as e:
            got[key] = str(e)
    seg = FCT(inp["fct_config"], device="cpu")
    seg.load_state_dict(inp["fct_state"])
    state = tstate.create_train_state(seg, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    images, masks = (parallel.shard_batch(torch.from_numpy(a), mesh) for a in inp["seg_batch"])
    with keep_everything():  # Wide-Focus's fixed dropout: every weight kept
        state, m = tsteps.make_segmentation_train_step(inp["fct_size"])(state, (images, masks))
    got["segment"] = {"metrics": {k: float(v) for k, v in m.items()},
                      "state": {k: v.clone() for k, v in seg.state_dict().items()}}
    ae = AutoEncoder(inp["ae_config"], device="cpu")
    ae.load_state_dict(inp["ae_state"])
    state = tstate.create_train_state(ae, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    aug = AugmentConfig(hflip_prob=0.0, noise_prob=0.0, max_blackout_patches=0)
    step = tsteps.make_denoising_train_step(inp["ae_size"], aug, "mse")
    state, m = step(state, parallel.shard_batch(torch.from_numpy(inp["ae_batch"]), mesh))
    got["denoise"] = {"metrics": {k: float(v) for k, v in m.items()},
                      "state": {k: v.clone() for k, v in ae.state_dict().items()}}
    return got


def _dp_stream(inp):
    """data=n: ``make_streamer(mesh=)`` on the whole clip batch, fp32 and
    int8 (the engine calibrated on the global batch's tiles, as ``stream
    --int8`` does): this rank's blocks, the engine's scales, and the
    refusals of a batch the axis does not divide and of a mesh without a
    data axis."""
    from tchvp_tpu_torch.infer.quant import Int8Engine
    from tchvp_tpu_torch.models import streaming
    from tchvp_tpu_torch.ops import tiling

    mesh = parallel.ambient_mesh()
    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    cfg = streaming.StreamingConfig(**inp["stream"])
    clip = torch.from_numpy(inp["clip"])
    with dispatch_trace.capture() as seen:
        block = streaming.make_streamer(model, cfg, mesh=mesh)(clip)
    tiles, _ = tiling.tile_frames(tiling.pad_frames(clip, cfg.tile)[0], cfg.tile)
    engine = Int8Engine(model).calibrate([tiles[:4, :2]])
    got = {"block": block, "seen": seen, "scales": engine.scales,
           "int8": streaming.make_streamer(model, cfg, mesh=mesh, int8_engine=engine)(clip),
           "tiles": streaming.shard_tiles(tiles, mesh), "spec": streaming.stream_sharding(mesh)}
    for what, call in (("odd", lambda: streaming.make_streamer(model, cfg, mesh=mesh)(clip[:3])),
                       ("no_axis", lambda: streaming.make_streamer(model, cfg, mesh=parallel.make_mesh(("seq",))))):
        try:
            call()
        except ValueError as e:
            got[what] = str(e)
    return got


def run_data(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One rank of ``tests/test_torch_data_parallel.py``: with 2 ranks the
    data mesh (the flagship's step, the loaders, segment, denoise, the
    streamer); with 4
    the meshes of two axes, data x seq and data x expert."""
    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    try:
        results = {}
        if world == 2:
            with parallel.activate_mesh(parallel.make_mesh(("data",), (2,))):
                results["video"] = _dp_video(inputs["video"])
                results["options"] = _dp_options(inputs["video"])
                results["flows"] = _dp_flows(inputs["flows"])
                results["stream"] = _dp_stream(inputs["stream"])
        else:
            with parallel.activate_mesh(parallel.make_mesh(("data", "seq"), (2, 2))):
                results["data_seq"] = _dp_video(inputs["data_seq"])
            with parallel.activate_mesh(parallel.make_mesh(("data", "expert"), (2, 2))):
                results["data_expert"] = _dp_video(inputs["data_expert"], moe=True)
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, Path(out_dir) / f"data_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def without_noise(steps_module):
    """``steps_module.make_video_train_step`` (and its pipelined form) with
    no input noise by default: a data rank draws its noise from a generator
    of its own, so only without noise does a data-parallel step equal one
    process's."""
    import functools

    steps_module.make_video_train_step = functools.partial(steps_module.make_video_train_step, noise_std=0.0)
    steps_module.make_pipelined_video_train_step = functools.partial(
        steps_module.make_pipelined_video_train_step, noise_std=0.0)


def run_cli_quiet(rank: int, world: int, rendezvous: str, out_dir: str, argv: list) -> None:
    """:func:`run_cli` with no input noise either (:func:`without_noise`)."""
    without_noise(tsteps)
    run_cli(rank, world, rendezvous, out_dir, argv)


# ------------------------------------------------- FSDP and sharded checkpoints


def _local_leaves(state) -> dict:
    """Every tensor of a state as this rank holds it (slices where sharded),
    by the shard-wise checkpoint's keys, with each one's placement (dim, n,
    i) or None, and the optimizer's counts."""
    from tchvp_tpu_torch.parallel import fsdp

    out = {}
    for key, (t, where) in fsdp.state_leaves(state).items():
        out[key] = (t.detach().cpu().clone(), None if where is None else (where.dim,) + where.shards)
    out["count"] = (torch.tensor(state.tx.count), None)
    out["train_step"] = (torch.tensor(state.step), None)
    return out


def _same(a: dict, b: dict) -> list:
    """The keys whose tensors differ in bits (or exist on one side)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not torch.equal(a[k][0], b[k][0]))


class _GatherSpy:
    """Counts calls of ``collectives.all_gather_along`` (FSDP's gather of
    whole parameters) and of ``fsdp.gather_params`` within the scope."""

    def __enter__(self):
        from tchvp_tpu_torch.parallel import fsdp

        self.calls = 0
        self.real = (collectives.all_gather_along, fsdp.all_gather_along, fsdp.gather_params)

        def spy(fn):
            def wrapped(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return wrapped

        collectives.all_gather_along, fsdp.all_gather_along, fsdp.gather_params = (spy(f) for f in self.real)
        return self

    def __exit__(self, *exc):
        from tchvp_tpu_torch.parallel import fsdp

        collectives.all_gather_along, fsdp.all_gather_along, fsdp.gather_params = self.real


def _fsdp_state(inp, weights: str, opt, mesh=None):
    """A fresh train state of ``inp``'s flagship with ``weights``, sharded
    over ``data`` of ``mesh`` when given."""
    from tchvp_tpu_torch.parallel import fsdp

    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp[weights], strict=True)
    state = tstate.create_train_state(model, opt, rng=3)
    if mesh is not None:
        fsdp.shard_train_state(state, mesh, "data")
    return state


def _fsdp_video(inp, mesh, fsdp_on: bool, clip=None) -> dict:
    """One step (SGD lr 1, MSE, no noise) on this rank's block of the global
    batch, FSDP-sharded over ``data`` or replicated: the metrics, the
    markers, the state bytes before, the whole state after (the slices
    gathered), whether every rank holds it bit for bit, and which
    parameters stayed slices."""
    from tchvp_tpu_torch.parallel import fsdp

    state = _fsdp_state(inp, "state", tstate.make_optimizer(1.0, optimizer="sgd", grad_clip_norm=clip),
                        mesh if fsdp_on else None)
    model = state.model
    nbytes = (fsdp.sharded_size_bytes(state), fsdp.global_size_bytes(state))
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0,
                                        fsdp_axis="data" if fsdp_on else None, fsdp_mesh=mesh if fsdp_on else None)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, parallel.shard_batch(torch.from_numpy(inp["batch"]), mesh))
    sliced = sorted(k for k, p in model.named_parameters() if getattr(p, "fsdp_group", None) is not None
                    and tuple(p.shape) != tuple(inp["state"][k].shape))
    with fsdp.gathered(model):
        whole = {k: v.clone() for k, v in model.state_dict().items()}
    equal = all(collectives.equal_across(list(whole.values()), torch.distributed.group.WORLD))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen, "bytes": nbytes,
            "state": whole, "equal": equal, "sliced": sliced}


def _one_process(inp, clip=None) -> dict:
    """The port's one-process step on the whole global batch, in this rank."""
    state = _fsdp_state(inp, "state", tstate.make_optimizer(1.0, optimizer="sgd", grad_clip_norm=clip))
    state, metrics = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0)(
        state, torch.from_numpy(inp["batch"]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def _fsdp_dormant(inp) -> dict:
    """``fsdp_axis`` with no mesh in scope: no marker, the plain step's bits."""
    got = {}
    for axis in (None, "data"):
        state = _fsdp_state(inp, "state", tstate.make_optimizer(1.0, optimizer="sgd"))
        with dispatch_trace.capture() as seen:
            state, m = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, fsdp_axis=axis)(
                state, torch.from_numpy(inp["batch"]))
        got[axis] = {"seen": seen, "loss": float(m["loss"]),
                     "state": {k: v.clone() for k, v in state.model.state_dict().items()}}
    return got


def _rich_opt():
    """The optimizer of JAX's sharded-checkpoint tests: clipping, skipping
    non-finite updates, and an EMA."""
    return tstate.make_optimizer(1e-3, grad_clip_norm=1.0, skip_nonfinite_updates=2, ema_decay=0.99)


def _stepped(inp, mesh) -> object:
    state = _fsdp_state(inp, "state", _rich_opt(), mesh)
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0)
    with parallel.activate_mesh(mesh):
        state, _ = step(state, parallel.shard_batch(torch.from_numpy(inp["batch"]), mesh))
    return state


def _ckpt_roundtrip(inp, mesh, out: Path) -> dict:
    """A stepped FSDP state saved shard-wise (sync and async) and restored
    into a fresh FSDP state of other weights: the keys that differ, the
    gathers made, the step and extra read back, and this rank's files."""
    from tchvp_tpu_torch.train import checkpoint as ckpt

    src = _stepped(inp, mesh)
    got = {"sharded_state": ckpt.is_sharded_state(src)}
    for mode in ("sync", "async"):
        d = out / f"roundtrip_{mode}"
        with _GatherSpy() as spy:
            path = ckpt.save_state(str(d), 3, src, extra={"loss_history": [2.0, 1.0]}, async_write=mode == "async")
            dst = _fsdp_state(inp, "state2", _rich_opt(), mesh)
            before = _same(_local_leaves(dst), _local_leaves(src))
            dst, raw = ckpt.restore_state_into(dst, path)
        got[mode] = {"differ_before": before, "differ": _same(_local_leaves(dst), _local_leaves(src)),
                     "gathers": spy.calls, "step": raw["step"], "extra": raw.get("extra"),
                     "files": sorted(os.listdir(path)), "sharded": ckpt.is_sharded_checkpoint(path)}
    got["local"] = _local_leaves(src)
    return got


def _twin_roundtrip(inp, mesh, out: Path) -> dict:
    """A shard-wise save and restore whose DTensors live on a twin of the
    mesh with no process groups of its own: the path of a mesh of CUDA
    devices (NCCL), on which the checkpoint's host copies cannot live. The
    twin's coordinates, and the keys that differ after the round trip."""
    import types

    from tchvp_tpu_torch.train import checkpoint as ckpt

    real = ckpt._cpu_mesh

    def twin(m):
        return real(types.SimpleNamespace(device_type="cuda", mesh=m.mesh, mesh_dim_names=m.mesh_dim_names))

    src = _stepped(inp, mesh)
    ckpt._cpu_mesh = twin
    try:
        made = twin(mesh)
        path = ckpt.save_state(str(out / "twin"), 1, src)
        dst = _fsdp_state(inp, "state2", _rich_opt(), mesh)
        dst, _ = ckpt.restore_state_into(dst, path)
    finally:
        ckpt._cpu_mesh = real
    return {"twin_is_new": made is not mesh, "coordinate": (made.get_coordinate(), mesh.get_coordinate()),
            "differ": _same(_local_leaves(dst), _local_leaves(src))}


def _whole_into_sharded(inp, mesh) -> dict:
    """A whole checkpoint (written by the parent) restored into an FSDP
    state: this rank's slices, and the keys that differ from the whole
    payload's blocks."""
    from tchvp_tpu_torch.train import checkpoint as ckpt

    dst = _fsdp_state(inp, "state2", _rich_opt(), mesh)
    dst, raw = ckpt.restore_state_into(dst, inp["whole_path"])
    return {"local": _local_leaves(dst), "step": raw["step"], "sharded": ckpt.is_sharded_state(dst)}


def _fsdp_flow(inp, mesh, out: Path, moe: bool = False) -> dict:
    """VideoFlow(fsdp_axis="data") (with ``moe`` on a data x expert mesh,
    its experts sharded too): the placement at init, 2 epochs with async
    shard-wise saves, a resume into a fresh flow of other weights, and one
    more epoch."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import VideoFlow

    d = out / ("flow_moe" if moe else "flow")
    tc = TrainConfig(model_name="video", loss="mse", lr=1e-4, checkpoint_dir=str(d / "ckpt"),
                     log_dir=str(d / "runs"), sample_dir=str(d / "samples"), async_checkpoint=True,
                     moe_aux_weight=0.01 if moe else 0.0)
    key = "moe" if moe else "video"
    batch = inp[key]["batch"]

    def flow_of(weights):
        model = VideoHybridNet(inp[key]["config"], device="cpu")
        model.load_state_dict(inp[key][weights], strict=True)
        return VideoFlow(model, cfg=tc, image_size=inp[key]["size"], mesh=mesh, fsdp_axis="data",
                         ep_axis="expert" if moe else None)

    flow = flow_of("state")
    out_ = io.StringIO()
    with contextlib.redirect_stdout(out_):
        state = flow.init_state(clip_len=batch.shape[1])
    sliced = {k: getattr(p, "fsdp_group", None) is not None for k, p in state.model.named_parameters()}
    flow.train([batch], epochs=2, clip_len=batch.shape[1], save_every=1)
    trained = _local_leaves(flow.state)
    flow2 = flow_of("state2")
    with contextlib.redirect_stdout(io.StringIO()):
        start = flow2.resume(clip_len=batch.shape[1])
    resumed = _local_leaves(flow2.state)
    flow2.train([batch], epochs=3, start_epoch=start, clip_len=batch.shape[1], save_every=100)
    return {"printed": out_.getvalue(), "sliced": sliced, "start": start, "differ": _same(resumed, trained),
            "steps_after": flow2.state.step, "local": trained,
            "shapes": {k: tuple(v.shape) for k, v in inp[key]["state"].items()}}


def _elastic_save(inp, mesh4, out: Path) -> dict:
    """A stepped FSDP state over data=4 saved shard-wise, for the restore
    onto data=2."""
    from tchvp_tpu_torch.train import checkpoint as ckpt

    src = _stepped(inp, mesh4)
    ckpt.save_state(str(out / "elastic"), 1, src)
    return {"local": _local_leaves(src)}


def _elastic_restore(inp, mesh, out: Path) -> dict:
    from tchvp_tpu_torch.train import checkpoint as ckpt

    dst = _fsdp_state(inp, "state2", _rich_opt(), mesh)
    with _GatherSpy() as spy:
        dst, raw = ckpt.restore_state_into(dst, str(out / "elastic" / "step_1"))
    return {"local": _local_leaves(dst), "gathers": spy.calls, "step": raw["step"]}


def live_view(state, specs: dict) -> dict:
    """What this rank holds of a stepped state, for the planner's tests: the
    run-time's specs by ``state_dict`` name, each tensor's shape and dtype
    by its ``fsdp.state_leaves`` key, and ``fsdp.sharded_size_bytes``."""
    from tchvp_tpu_torch.parallel import fsdp

    leaves = {k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, (t, _) in fsdp.state_leaves(state).items()}
    return {"specs": specs, "leaves": leaves, "bytes": fsdp.sharded_size_bytes(state)}


def run_fsdp(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 4 ranks of ``tests/test_torch_fsdp.py``: FSDP over ``data`` of
    a ("data", "rep") mesh of (2, 2) (two data ranks; "rep" replicates),
    what a rank holds of a stepped state (for the planner), the elastic
    save over data=4, the data x expert flow, then ``video --mesh
    data=2,expert=2 --fsdp`` through the CLI (which leaves the process
    group)."""
    from tchvp_tpu_torch import cli
    from tchvp_tpu_torch.parallel import fsdp

    torch.set_num_threads(1)
    out = Path(out_dir)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    results = {}
    try:
        inp = inputs["video"]
        mesh4 = parallel.make_mesh(("data",), (4,))
        results["elastic_src"] = _elastic_save(inp, mesh4, out)
        mesh = parallel.make_mesh(("data", "rep"), (2, 2))
        with parallel.activate_mesh(mesh):
            results["fsdp"] = _fsdp_video(inp, mesh, True)
            results["dp"] = _fsdp_video(inp, mesh, False)
            results["clip"] = _fsdp_video(inp, mesh, True, clip=inputs["clip"])
        results["clip_one"] = _one_process(inp, clip=inputs["clip"])
        results["dormant"] = _fsdp_dormant(inp)
        results["roundtrip"] = _ckpt_roundtrip(inp, mesh, out)
        results["whole_into_sharded"] = _whole_into_sharded(inp, mesh)
        results["twin"] = _twin_roundtrip(inp, mesh, out)
        results["elastic"] = _elastic_restore(inp, mesh, out)
        stepped = _stepped(inp, mesh)
        results["planned"] = live_view(stepped, fsdp.state_shardings(stepped, mesh, "data"))
        results["flow"] = _fsdp_flow(inputs, mesh, out)
        results["flow_moe"] = _fsdp_flow(inputs, parallel.make_mesh(("data", "expert"), (2, 2)), out, moe=True)
        with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
            cli.main(list(inputs["cli"]) + ["--coordinator", f"file://{rendezvous}", "--num-processes",
                                            str(world), "--process-id", str(rank)])
        results["cli"] = {"seen": seen, "printed": printed.getvalue()}
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, out / f"fsdp_rank{rank}.pt")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# ------------------------------------------------------- tensor parallelism


def _tp_transformer(inp) -> dict:
    """TransformerEncoder(tp_axis="model") on the whole tokens, eval; and
    the gradients of sum(out**2) in train mode (no dropout) of the tokens
    and the parameters, summed over the axis as the step sums them."""
    from tchvp_tpu_torch.parallel import tp

    model = TransformerEncoder(TransformerConfig(**inp["config"], tp_axis="model"))
    model.load_state_dict(inp["state"])
    x = torch.from_numpy(inp["x"])
    with dispatch_trace.capture() as seen, torch.no_grad():
        out = model.eval()(x)
    model.train()
    xg = x.clone().requires_grad_()
    (model(xg) ** 2).sum().backward()
    tp.sum_gradients(model)
    return {"out": out, "seen": seen, "x_grad": xg.grad,
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}


def _tp_autoencoder(inp) -> dict:
    """Autoencoder32K(tp_axis="model") eval on the whole images: the latent
    and reconstruction, the encoder's output channels on this rank, and the
    markers; the divisibility gate on a 3- and a 4-channel input."""
    from tchvp_tpu_torch.config import ResNetAEConfig
    from tchvp_tpu_torch.models.resnet_ae import Autoencoder32K
    from tchvp_tpu_torch.parallel import tp

    model = Autoencoder32K(ResNetAEConfig(token_latent=False, tp_axis="model"), device="cpu")
    model.load_state_dict(inp["state"])
    x = torch.from_numpy(inp["x"])
    with dispatch_trace.capture() as seen, torch.no_grad():
        latent, recon = model.eval()(x)
        enc = model.encoder(x.permute(0, 3, 1, 2))
    with dispatch_trace.capture() as gate:
        three = torch.ones(2, 3, 8, 8)
        same = tp.conv_tp_constrain(three, "model") is three
    with dispatch_trace.capture() as four_seen:
        four = tp.conv_tp_constrain(torch.arange(4.0).reshape(1, 4, 1, 1), "model")
    with dispatch_trace.capture() as six_seen:
        six = tp.tp_constrain(torch.arange(6.0).reshape(1, 6), "model")
        odd = torch.ones(1, 3)
        odd_same = tp.tp_constrain(odd, "model", require_divisible=True) is odd
    return {"latent": latent, "recon": recon, "enc_channels": enc.shape[1], "seen": seen,
            "three_same": same, "three_seen": gate, "four": four, "four_seen": four_seen,
            "six": six, "six_seen": six_seen, "odd_same": odd_same}


def _tp_video(inp) -> dict:
    """One train step (SGD lr 1, MSE, no noise) of the flagship with
    ``tp_axis="model"`` on this rank's block of the data axis (the whole
    batch without one): metrics, markers, the state after, the gradients
    before the update, and the ranks' bit equality."""
    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, parallel.shard_batch(torch.from_numpy(inp["batch"]), parallel.ambient_mesh()))
    shared = list(model.parameters()) + [b for k, b in model.named_buffers() if "running" in k]
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "sliced": sorted(k for k, p in model.named_parameters() if getattr(p, "tp_group", None) is not None),
            "equal": all(collectives.equal_across(shared, torch.distributed.group.WORLD))}


def _tp_flow(inp, mesh, out: Path) -> dict:
    """VideoFlow on a data x model mesh: one step, its markers."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import VideoFlow

    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    tc = TrainConfig(model_name="video", loss="mse", lr=1e-4, checkpoint_dir=str(out / "tp_flow"),
                     log_dir=str(out / "tp_runs"), sample_dir=str(out / "tp_samples"))
    flow = VideoFlow(model, cfg=tc, image_size=inp["size"], mesh=mesh)
    with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
        flow.train([inp["batch"]], epochs=1, clip_len=inp["batch"].shape[1], save_every=100)
    return {"seen": seen, "printed": printed.getvalue(), "step": flow.state.step}


def run_tp(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 4 ranks of ``tests/test_torch_tensor_parallel.py``: model=2 on
    a ("rep", "model") mesh of (2, 2) ("rep" replicates), data=2 x model=2,
    then ``video --mesh data=2,model=2`` through the CLI (which leaves the
    process group)."""
    from tchvp_tpu_torch import cli

    torch.set_num_threads(1)
    out = Path(out_dir)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    results = {}
    try:
        with parallel.activate_mesh(parallel.make_mesh(("rep", "model"), (2, 2))):
            results["transformer"] = _tp_transformer(inputs["transformer"])
            results["autoencoder"] = _tp_autoencoder(inputs["autoencoder"])
            results["model2"] = _tp_video(inputs["model2"])
        mesh = parallel.make_mesh(("data", "model"), (2, 2))
        with parallel.activate_mesh(mesh):
            results["data_model"] = _tp_video(inputs["data_model"])
        results["flow"] = _tp_flow(inputs["data_model"], mesh, out)
        without_noise(tsteps)
        config_real = sys.modules["tchvp_tpu_torch.config"].flagship_video_config
        sys.modules["tchvp_tpu_torch.config"].flagship_video_config = flagship_without_dropout
        try:
            with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
                cli.main(list(inputs["cli"]) + ["--coordinator", f"file://{rendezvous}", "--num-processes",
                                                str(world), "--process-id", str(rank)])
        finally:
            sys.modules["tchvp_tpu_torch.config"].flagship_video_config = config_real
        results["cli"] = {"seen": seen, "printed": printed.getvalue()}
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, out / f"tp_rank{rank}.pt")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# ----------------------------------------------------- spatial partitioning


def _sp_autoencoder(inp) -> dict:
    """Autoencoder32K(sp_axis="spatial") eval on this rank's block of the
    data axis (the whole images without one): the latent and
    reconstruction, the markers, and the encoder's counts of halo
    exchanges, slices and row gathers."""
    from tchvp_tpu_torch.config import ResNetAEConfig
    from tchvp_tpu_torch.models.resnet_ae import Autoencoder32K
    from tchvp_tpu_torch.parallel import spatial

    model = Autoencoder32K(ResNetAEConfig(token_latent=False, sp_axis="spatial"), device="cpu").eval()
    model.load_state_dict(inp["state"])
    x = parallel.shard_batch(torch.from_numpy(inp["x"]), parallel.ambient_mesh())
    with dispatch_trace.capture() as seen, torch.no_grad():
        latent, recon = model(x)
        spatial.reset_counts()
        enc = model.encoder(x.permute(0, 3, 1, 2))
        counts = dict(spatial.COUNTS)
    from tchvp_tpu_torch.parallel import tp

    odd = torch.zeros(1, 2, 3, 4)
    rows = torch.arange(8.0).reshape(1, 1, 8, 1)
    got = {"latent": latent, "recon": recon, "seen": seen, "counts": counts, "enc_rows": enc.shape[2],
           "placed": parallel.shard_batch((rows, rows[0]), parallel.ambient_mesh(), sp_axis="spatial", sp_dim=2),
           "odd_whole": tp.conv_constrain(odd, sp_axis="spatial") is odd,
           "rows": tp.conv_constrain(torch.arange(4.0).reshape(1, 1, 4, 1), sp_axis="spatial").flatten().tolist()}
    # 36 rows: a rank's 18 do not halve at the encoder's two strides, so the
    # stack stays whole on every rank.
    spatial.reset_counts()
    with dispatch_trace.capture() as whole_seen, torch.no_grad():
        got["whole"] = model(x[:, :36])
    got["whole_seen"], got["whole_counts"] = whole_seen, dict(spatial.COUNTS)
    try:
        spatial.enter(torch.zeros(1, 1, 6, 4), "spatial", factor=4)
    except ValueError as e:
        got["gate_error"] = str(e)
    return got


def _sp_autoencoder_f64(inp) -> dict:
    """A train-mode forward and backward of Autoencoder32K(sp_axis) in
    float64 (dropout on, drawn from a generator seeded alike on every rank):
    the outputs, the gradients summed over the axis, the moved BatchNorm
    stats."""
    from tchvp_tpu_torch.config import ResNetAEConfig
    from tchvp_tpu_torch.models.resnet_ae import Autoencoder32K
    from tchvp_tpu_torch.parallel import spatial

    got = {}
    for key, rows in (("blocks", 64), ("whole", 36)):  # 36: the stack stays whole
        model = Autoencoder32K(ResNetAEConfig(token_latent=False, sp_axis="spatial"), device="cpu").double().train()
        model.load_state_dict(inp["state64"])
        x = torch.from_numpy(inp["x"][:, :rows]).double()
        latent, recon = model(x, generator=torch.Generator().manual_seed(7))
        (recon.square().mean() + latent.mean()).backward()
        spatial.sum_gradients(model)
        got[key] = {"latent": latent.detach(), "recon": recon.detach(),
                    "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                    "buffers": {k: b.clone() for k, b in model.named_buffers()}}
    return got


def _sp_fct(inp) -> dict:
    """FCT(sp_axis="spatial") eval, the attention gathered ("xla") and on
    the ring over the axis, on this rank's block of the data axis."""
    import dataclasses

    from tchvp_tpu_torch.models.fct import FCT
    from tchvp_tpu_torch.parallel import spatial

    mesh = parallel.ambient_mesh()
    x = parallel.shard_batch(torch.from_numpy(inp["x"]), mesh)
    got = {}
    for impl, seq in (("xla", None), ("ring", "spatial")):
        model = FCT(dataclasses.replace(inp["config"], attn_impl=impl, seq_axis=seq, sp_axis="spatial"),
                    device="cpu").eval()
        model.load_state_dict(inp["state"])
        with dispatch_trace.capture() as seen, torch.no_grad():
            got[impl] = {"out": model(x), "seen": seen}
        if "data" in mesh.mesh_dim_names:
            continue
        # 224 rows (FCT's published size): a rank's 112 do not halve 5
        # times, so the network stays whole on every rank; a train-mode
        # backward, the gradients summed over the axis.
        model.train()
        x224 = torch.from_numpy(inp["x224"]).requires_grad_()
        with dispatch_trace.capture() as seen:
            out = model(x224, generator=torch.Generator().manual_seed(3))
        out.square().mean().backward()
        spatial.sum_gradients(model)
        got[f"{impl}_224"] = {"out": out.detach(), "x_grad": x224.grad, "seen": seen,
                              "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    return got


def _tp_qat_convs(inp) -> dict:
    """A two-conv stack with tensor-parallel convs under QAT's fake quant:
    the output and the gradients summed over the model axis."""
    from tchvp_tpu_torch.ops.blocks import Conv2d, set_tp_axis
    from tchvp_tpu_torch.parallel import tp
    from tchvp_tpu_torch.train.qat import qat_fake_quant

    stack = torch.nn.Sequential(Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(), Conv2d(8, 8, 3, padding=1, bias=True))
    stack.load_state_dict(inp["state"])
    set_tp_axis(stack, "model")
    x = torch.from_numpy(inp["x"]).requires_grad_()
    with dispatch_trace.capture() as seen, qat_fake_quant():
        out = stack(x)
    tp.to_replicated(out, "model", 8).square().sum().backward()
    tp.sum_gradients(stack)
    return {"out": tp.to_replicated(out.detach(), "model", 8), "seen": seen, "x_grad": x.grad,
            "grads": {k: p.grad.clone() for k, p in stack.named_parameters()}}


def _qat_tp_flow(inp, out: Path) -> dict:
    """VideoFlow(qat=True) under the ambient model mesh: one step, its
    markers and loss line."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train.loops import VideoFlow

    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    tc = TrainConfig(model_name="video", loss="mse", lr=1e-4, checkpoint_dir=str(out / "qat_tp"),
                     log_dir=str(out / "qat_tp_runs"), sample_dir=str(out / "qat_tp_samples"))
    flow = VideoFlow(model, cfg=tc, image_size=inp["size"], mesh=parallel.ambient_mesh(), qat=True)
    with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
        flow.train([inp["batch"]], epochs=1, clip_len=inp["batch"].shape[1], save_every=100)
    return {"seen": seen, "printed": printed.getvalue()}


def run_spatial(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 4 ranks of ``tests/test_torch_spatial.py``: spatial=2 on a
    ("rep", "spatial") mesh of (2, 2), data=2 x spatial=2, tensor
    parallelism beside spatial=2 and beside seq=2, and under QAT."""
    torch.set_num_threads(1)
    out = Path(out_dir)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    results = {}
    try:
        with parallel.activate_mesh(parallel.make_mesh(("rep", "spatial"), (2, 2))):
            results["ae"] = _sp_autoencoder(inputs["ae"])
            results["ae64"] = _sp_autoencoder_f64(inputs["ae"])
            results["fct"] = _sp_fct(inputs["fct"])
            results["spatial2"] = _dp_video(inputs["spatial2"])
        with parallel.activate_mesh(parallel.make_mesh(("data", "spatial"), (2, 2))):
            results["data_ae"] = _sp_autoencoder(inputs["ae"])
            results["data_fct"] = _sp_fct(inputs["fct"])
            results["data_spatial"] = _dp_video(inputs["data_spatial"])
        with parallel.activate_mesh(parallel.make_mesh(("spatial", "model"), (2, 2))):
            results["spatial_model"] = _dp_video(inputs["spatial_model"])
        with parallel.activate_mesh(parallel.make_mesh(("seq", "model"), (2, 2))):
            results["seq_model"] = _dp_video(inputs["seq_model"])
        with parallel.activate_mesh(parallel.make_mesh(("rep", "model"), (2, 2))):
            results["qat_convs"] = _tp_qat_convs(inputs["qat_convs"])
            results["qat_flow"] = _qat_tp_flow(inputs["spatial_model"], out)
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, out / f"spatial_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ pipeline


def _pp_apply(inp) -> dict:
    """pipeline_apply of a tanh layer a stage (the whole stack given, each
    rank reading its row) and its gradients; the extras of a stage that
    reports [1, sum(x)]; the refusals."""
    from tchvp_tpu_torch.parallel import pipeline as ppl

    mesh = parallel.ambient_mesh()
    w = torch.from_numpy(inp["w"]).requires_grad_()
    x = parallel.shard_batch(torch.from_numpy(inp["x"]), mesh).clone().requires_grad_()
    batch_axis = "data" if "data" in mesh.mesh_dim_names else None
    fn = lambda p, h: torch.tanh(h @ p["w"])  # noqa: E731
    with dispatch_trace.capture() as seen:
        y = ppl.pipeline_apply(fn, {"w": w}, x, microbatches=inp["m"], batch_axis=batch_axis)
    (y ** 2).sum().backward()
    ext_fn = lambda p, h: (torch.tanh(h @ p["w"]), torch.stack([torch.ones(()), h.sum()]))  # noqa: E731
    y2, ext = ppl.pipeline_apply(ext_fn, {"w": w.detach()}, x.detach(), microbatches=inp["m"],
                                 batch_axis=batch_axis, extras=2)
    got = {"y": y.detach(), "x_grad": x.grad, "w_grad": w.grad, "ext": ext, "y2": y2, "seen": seen}
    for name, call in (("stages", lambda: ppl.pipeline_apply(fn, {"w": torch.cat([w, w]).detach()}, x)),
                       ("batch", lambda: ppl.pipeline_apply(fn, {"w": w.detach()}, x[:3], microbatches=2))):
        try:
            call()
        except ValueError as e:
            got[f"{name}_error"] = str(e)
    return got


def _pp_state(inp, fsdp_axis=None):
    from tchvp_tpu_torch.parallel import pipeline as ppl

    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    return ppl.create_pipelined_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3,
                                            fsdp_axis=fsdp_axis)


def _whole_state(state) -> dict:
    """The pipelined state's model as one ``VideoHybridNet`` state_dict:
    every stage's rows gathered over the pipe axis, FSDP's slices made
    whole."""
    from tchvp_tpu_torch.parallel import fsdp
    from tchvp_tpu_torch.parallel import pipeline as ppl

    mesh = parallel.ambient_mesh()
    group = parallel.axis_group(mesh, "pipe")
    with fsdp.gathered(state.model):
        local = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    whole = {k: (collectives.all_gather_cat(v, group, 0) if k.startswith("stages.") else v) for k, v in local.items()}
    return ppl.merge_pipelined_params(whole)


def _pp_video(inp, fsdp_axis=None, accum: int = 1, remat: bool = False) -> dict:
    """One pipelined train step (SGD lr 1, MSE, no noise) on this rank's
    block of the data axis: the metrics, the whole state afterwards, the
    markers, and whether the CNN's parameters and stats agree over the
    whole mesh."""
    mesh = parallel.ambient_mesh()
    batch_axis = "data" if "data" in mesh.mesh_dim_names else None
    state = _pp_state(inp, fsdp_axis)
    step = tsteps.make_pipelined_video_train_step(inp["size"], batch_axis=batch_axis, loss="mse", noise_std=0.0,
                                                  fsdp_axis=fsdp_axis, accum_steps=accum, remat=remat)
    data = local_rows(torch.from_numpy(inp["batch"]), mesh, microbatches=accum) if batch_axis \
        else torch.from_numpy(inp["batch"])
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, data)
    from tchvp_tpu_torch.parallel import fsdp

    with fsdp.gathered(state.model):
        shared = [p for k, p in state.model.named_parameters() if k.startswith("rest.")]
        shared += [b for k, b in state.model.named_buffers() if "running" in k]
        equal = all(collectives.equal_across(shared, torch.distributed.group.WORLD))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen, "state": _whole_state(state),
            "equal": equal, "stage_shape": tuple(state.model.stages.norm.weight.shape)}


def _pp_planned(inp) -> dict:
    """:func:`live_view` of a pipelined state, its rest ZeRO-sharded over
    ``data``, after one step on this rank's block."""
    from tchvp_tpu_torch.parallel import pipeline as ppl

    mesh = parallel.ambient_mesh()
    state = _pp_state(inp, "data")
    step = tsteps.make_pipelined_video_train_step(inp["size"], batch_axis="data", loss="mse", noise_std=0.0,
                                                  fsdp_axis="data")
    state, _ = step(state, local_rows(torch.from_numpy(inp["batch"]), mesh))
    return live_view(state, ppl.pipeline_state_shardings(state, mesh, "pipe", "data"))


def _pp_dropout(inp) -> dict:
    """The pipelined model's train-mode forward with the CNN's dropout on
    (and the temporal's off), against the monolithic model's on the same
    generator state; then with the temporal dropout on, the tokens of one
    and the same batch on each data rank, whose stage draws must differ
    across the data axis."""
    import dataclasses

    from tchvp_tpu_torch.parallel import pipeline as ppl

    cfg = inp["config"]
    with_cnn = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout_rate=0.3))
    clip = torch.from_numpy(inp["clip"])
    mono = VideoHybridNet(with_cnn, device="cpu").train()
    mono.load_state_dict(inp["state"])
    want = mono(clip, generator=torch.Generator().manual_seed(11))[1]
    pp = VideoHybridNet(with_cnn, device="cpu")
    pp.load_state_dict(inp["state"])
    net = ppl.PipelinedVideoNet(pp).train()
    got = net(clip, generator=torch.Generator().manual_seed(11))[1]
    with_tmp = dataclasses.replace(cfg, temporal=dataclasses.replace(cfg.temporal, dropout_rate=0.5))
    pp2 = VideoHybridNet(with_tmp, device="cpu")
    pp2.load_state_dict(inp["state"])
    net2 = ppl.PipelinedVideoNet(pp2).train()
    data_index = parallel.ambient_mesh().get_local_rank("data")
    gen = torch.Generator().manual_seed(100 + data_index)  # a data rank's fork, as the step makes it
    tokens = net2(clip, generator=gen, batch_axis="data")[0]
    return {"cnn": (got.detach(), want.detach()), "tokens": tokens.detach()}


def _pp_flow(inp, out: Path) -> dict:
    """VideoFlow(pipe_axis="pipe") on the ambient mesh: one epoch saved, a
    resume in the same layout (bit-equal to the saved state), and a resume
    of a monolithic checkpoint written by rank 0 alone."""
    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.train import checkpoint as tckpt
    from tchvp_tpu_torch.train.loops import VideoFlow

    def flow(name):
        model = VideoHybridNet(inp["config"], device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        tc = TrainConfig(model_name="video", loss="mse", lr=1e-3, checkpoint_dir=str(out / name),
                         log_dir=str(out / "pp_runs"), sample_dir=str(out / "pp_samples"))
        return VideoFlow(model, cfg=tc, image_size=inp["size"], mesh=parallel.ambient_mesh(), pipe_axis="pipe")

    got = {}
    first = flow("pp_flow")
    with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
        first.train([inp["batch"]], epochs=1, clip_len=inp["batch"].shape[1], save_every=1)
    saved = _local_leaves(first.state)
    again = flow("pp_flow")
    with contextlib.redirect_stdout(io.StringIO()):
        got["start"] = again.resume(inp["batch"].shape[1])
    got["same_layout"] = _same(saved, _local_leaves(again.state))
    got["seen"], got["printed"] = seen, printed.getvalue()
    got["sharded_ckpt"] = tckpt.is_sharded_checkpoint(str(out / "pp_flow" / "step_1"))
    # A monolithic checkpoint (one process's) into the pipelined layout.
    if torch.distributed.get_rank() == 0:
        model = VideoHybridNet(inp["config"], device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        state = tstate.create_train_state(model, tstate.make_optimizer(1e-3), rng=3)
        tsteps.make_video_train_step(inp["size"], loss="mse")(state, torch.from_numpy(inp["batch"]))
        tckpt.save_state(str(out / "mono"), 1, state, extra={"train_epoch": 1})
        got["mono_state"] = {k: v.clone() for k, v in model.state_dict().items()}
        got["mono_moments"] = {n: {k: v.clone() for k, v in st.items()} for n, st in
                               tckpt._opt_payload(state.tx)["moments"].items()}
    collectives.barrier(torch.distributed.group.WORLD)
    into = flow("mono")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        got["mono_start"] = into.resume(inp["batch"].shape[1])
    got["mono_printed"] = printed.getvalue()
    got["mono_into_pp"] = _whole_state(into.state)
    stage = into.state.model.stages
    got["mono_into_pp_moment"] = into.state.tx.core.state[stage.ffn1.weight]["exp_avg"].clone()
    return got


def _one_process_accum(inp, accum: int) -> dict:
    """The unpipelined step with ``accum`` microbatches, outside any mesh."""
    model = VideoHybridNet(inp["config"], device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, accum_steps=accum)(
        state, torch.from_numpy(inp["batch"]))
    return {"state": {k: v.clone() for k, v in model.state_dict().items()}}


def _pp_composed(inp) -> dict:
    """data x pipe, the rest ZeRO-sharded, accum_steps=2 and a routed MoE
    stack with the aux loss (JAX's full composition): two steps' metrics,
    the markers, the stages' and the largest rest parameter's placements."""
    from tchvp_tpu_torch.parallel import fsdp

    model = VideoHybridNet(inp["moe_config"], device="cpu")
    from tchvp_tpu_torch.parallel import pipeline as ppl

    state = ppl.create_pipelined_train_state(model, tstate.make_optimizer(1e-3, grad_clip_norm=1.0), rng=0,
                                             fsdp_axis="data")
    step = tsteps.make_pipelined_video_train_step(inp["size"], batch_axis="data", loss="mse", fsdp_axis="data",
                                                  accum_steps=2, moe_aux_weight=0.01)
    data = local_rows(torch.from_numpy(inp["moe_batch"]), parallel.ambient_mesh(), microbatches=2)
    with dispatch_trace.capture() as seen:
        state, m1 = step(state, data)
    state, m2 = step(state, data)
    rest = max((p for k, p in state.model.named_parameters() if k.startswith("rest.")), key=lambda p: p.numel())
    stage = state.model.stages.norm.weight
    return {"seen": seen, "metrics": [{k: float(v) for k, v in m.items()} for m in (m1, m2)],
            "rest_placed": fsdp.placement(rest) is not None and fsdp.placement(rest).axis == "data",
            "stage_placed": fsdp.placement(stage).axis == "pipe"}


def run_pipeline(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 4 ranks of ``tests/test_torch_pipeline.py``: pipe=2 on a
    ("rep", "pipe") mesh of (2, 2), then data=2 x pipe=2."""
    torch.set_num_threads(1)
    out = Path(out_dir)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    results = {}
    try:
        with parallel.activate_mesh(parallel.make_mesh(("rep", "pipe"), (2, 2))):
            results["apply"] = _pp_apply(inputs["apply"])
            results["mono"] = _one_process(inputs["video"])
            results["mono_accum2"] = _one_process_accum(inputs["video"], 2)
            results["pipe2"] = _pp_video(inputs["video"])
            results["accum2"] = _pp_video(inputs["accum"], accum=2)
            results["remat"] = _pp_video(inputs["video"], remat=True)
            results["flow"] = _pp_flow(inputs["video"], out)
        with parallel.activate_mesh(parallel.make_mesh(("data", "pipe"), (2, 2))):
            results["data_apply"] = _pp_apply(inputs["apply"])
            results["data_mono"] = _dp_video(inputs["video"])
            results["data_pipe"] = _pp_video(inputs["video"])
            results["data_pipe_fsdp"] = _pp_video(inputs["video"], fsdp_axis="data")
            from tchvp_tpu_torch.parallel import pipeline as ppl

            state = _pp_state(inputs["video"])
            results["specs"] = ppl.pipeline_state_shardings(state, parallel.ambient_mesh(), "pipe", "data")
            results["shapes"] = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
            results["planned"] = _pp_planned(inputs["video"])
            results["dropout"] = _pp_dropout(inputs["video"])
            results["composed"] = _pp_composed(inputs["composed"])
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, out / f"pipe_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_cli_sequence(rank: int, world: int, rendezvous: str, out_dir: str, argvs: list) -> None:
    """:func:`run_cli` of several commands in turn, each over a rendezvous
    of its own (the CLI leaves its process group at its end); saves each
    one's markers and printed lines to ``<out_dir>/cli_seq_rank<r>.pt``."""
    from tchvp_tpu_torch import cli, config

    torch.set_num_threads(1)
    config.flagship_video_config = flagship_without_dropout
    without_noise(tsteps)
    results = []
    for j, argv in enumerate(argvs):
        with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
            cli.main(list(argv) + ["--coordinator", f"file://{rendezvous}_{j}", "--num-processes", str(world),
                                   "--process-id", str(rank)])
        results.append({"seen": seen, "printed": printed.getvalue()})
    torch.save({"runs": results,
                "jax_loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))},
               Path(out_dir) / f"cli_seq_rank{rank}.pt")


def run_groups(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 8 ranks of a ("data", "spatial", "model") mesh of (2, 2, 2):
    the group over two of the three axes (a flattened submesh), and a
    train-mode BatchNorm on this rank's block of the batch, the rows and the
    channels."""
    from tchvp_tpu_torch.ops.blocks import BatchNorm

    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    try:
        mesh = parallel.make_mesh(("data", "spatial", "model"), (2, 2, 2))
        with parallel.activate_mesh(mesh):
            group = parallel.group_over(("data", "spatial"))
            members = collectives.all_gather_cat(torch.tensor([float(rank)]), group).tolist()
            bn = BatchNorm(4).train()
            bn.load_state_dict(inputs["bn"])
            bn.sp_axis, bn.tp_axis = "spatial", "model"
            d, s, m = (mesh.get_local_rank(a) for a in ("data", "spatial", "model"))
            x = torch.from_numpy(inputs["x"])[d * 2:(d + 1) * 2, m * 2:(m + 1) * 2, s * 4:(s + 1) * 4]
            out = bn(x)
        torch.save({"members": members, "out": out.detach(), "index": (d, s, m),
                    "stats": (bn.running_mean.clone(), bn.running_var.clone())},
                   Path(out_dir) / f"groups_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------- the launch over several hosts


# make_hybrid_mesh's cases of tests/test_torch_hosts.py: (ici_shape, dcn_size).
HYBRID_CASES = (((2,), None), ((2,), 2), ((4,), None), ((1,), 4))


def _hybrid_meshes() -> list:
    """Each of HYBRID_CASES as this rank builds it: the mesh's ranks, or
    the refusal's message."""
    got = []
    for ici, dcn in HYBRID_CASES:
        try:
            got.append(parallel.make_hybrid_mesh(("data",), ici, dcn_size=dcn).mesh.tolist())
        except ValueError as e:
            got.append(str(e))
    return got


def run_hosts(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 4 ranks of ``tests/test_torch_hosts.py``: launched as each of
    ``inputs["hosts"]`` (a host name a rank, given as ``host=``), its
    layout, the layout read back while the group lives and after it, and
    the hybrid meshes; then ``video`` through ``cli.main`` as each of
    ``inputs["cli"]`` (the host name a rank's ``socket.gethostname`` gives),
    from ``inputs["state"]``'s weights: what it printed, its markers, and the
    layout the CLI's launch made."""
    import socket

    from tchvp_tpu_torch import cli, config

    torch.set_num_threads(1)
    got = {}
    for case, hosts in inputs["hosts"].items():
        layout = parallel.init_distributed(f"file://{rendezvous}_{case}", world, rank, timeout_s=180,
                                           host=hosts[rank])
        try:
            got[case] = {"layout": layout, "read_back": parallel.launch_layout(), "meshes": _hybrid_meshes()}
        finally:
            torch.distributed.destroy_process_group()
        got[case]["after"] = parallel.launch_layout()
    config.flagship_video_config = flagship_without_dropout
    without_noise(tsteps)
    real_model, real_init, real_name = cli._video_model, parallel.init_distributed, socket.gethostname
    layouts = []

    def seeded(args, device):
        model = real_model(args, device)
        model.load_state_dict(inputs["state"], strict=True)
        return model

    def init(*a, **k):
        layouts.append(real_init(*a, **k))
        return layouts[-1]

    cli._video_model, parallel.init_distributed = seeded, init
    try:
        for name, hosts in inputs["cli"].items():
            socket.gethostname = lambda: hosts[rank]
            with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
                cli.main(inputs["argv"] + ["--checkpoint-dir", str(Path(out_dir) / name), "--coordinator",
                                           f"file://{rendezvous}_{name}", "--num-processes", str(world),
                                           "--process-id", str(rank)])
            got[name] = {"printed": printed.getvalue(), "seen": seen, "layout": layouts[-1]}
    finally:
        cli._video_model, parallel.init_distributed, socket.gethostname = real_model, real_init, real_name
    got["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
    torch.save(got, Path(out_dir) / f"hosts_rank{rank}.pt")


# ------------------------------------------------------------ composed meshes


# The markers each axis of a composed mesh records in a step.
AXIS_MARKERS = {"seq": {"seq_sharded_shard_map", "windowed_mha_halo"}, "model": {"tp_constrain", "tp_constrain_conv"},
                "expert": {"moe_ep_shard_map"}, "spatial": {"sp_constrain_conv", "sp_halo"}}


@contextlib.contextmanager
def float64_clips():
    """Within the scope the steps preprocess clips to float64, for a model
    cast with ``.to(torch.float64)``."""
    import functools

    from tchvp_tpu_torch.data import pipeline

    real = pipeline.preprocess_clip
    pipeline.preprocess_clip = functools.partial(real, dtype=torch.float64)
    try:
        yield
    finally:
        pipeline.preprocess_clip = real


def composed_step(inp, moe: bool = False, fsdp: bool = False, dtype=torch.float32) -> dict:
    """One train step (SGD lr 1, MSE, no noise) of the flagship under the
    ambient mesh, each rank given the global batch and placing it
    (``parallel.shard_batch``: its block of ``data``; the seq, model,
    expert and spatial ranks take the whole and the model slices it);
    ``moe``: the experts sharded over ``expert``, the aux loss on;
    ``fsdp``: the state ZeRO-sharded over ``data``. The metrics, markers,
    the whole state after (the slices gathered), this rank's expert index,
    and whether every rank holds the same replicated parameters and
    BatchNorm stats."""
    from tchvp_tpu_torch.ops import moe as tmoe
    from tchvp_tpu_torch.parallel import fsdp as tfsdp

    mesh = parallel.ambient_mesh()
    model = VideoHybridNet(inp["config"], device="cpu").to(dtype)
    model.load_state_dict(inp["state"], strict=True)
    names = tmoe.shard_experts(model, "expert") if moe else []
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"), rng=3)
    if fsdp:
        tfsdp.shard_train_state(state, mesh, "data")
    step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, moe_aux_weight=inp.get("aux", 0.0),
                                        fsdp_axis="data" if fsdp else None, fsdp_mesh=mesh if fsdp else None)
    with dispatch_trace.capture() as seen:
        state, metrics = step(state, parallel.shard_batch(torch.from_numpy(inp["batch"]), mesh))
    sliced = sorted(k for k, p in model.named_parameters() if getattr(p, "fsdp_group", None) is not None)
    with tfsdp.gathered(model):
        whole = {k: v.clone() for k, v in model.state_dict().items()}
    shared = [v for k, v in whole.items() if k not in names and "num_batches" not in k]
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "seen": seen, "expert_names": names,
            "expert_index": parallel.axis_shards("expert")[1] if moe else None, "state": whole, "sliced": sliced,
            "equal": all(collectives.equal_across(shared, torch.distributed.group.WORLD))}


def _composed_stepped(inp, mesh, moe: bool = False):
    """:func:`_stepped`'s state (AdamW with clipping and the EMA, FSDP over
    ``data``) under ``mesh``, with ``moe`` its experts sharded first."""
    from tchvp_tpu_torch.ops import moe as tmoe
    from tchvp_tpu_torch.parallel import fsdp as tfsdp

    with parallel.activate_mesh(mesh):
        model = VideoHybridNet(inp["config"], device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        if moe:
            tmoe.shard_experts(model, "expert")
        state = tfsdp.shard_train_state(tstate.create_train_state(model, _rich_opt(), rng=3), mesh, "data")
        step = tsteps.make_video_train_step(inp["size"], loss="mse", noise_std=0.0, moe_aux_weight=inp.get("aux", 0.0))
        state, _ = step(state, parallel.shard_batch(torch.from_numpy(inp["batch"]), mesh))
    return live_view(state, tfsdp.state_shardings(state, mesh, "data"))


def _composed_resume(inp, mesh, out: Path) -> dict:
    """VideoFlow(fsdp_axis="data") under ``mesh``: epoch 1 saved shard-wise
    (async), then epoch 2 in the same flow (the uninterrupted run); a fresh
    flow of other weights resumed from a copy of epoch 1's checkpoint runs
    epoch 2. What differs between the two runs' states (this rank's slices,
    moments and EMA included), the steps, and the uninterrupted run's whole
    parameters (for the one-process read of its last checkpoint)."""
    import dataclasses
    import shutil

    from tchvp_tpu_torch.config import TrainConfig
    from tchvp_tpu_torch.parallel import fsdp as tfsdp
    from tchvp_tpu_torch.train.loops import VideoFlow

    d = out / "resume"
    tc = TrainConfig(model_name="video", loss="mse", lr=1e-4, checkpoint_dir=str(d / "run"), log_dir=str(d / "runs"),
                     sample_dir=str(d / "samples"), async_checkpoint=True)
    batch = inp["batch"]

    def flow_of(weights, ckpt_dir):
        model = VideoHybridNet(inp["config"], device="cpu")
        model.load_state_dict(inp[weights], strict=True)
        return VideoFlow(model, cfg=dataclasses.replace(tc, checkpoint_dir=str(ckpt_dir)), image_size=inp["size"],
                         mesh=mesh, fsdp_axis="data")

    with contextlib.redirect_stdout(io.StringIO()):
        flow = flow_of("state", d / "run")
        flow.train([batch], epochs=1, clip_len=batch.shape[1], save_every=1)
        if torch.distributed.get_rank() == 0:
            shutil.copytree(d / "run" / "step_1", d / "resumed" / "step_1")
        torch.distributed.barrier()
        flow.train([batch], epochs=2, start_epoch=1, clip_len=batch.shape[1], save_every=1)
        whole = _local_leaves(flow.state)
        flow2 = flow_of("state2", d / "resumed")
        start = flow2.resume(clip_len=batch.shape[1])
        flow2.train([batch], epochs=2, start_epoch=start, clip_len=batch.shape[1], save_every=1)
    with tfsdp.gathered(flow.state.model):
        params = {k: v.clone() for k, v in flow.state.model.state_dict().items()}
    return {"start": start, "differ": _same(_local_leaves(flow2.state), whole), "steps": (flow.state.step, flow2.state.step),
            "sliced": sum(getattr(p, "fsdp_group", None) is not None for p in flow.state.model.parameters()),
            "params": params, "path": str(d / "run" / "step_2")}


# (key, mesh axes, sizes, experts sharded, FSDP) of the 4-rank launch.
COMPOSED_CASES = (
    ("seq_expert", ("seq", "expert"), (2, 2), True, False),
    ("model_expert", ("model", "expert"), (2, 2), True, False),
    ("spatial_expert", ("spatial", "expert"), (2, 2), True, False),
    ("seq_spatial", ("seq", "spatial"), (2, 2), False, False),
    ("data_model_fsdp", ("data", "model"), (2, 2), False, True),
    ("data_seq_fsdp", ("data", "seq"), (2, 2), False, True),
    ("data_spatial_fsdp", ("data", "spatial"), (2, 2), False, True),
)


def run_composed(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One rank of ``tests/test_torch_composed.py``. With 4 ranks: one step
    under each of :data:`COMPOSED_CASES`, ``seq x expert`` again in
    float64, what a rank holds of a stepped FSDP state beside ``model`` and
    beside ``expert`` (for the planner), the resume under ``data x model
    --fsdp``, then ``inputs["cli"]`` through ``cli.main`` (which leaves the
    process group). With 8: one step under ``seq x model x expert``."""
    from tchvp_tpu_torch import cli

    torch.set_num_threads(1)
    out = Path(out_dir)
    parallel.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=180)
    results = {}
    try:
        if world == 8:
            with parallel.activate_mesh(parallel.make_mesh(("seq", "model", "expert"), (2, 2, 2))):
                results["seq_model_expert"] = composed_step(inputs["seq_model_expert"], moe=True)
        else:
            for key, names, sizes, moe, fsdp in COMPOSED_CASES:
                with parallel.activate_mesh(parallel.make_mesh(names, sizes)):
                    results[key] = composed_step(inputs[key], moe=moe, fsdp=fsdp)
            with parallel.activate_mesh(parallel.make_mesh(("seq", "expert"), (2, 2))), float64_clips():
                results["seq_expert_f64"] = composed_step(inputs["seq_expert_f64"], moe=True, dtype=torch.float64)
            results["planned_model"] = _composed_stepped(inputs["data_model_fsdp"],
                                                         parallel.make_mesh(("data", "model"), (2, 2)))
            results["planned_expert"] = _composed_stepped(inputs["data_expert"],
                                                          parallel.make_mesh(("data", "expert"), (2, 2)), moe=True)
            results["resume"] = _composed_resume(inputs["resume"], parallel.make_mesh(("data", "model"), (2, 2)), out)
            config_real = sys.modules["tchvp_tpu_torch.config"].flagship_video_config
            sys.modules["tchvp_tpu_torch.config"].flagship_video_config = flagship_without_dropout
            try:
                with dispatch_trace.capture() as seen, contextlib.redirect_stdout(io.StringIO()) as printed:
                    cli.main(list(inputs["cli"]) + ["--checkpoint-dir", str(out / "cli"), "--coordinator",
                                                    f"file://{rendezvous}", "--num-processes", str(world),
                                                    "--process-id", str(rank)])
            finally:
                sys.modules["tchvp_tpu_torch.config"].flagship_video_config = config_real
            results["cli"] = {"seen": seen, "printed": printed.getvalue(), "path": str(out / "cli" / "step_1")}
        results["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tchvp_tpu"))
        torch.save(results, out / f"composed{world}_rank{rank}.pt")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
