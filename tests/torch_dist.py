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
    hybrid = parallel.make_hybrid_mesh(("data",), (1,))
    got["hybrid"] = (hybrid.mesh_dim_names, tuple(hybrid.shape), hybrid.get_local_rank("replica"))
    try:
        parallel.make_hybrid_mesh(("data",), (1,), dcn_size=3)
    except ValueError as e:
        got["hybrid_error"] = str(e)
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


def run_data(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One rank of ``tests/test_torch_data_parallel.py``: with 2 ranks the
    data mesh (the flagship's step, the loaders, segment, denoise); with 4
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
    """``steps_module.make_video_train_step`` with no input noise by default:
    a data rank draws its noise from a generator of its own, so only without
    noise does a data-parallel step equal one process's."""
    import functools

    steps_module.make_video_train_step = functools.partial(steps_module.make_video_train_step, noise_std=0.0)


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


def run_fsdp(rank: int, world: int, rendezvous: str, out_dir: str, inputs: dict) -> None:
    """One of 4 ranks of ``tests/test_torch_fsdp.py``: FSDP over ``data`` of
    a ("data", "rep") mesh of (2, 2) (two data ranks; "rep" replicates),
    the elastic save over data=4, the data x expert flow, then ``video
    --mesh data=2,expert=2 --fsdp`` through the CLI (which leaves the
    process group)."""
    from tchvp_tpu_torch import cli

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
