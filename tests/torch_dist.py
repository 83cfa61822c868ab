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
    try:
        with parallel.activate_mesh(parallel.make_mesh(("seq",), (world,))):
            tatt.multi_head_attention(x, x, x, inp["heads"], impl="ring", seq_axis="seq")
    except NotImplementedError as e:
        rows["ring"] = str(e)
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
    for policy, accum in (("stages", 1), ("none", 2)):
        try:
            tsteps.make_video_train_step(inp["size"], loss="mse", remat_policy=policy,
                                         accum_steps=accum)(state, torch.from_numpy(inp["batch"]))
        except NotImplementedError as e:
            got.setdefault("unported", []).append(str(e))
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
