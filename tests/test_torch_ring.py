"""The port's ring attention, full attention over seq-sharded tokens and
expert parallelism on 2 and 4 gloo ranks, against the JAX package's.

One ``torch.multiprocessing.spawn`` per world size runs every rank through
``tests/torch_dist.py::run_ring`` (as ``tests/test_torch_seq_parallel.py``
does); the ranks import the port only. What they computed is held here:

* (a) ``sdpa_ring_seq_sharded`` on each rank's block, forward and the
  gradients of sum(out**2), with each ``loop`` and without per-hop remat,
  against the port's unsharded ``sdpa_xla`` and JAX's
  ``sdpa_ring_seq_sharded`` on a CPU mesh of the same size, atol 1e-5
  (the streaming softmax's rounding); the markers of each loop form.
* (b) dropout: ``scan`` equal to ``unroll`` (bit for bit), and the output
  equal to ``sdpa_xla`` with the keep mask assembled from the blocks'
  seeds (atol 1e-5); JAX's errors for a bad ``loop`` and, where the
  whole sequence is cut (``shard_frames``), for S % n.
* (c) ``multi_head_attention(impl="ring")`` against JAX's unsharded
  ``multi_head_attention``; the gathered full attention (module 8): the
  kernel's plain version, forward and gradients against JAX's unsharded
  flash call in interpret mode and the port's unsharded call (atol 1e-5),
  its dropout with the unsharded call's one seed; a mask over the gathered
  keys against JAX's masked call.
* (d) the seq-parallel step of a ring-attention flagship with remat
  ``stages`` and ``accum_steps=2`` against JAX's unsharded step with
  ``accum_steps=2`` (remat never changes the math): loss and PSNR rtol
  1e-5, gradients within 2e-2 x the largest, as
  ``tests/test_torch_seq_parallel.py`` holds its step; parameters bit-equal
  across ranks.
* (e) expert parallelism: the MoE encoder's forward and the gradients of
  x, the router and every parameter (each rank slicing its experts from the
  full weights; their gradients summed over the ranks) against the dense single-process encoder and JAX's, atol 1e-5
  (x and the router get their gradient once, not n times); a train step
  through ``VideoFlow`` against the dense single-process step (loss,
  ``moe_aux``, ``moe_drop_frac`` rtol 1e-6; gradients within 2e-2 x the
  largest, the experts' 1e-5); each rank holds E/n experts, the checkpoint
  holds all E, a resume gives each rank its slice back; JAX's error for
  E % n; a mesh without the axis runs ``moe_dense``; when one rank's
  expert gradient is not finite, every rank skips the update.
* (f) every tensor the ranks hand to ``torch.distributed`` (the ring's
  hops, the gathers, the checkpoint's gather of host copies) lies on the
  device its group's backend carries; an ``nccl`` group's is the card,
  so a host tensor is moved there; no module of the port but
  ``parallel/collectives.py`` calls torch.distributed's communication.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist
from tchvp_tpu import config as jcfg
from tchvp_tpu.models import TransformerEncoder as JTransformerEncoder
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.ops import attention as jatt
from tchvp_tpu.parallel import activate_mesh as jactivate_mesh
from tchvp_tpu.parallel import make_mesh as jmake_mesh
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.kernels import flash_attention as tfa
from tchvp_tpu_torch.models import transformer as ttr
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import moe as tmoe
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLDS = (2, 4)
B, H, S, DH = 2, 2, 32, 8
ENC = dict(input_dim=16, hidden_dim=24, num_layers=2, num_heads=4, dropout_rate=0.0, num_experts=4,
           expert_capacity_factor=0.5, router_top_k=2)
SIZE = 32


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _cat(parts, dim):
    return torch.cat(list(parts), dim=dim).numpy()


def _no_dropout(c, **temporal):
    return dataclasses.replace(c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
                               temporal=dataclasses.replace(c.temporal, dropout_rate=0.0, **temporal))


def _variables(model, frames):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, frames, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ("kernel", "router", "w1", "w2"):
            fan = np.prod(x.shape[:-1]) if name == "kernel" else x.shape[-2]
            return rng.standard_normal(x.shape) / np.sqrt(fan)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1 if name.startswith("b") else 0.2, x.shape)

    return {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
            for c in ("params", "batch_stats")}


# ------------------------------------------------------------ the references


@pytest.fixture(scope="module")
def ring_inputs():
    x = _arrays((B, S, 16), 1, seed=4)[0]
    mask = np.random.default_rng(2).random((B, 1, S, S)) > 0.3
    return {"qkv": _arrays((B, H, S, DH), 3, seed=0), "x": x, "heads": 2, "mask": mask}


@pytest.fixture(scope="module")
def step_reference():
    """JAX's unsharded accum_steps=2 step (SGD lr 1, MSE, no noise, dropout
    off) of a 4-frame flagship, and the ranks' ring-attention config."""
    kw = dict(image_size=SIZE, num_heads=8, hidden_dim=32, num_layers=1)
    jc = _no_dropout(jcfg.flagship_video_config(attn_impl="xla", **kw))
    tc = _no_dropout(tcfg.flagship_video_config(attn_impl="ring", seq_axis="seq", **kw))
    model = jvideo.VideoHybridNet(config=jc)
    variables = _variables(model, 4)
    batch = np.random.default_rng(6).integers(0, 256, (2, 4, 48, 48, 3), dtype=np.uint8)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    new, metrics = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, accum_steps=2)(
        st, jnp.asarray(batch))
    inputs = {"config": tc, "state": convert.from_flax(variables), "size": SIZE, "batch": batch}
    return inputs, variables, jax.tree.map(np.asarray, new.params), {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def expert_inputs():
    """The MoE encoder (JAX's init through from_flax) and its dense
    references, and a small MoE flagship with its dense single-process
    step."""
    x = _arrays((2, 16, 16), 1, seed=8)[0]
    jmodel = JTransformerEncoder(config=jcfg.TransformerConfig(**ENC))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def objective(v, xx):
        out, mut = jmodel.apply(v, xx, deterministic=True, mutable=["intermediates"])
        from tchvp_tpu.ops.moe import total_load_balance_loss

        return (out ** 2).sum() + total_load_balance_loss(mut), out

    (_, jax_out), (jax_gv, jax_gx) = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(
        variables, jnp.asarray(x))
    enc_state = {k[len("temporal."):]: v for k, v in
                 convert.from_flax({"params": {"temporal": variables["params"]}}).items()}
    jax_grads = {k[len("temporal."):]: v.numpy() for k, v in
                 convert.from_flax({"params": {"temporal": jax_gv["params"]}}).items()}
    config = _no_dropout(tcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32,
                                                    num_layers=1, num_experts=4, ep_axis="expert"))
    dense_config = dataclasses.replace(config, temporal=dataclasses.replace(config.temporal, ep_axis=None))
    jc = _no_dropout(jcfg.flagship_video_config(image_size=SIZE, num_heads=8, hidden_dim=32, num_layers=1,
                                                num_experts=4))
    state = convert.from_flax(_variables(jvideo.VideoHybridNet(config=jc), 2))
    batch = np.random.default_rng(3).integers(0, 256, (2, 2, 48, 48, 3), dtype=np.uint8)
    model = tvideo.VideoHybridNet(dense_config, device="cpu")
    model.load_state_dict(state, strict=True)
    # VideoFlow's optimizer: its global-norm clip sums the experts' squares
    # over the ranks.
    st = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd", grad_clip_norm=1.0))
    _, metrics = tsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0, moe_aux_weight=0.01)(
        st, torch.from_numpy(batch))
    dense_step = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                  "params": {k: p.detach().clone() for k, p in model.named_parameters()}}
    inputs = {"encoder": {k: v for k, v in ENC.items()}, "encoder_state": enc_state, "x_moe": x,
              "config": config, "state": state, "size": SIZE, "batch": batch}
    return inputs, (np.asarray(jax_out), np.asarray(jax_gx), jax_grads), dense_step


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request, tmp_path_factory, ring_inputs, step_reference, expert_inputs):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    inputs = {"ring": ring_inputs, "steps": step_reference[0],
              "experts": dict(expert_inputs[0], ckpt_dir=str(tmp / "ckpt"))}
    mp.spawn(torch_dist.run_ring, args=(world, str(tmp / "rendezvous"), str(tmp), inputs), nprocs=world,
             join=True)
    return [torch.load(tmp / f"ring_rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------ (a), (b) the ring


def _jax_ring(qkv, world, **kw):
    q, k, v = (jnp.asarray(t) for t in qkv)
    mesh = jmake_mesh(("seq",), (world,), devices=jax.devices()[:world])
    spec = NamedSharding(mesh, P(None, None, "seq", None))

    def loss(q, k, v):
        out = jatt.sdpa_ring_seq_sharded(q, k, v, seq_axis="seq", **kw)
        return (out ** 2).sum(), out

    with jactivate_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            *(jax.device_put(t, spec) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("loop,remat,marker", [
    ("unroll", True, "ring_shard_map"), ("scan", True, "ring_shard_map_scan"),
    ("auto", True, "ring_shard_map"), ("unroll", False, "ring_shard_map"),
])
def test_ring_matches_sdpa_xla_and_jax(ranks, ring_inputs, loop, remat, marker):
    world = len(ranks)
    got = [r["ring"][(loop, remat)] for r in ranks]
    assert all(g["seen"] == {marker} for g in got)
    out = _cat((g["out"] for g in got), 2)
    grads = [_cat((g["grads"][j] for g in got), 2) for j in range(3)]
    want, want_grads = torch_dist._grads_of(lambda q, k, v: tatt.sdpa_xla(q, k, v, scale=0.3),
                                            [torch.from_numpy(t) for t in ring_inputs["qkv"]])
    jax_out, jax_grads = _jax_ring(ring_inputs["qkv"], world, scale=0.3, loop=loop, remat=remat)
    for ref_out, ref_grads in ((want.numpy(), [g.numpy() for g in want_grads]), (jax_out, jax_grads)):
        np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=0)
        for name, g, r in zip("qkv", grads, ref_grads):
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=f"d{name}")


def test_ring_dropout_one_draw_per_pair(ranks, ring_inputs):
    """scan equals unroll with dropout, and the output equals sdpa_xla with
    the keep mask assembled from the (query shard, key block) seeds the
    ranks drew from the same generator."""
    world = len(ranks)
    for r in ranks:
        for j in range(2):
            a, b = r["ring"][("dropout", "unroll")], r["ring"][("dropout", "scan")]
            assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    seeds = tatt.draw_attention_dropout("ring", (B, H, S // world), 0.3, torch.Generator().manual_seed(5),
                                        torch.device("cpu"), shards=(world, 0))
    s = S // world
    bh = torch.arange(B * H).reshape(B, H)
    keep = torch.cat([torch.cat([tfa._keep_mask(seeds[i, j:j + 1], bh, s, s, 0.3) for j in range(world)], -1)
                      for i in range(world)], -2)
    assert 0.6 < keep.float().mean() < 0.8
    q, k, v = (torch.from_numpy(t) for t in ring_inputs["qkv"])
    want = tatt.sdpa_xla(q, k, v, dropout_rate=0.3, deterministic=False, dropout_keep=keep)
    got = _cat((r["ring"][("dropout", "unroll")][0] for r in ranks), 2)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


def test_ring_errors_and_fallback(ranks, ring_inputs):
    world = len(ranks)
    for r in ranks:
        assert r["ring"]["bad_loop"] == "loop must be auto|unroll|scan, got 'x'"
        assert r["ring"]["uneven"] == f"seq len {S - 1} not divisible by seq={world}"
    q, k, v = (torch.from_numpy(t) for t in ring_inputs["qkv"])
    with tatt.dispatch_trace.capture() as seen:
        out = tatt.sdpa_ring_seq_sharded(q, k, v, seq_axis="seq")
    assert seen == {"ring_fallback", "sdpa_xla"}
    torch.testing.assert_close(out, tatt.sdpa_xla(q, k, v), rtol=0, atol=0)


# ------------------------------------------------------------ (c) the dispatch


def test_multi_head_ring_and_masked_gather_match_jax(ranks, ring_inputs):
    x, heads = ring_inputs["x"], ring_inputs["heads"]
    xj = jnp.asarray(x)
    want = np.asarray(jatt.multi_head_attention(xj, xj, xj, heads, impl="xla"))
    seen = [r["ring"]["mha_ring"][0] for r in ranks]
    assert all(s == {"ring_shard_map"} for s in seen)
    np.testing.assert_allclose(_cat((r["ring"]["mha_ring"][1] for r in ranks), 1), want, atol=1e-5, rtol=0)
    want = np.asarray(jatt.multi_head_attention(xj, xj, xj, heads, impl="xla",
                                                mask=jnp.asarray(ring_inputs["mask"])))
    assert all(r["ring"]["gathered_mask"][0] == {"seq_gathered", "sdpa_xla"} for r in ranks)
    np.testing.assert_allclose(_cat((r["ring"]["gathered_mask"][1] for r in ranks), 1), want, atol=1e-5,
                               rtol=0)


def test_gathered_flash_matches_the_unsharded_call(ranks, ring_inputs):
    x, heads = ring_inputs["x"], ring_inputs["heads"]
    got = [r["ring"]["gathered_flash"] for r in ranks]
    assert all({"seq_gathered", "flash_mha", "flash_mha_plain", "flash_mha_bwd_plain"} == g[0] for g in got)
    xt = torch.from_numpy(x)
    want, want_grads = torch_dist._grads_of(
        lambda a, b, c: tatt.multi_head_attention(a, b, c, heads, impl="flash"), [xt, xt * 0.5, xt * 2.0])
    jx = jnp.asarray(x)
    jax_out = np.asarray(jatt.multi_head_attention(jx, jx * 0.5, jx * 2.0, heads, impl="flash"))
    out = _cat((g[1] for g in got), 1)
    np.testing.assert_allclose(out, jax_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, want.numpy(), atol=1e-5, rtol=0)
    for j in range(3):
        # The gathers' adjoints sum every rank's cotangents, so each rank
        # holds the global loss's gradient of its own block.
        np.testing.assert_allclose(_cat((g[2][j] for g in got), 1), want_grads[j].numpy(), atol=1e-5, rtol=0)
    drop = tatt.multi_head_attention(xt, xt, xt, heads, impl="flash", dropout_rate=0.3,
                                     generator=torch.Generator().manual_seed(9), deterministic=False)
    np.testing.assert_allclose(_cat((r["ring"]["gathered_flash_dropout"] for r in ranks), 1), drop.numpy(),
                               atol=1e-6, rtol=0)


# ------------------------------------------------------------ (d) the step


def test_ring_seq_step_with_remat_and_accum_matches_unsharded_jax(ranks, step_reference):
    _, variables, want_params, want_metrics = step_reference
    before, want = convert.from_flax(variables), convert.from_flax({"params": want_params})
    g_jax = {k: (before[k].numpy() - want[k].numpy()) / 1.9 for k in want}
    grad_atol = 2e-2 * max(np.abs(g).max() for g in g_jax.values())
    for r in ranks:
        st = r["steps"]
        assert {"ring_shard_map", "sdpa_xla"} & st["seen"] == {"ring_shard_map"} and st["all_equal"]
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(st["metrics"][k], want_metrics[k], rtol=1e-5, err_msg=k)
        for key, g in st["grads"].items():
            np.testing.assert_allclose(g.numpy(), g_jax[key], atol=grad_atol, rtol=0, err_msg=key)


# ------------------------------------------------------------ (e) experts


def _gathered(parts, names):
    return {k: torch.cat([p[k] for p in parts], 0) if k in names else parts[0][k] for k in parts[0]}


def test_expert_parallel_encoder_matches_dense_and_jax(ranks, expert_inputs):
    inputs, (jax_out, jax_gx, jax_grads), _ = expert_inputs
    world = len(ranks)
    got = [r["experts"]["encoder"] for r in ranks]
    assert all(g["seen"] == {"moe_ep_shard_map", "sdpa_xla"} for g in got)
    enc = ttr.TransformerEncoder(tcfg.TransformerConfig(**ENC))
    enc.load_state_dict(inputs["encoder_state"])
    x = torch.from_numpy(inputs["x_moe"]).requires_grad_()
    sink = []
    out = enc.eval()(x, moe_sink=sink)
    ((out ** 2).sum() + tmoe.total_load_balance_loss(sink)).backward()
    experts = {f"layers.{i}.moe.{p}" for i in range(2) for p in tmoe.EXPERT_PARAMS}
    for g in got:
        np.testing.assert_allclose(g["out"].numpy(), out.detach().numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["out"].numpy(), jax_out, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["x_grad"].numpy(), x.grad.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["x_grad"].numpy(), jax_gx, atol=1e-5, rtol=0)
    # The ranks hold the full expert weights here and each slices its own:
    # its gradient is zero outside its E/n experts, their sum the whole.
    e = 4 // world
    for i, g in enumerate(got):
        w1 = g["grads"]["layers.0.moe.w1"]
        assert w1.shape[0] == 4 and float(w1.abs().sum()) - float(w1[i * e:(i + 1) * e].abs().sum()) == 0.0
    grads = {k: sum(g["grads"][k] for g in got) if k in experts else got[0]["grads"][k] for k in got[0]["grads"]}
    for name, p in enc.named_parameters():
        scale = max(1.0, float(p.grad.abs().max()))
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), atol=1e-5 * scale, rtol=0, err_msg=name)
        np.testing.assert_allclose(grads[name].numpy(), jax_grads[name], atol=1e-5 * scale, rtol=0,
                                   err_msg=name)


def test_moe_encoder_over_seq_sharded_tokens_matches_jax(ranks, expert_inputs):
    """Under a seq mesh each rank holds a block of the tokens; the MoE layers
    route the whole sequence (per batch row, as JAX's global arrays), so
    the ranks' rows equal JAX's unsharded encoder, every rank sees the
    global aux loss, and with each rank's objective its rows' sum(out**2)
    plus aux / n, the gradients of x (by rows) and the parameters' sum over
    the ranks are JAX's, atol 1e-5."""
    inputs, (jax_out, jax_gx, jax_grads), _ = expert_inputs
    world = len(ranks)
    got = [r["moe_seq"] for r in ranks]
    assert all({"moe_dense", "seq_gathered", "sdpa_xla"} == g["seen"] for g in got)
    np.testing.assert_allclose(_cat((g["out"] for g in got), 1), jax_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_cat((g["x_grad"] for g in got), 1), jax_gx, atol=1e-5, rtol=0)
    for name in got[0]["grads"]:
        total = sum(g["grads"][name] for g in got).numpy()
        scale = max(1.0, float(np.abs(jax_grads[name]).max()))
        np.testing.assert_allclose(total, jax_grads[name], atol=1e-5 * scale, rtol=0, err_msg=name)
    assert len({g["aux"] for g in got}) == 1


def test_expert_parallel_step_and_checkpoint(ranks, expert_inputs):
    _, _, dense = expert_inputs
    world = len(ranks)
    steps = [r["experts"]["step"] for r in ranks]
    names = set(steps[0]["expert_names"])
    assert names == {f"temporal.layers.0.moe.{p}" for p in tmoe.EXPERT_PARAMS}
    assert all(s["shapes"]["temporal.layers.0.moe.w1"][0] == 4 // world for s in steps)
    assert all("moe_ep_shard_map" in s["seen"] and "moe_dense" not in s["seen"] for s in steps)
    for k, v in dense["metrics"].items():
        for s in steps:
            np.testing.assert_allclose(s["metrics"][k], v, rtol=1e-6, err_msg=k)
    grads = _gathered([s["grads"] for s in steps], names)
    atol = 2e-2 * max(float(g.abs().max()) for g in dense["grads"].values())
    for name, g in dense["grads"].items():
        tol = 1e-5 * max(1.0, float(g.abs().max())) if name in names else atol
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=tol, rtol=0, err_msg=name)
    for s in steps[1:]:  # the replicated parameters stay bit-equal
        assert all(torch.equal(s["params"][k], steps[0]["params"][k]) for k in s["params"] if k not in names)
    r0 = ranks[0]["experts"]
    assert r0["whole"]["temporal.layers.0.moe.w1"][0] == 4
    assert all(r["experts"]["resumed_equal"] and r["experts"]["resumed_moments_equal"] for r in ranks)


def test_expert_errors_and_mesh_without_the_axis(ranks):
    world = len(ranks)
    for r in ranks:
        assert r["experts"]["indivisible"] == f"3 experts not divisible by ep axis 'expert' of size {world}"
        assert r["experts"]["no_axis"] == {"moe_dense"}


def test_expert_ranks_skip_a_nonfinite_update_together(ranks):
    assert all(r["experts"]["skipped"] for r in ranks)


def test_ring_ranks_loaded_no_jax(ranks):
    assert all(r["jax_loaded"] == [] for r in ranks)


# ------------------------------------------------------------ the wire


def test_ranks_hand_the_backend_tensors_on_its_device(ranks):
    for r in ranks:
        assert {name for name, _, _ in r["wire"]} == set(torch_dist.WireSpy.CALLS)
        off = [(name, dev, want) for name, dev, want in r["wire"] if dev != want]
        assert not off, off[:5]


def test_gathers_and_reduce_scatter_over_the_ranks(ranks):
    """``all_gather_dim`` (its backward a reduce-scatter of the sum),
    ``all_gather_along``, ``reduce_scatter_mean``, ``reduce_scatter_dim``
    (its backward an all-gather) and ``all_gather_cat``: rank i holds i + 1
    in its block."""
    n = len(ranks)
    for i, r in enumerate(ranks):
        got = r["gathers"]
        want = torch.cat([torch.full((2, 3), float(j + 1)) for j in range(n)], dim=1)
        assert torch.equal(got["gathered"], want)
        # d/dx of sum(gathered * column) summed over the n ranks: n x the column index.
        assert torch.equal(got["grad"], n * torch.arange(3 * i, 3 * i + 3, dtype=torch.float32).expand(2, 3))
        assert torch.equal(got["along"], torch.cat([torch.full((2, 1), float(j + 1)) for j in range(n)], dim=1))
        total = sum(j + 1 for j in range(n)) / n
        assert torch.equal(got["mean"], torch.tensor([[float(i)], [float(n + i)]]) * total)
        assert torch.equal(got["cat"], torch.arange(float(n)))
        # reduce_scatter_dim: column i of the sum; its backward gathers the
        # blocks' cotangents, rank j's being j + 1.
        assert torch.equal(got["summed"], torch.tensor([[float(i)], [float(n + i)]]) * total * n)
        assert torch.equal(got["summed_grad"], torch.arange(1.0, n + 1).expand(2, n))


def test_an_nccl_group_carries_host_tensors_on_the_card(monkeypatch):
    from tchvp_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives.dist, "get_backend", lambda group: "gloo")
    assert collectives._carrier(None) == torch.device("cpu")
    monkeypatch.setattr(collectives.dist, "get_backend", lambda group: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert collectives._carrier(None) == torch.device("cuda", 1)
    monkeypatch.setattr(collectives, "_carrier", lambda group: torch.device("meta"))
    host = torch.ones(2, 3).t()
    wired = collectives._wire(host, None)
    assert wired.device.type == "meta" and wired.is_contiguous() and host.device.type == "cpu"


def test_only_the_collectives_module_talks_to_the_backend():
    import re
    from pathlib import Path

    import tchvp_tpu_torch

    call = re.compile(r"\b(?:dist|torch\.distributed)\.(?:all_reduce|all_gather\w*|broadcast\w*|batch_isend_irecv"
                      r"|i?send|i?recv|reduce_scatter\w*|all_to_all\w*|gather|scatter|reduce)\(")
    root = Path(tchvp_tpu_torch.__file__).parent
    hits = [f"{p.relative_to(root)}:{n}" for p in sorted(root.rglob("*.py")) if p.name != "collectives.py"
            for n, line in enumerate(p.read_text().splitlines(), 1) if call.search(line)]
    assert not hits, hits


# ------------------------------------------------------------ recompute thread


class _SeqMesh:
    """Stands in for a DeviceMesh whose "seq" axis holds 2 ranks: enough
    for the gate, which reads only the axis names and sizes."""

    mesh_dim_names = ("seq",)

    def size(self, mesh_dim=None):
        return 2


class _MeshRecorder(torch.nn.Module):
    """The video model's stages, each recording whether the seq mesh is in
    scope when it runs (the forward and each recompute)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.seen = []

    def _mark(self, x):
        from tchvp_tpu_torch.parallel import mesh_with_axis

        self.seen.append(mesh_with_axis("seq") is not None)
        return x * self.w

    def encode_clip(self, c, draws=None):
        return self._mark(c), (1, 1)

    def temporal_mix(self, t, draws=None):
        return self._mark(t)

    def decode_tokens(self, t, hw):
        return self._mark(t)

    def forward(self, c, draws=None):
        t = self._mark(c)
        return t, self._mark(t)


@pytest.mark.parametrize("policy", ["full", "stages", "dots"])
def test_recompute_on_another_thread_keeps_the_mesh(policy):
    """On CUDA a checkpointed region's recompute runs on the autograd
    engine's own thread, which does not see the caller's ``activate_mesh``
    scope: the step's regions carry the mesh into it, as they carry QAT's
    hook. A backward run on another thread shows it (every stage, forward
    and recompute, saw the mesh); a region checkpointed without it is the
    control."""
    import threading

    from torch.utils.checkpoint import checkpoint

    from tchvp_tpu_torch import parallel

    def backward_on_a_thread(loss):
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join()

    model = _MeshRecorder()
    with parallel.activate_mesh(_SeqMesh()):
        _, recon = tsteps._remat_forward(model, torch.ones(3, requires_grad=True), None, policy)
    backward_on_a_thread((recon ** 2).sum())
    assert len(model.seen) > 2 and all(model.seen), model.seen
    assert torch.equal(model.w.grad, torch.full((3,), 6.0 if policy == "stages" else 4.0))  # d(w^6), d(w^4)
    control = _MeshRecorder()
    with parallel.activate_mesh(_SeqMesh()):
        out = checkpoint(control.temporal_mix, torch.ones(3, requires_grad=True), use_reentrant=False)
    backward_on_a_thread(out.sum())
    assert control.seen == [True, False]
