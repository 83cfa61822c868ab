"""The port's sequence parallelism on 2 and 4 gloo ranks against the JAX
package's.

One ``torch.multiprocessing.spawn`` per world size runs every rank through
``tests/torch_dist.py`` (a ``file://`` rendezvous in a temporary directory,
a 180 s process-group timeout); the ranks import the port only and save
their results, which the tests here compare:

* (a) both routes of ``sdpa_windowed_seq_sharded`` (the dense band with the
  halo, and the halo kernels' plain versions), forward and the gradients of
  sum(out**2), against the port's unsharded ``sdpa_windowed`` and against
  JAX's ``sdpa_windowed_seq_sharded`` on a CPU mesh of the same size, atol
  1e-4 (the shapes of ``test_parallel.py``'s seq-parallel tests); the
  flash route with dropout against a one-process emulation of the shards
  with the per-shard seeds; and JAX's ``ValueError`` for S/n % w != 0;
* (b) the rows of JAX's dispatch matrix with ``seq_axis``, by markers and
  outputs (ring is not ported and raises);
* (c) ``TransformerEncoder`` with ``seq_axis`` against JAX's unsharded
  encoder, atol 2e-5, on the dense band and the halo kernels;
* (d) one seq-parallel train step of the flagship (``make_video_train_step``
  given the global clip) against JAX's unsharded step from the same
  ``from_flax`` weights, at ``tests/test_torch_train.py``'s tolerances
  (loss and PSNR rtol 1e-5), the parameters and BatchNorm stats bit-equal across
  ranks;
* (e) the eval forward on each rank's frames against the single-process
  forward: the positional encoding takes the global rows.
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
from tchvp_tpu_torch.models import video as tvideo
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.ops import dispatch_trace
from tchvp_tpu_torch.train import state as tstate
from tchvp_tpu_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLDS = (2, 4)
ATT = dict(b=2, h=4, s=64, dh=8, w=8)
DISPATCH_ROWS = {  # key: (impl, window, mesh axes of the ranks, JAX's expected markers)
    "windowed_seq": ("windowed", 8, ("seq",), {"seq_sharded_shard_map", "banded_core"}),
    "flash_seq": ("flash", 8, ("seq",), {"seq_sharded_shard_map", "windowed_mha_halo"}),
    "xla_seq": ("xla", 8, ("seq",), {"sdpa_xla"}),
    "windowed_data": ("windowed", 8, ("data",), {"sdpa_windowed", "banded_core"}),
}
ENC = dict(input_dim=16, hidden_dim=24, num_layers=2, num_heads=4, dropout_rate=0.0, window_size=4)
SIZE, FRAMES, WINDOW = 32, 4, 2  # S = 32 tokens, 16 windows of 2


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


# ------------------------------------------------------------ the references


@pytest.fixture(scope="module")
def attention_inputs():
    b, h, s, dh, w = (ATT[k] for k in "b h s dh w".split())
    return {"qkv": _arrays((b, h, s, dh), 3, seed=0), "window": w}


@pytest.fixture(scope="module")
def dispatch_inputs():
    x = _arrays((2, 64, 16), 1, seed=0)[0]
    rows = {k: (impl, w, axes) for k, (impl, w, axes, _) in DISPATCH_ROWS.items()}
    return {"x": x, "heads": 2, "rows": rows}


@pytest.fixture(scope="module")
def transformer_inputs():
    jmodel = JTransformerEncoder(config=jcfg.TransformerConfig(**ENC, attn_impl="windowed"))
    x = _arrays((2, 32, 16), 1, seed=2)[0]
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), deterministic=True))
    state = {k[len("temporal."):]: v for k, v in convert.from_flax({"params": {"temporal": variables["params"]}}).items()}
    return {"config": ENC, "x": x, "state": state}, want


def _video_configs():
    def cut(c):
        return dataclasses.replace(c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
                                   temporal=dataclasses.replace(c.temporal, dropout_rate=0.0))

    kw = dict(image_size=SIZE, num_heads=8, hidden_dim=32, window_size=WINDOW)
    return (cut(jcfg.flagship_video_config(attn_impl="windowed", **kw)),
            cut(tcfg.flagship_video_config(attn_impl="flash", seq_axis="seq", **kw)))


@pytest.fixture(scope="module")
def video_reference():
    """JAX's unsharded step (SGD lr 1, MSE, no noise) from seeded weights,
    and the inputs of the ranks' step."""
    jc, tc = _video_configs()
    model = jvideo.VideoHybridNet(config=jc)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1 if name == "bias" else 0.2, x.shape)

    variables = {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
                 for c in ("params", "batch_stats")}
    batch = np.random.default_rng(6).integers(0, 256, (2, FRAMES, 48, 48, 3), dtype=np.uint8)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jstate.make_optimizer(1.0, optimizer="sgd"),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), rng=jax.random.PRNGKey(1))
    new, metrics = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)(st, jnp.asarray(batch))
    want = {"params": jax.tree.map(np.asarray, new.params), "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}
    clip = np.random.default_rng(7).uniform(size=(1, FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    inputs = {"config": tc, "state": convert.from_flax(variables), "size": SIZE, "batch": batch, "clip": clip}
    return inputs, variables, want, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request, tmp_path_factory, attention_inputs, dispatch_inputs, transformer_inputs, video_reference):
    """Every rank's results for one world size: a list indexed by rank."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"seq{world}")
    inputs = {"attention": attention_inputs, "dispatch": dispatch_inputs,
              "transformer": transformer_inputs[0], "video": video_reference[0]}
    mp.spawn(torch_dist.run, args=(world, str(tmp / "rendezvous"), str(tmp), inputs), nprocs=world,
             join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _cat(parts, dim):
    return torch.cat(list(parts), dim=dim).numpy()


# ------------------------------------------------------- (a) attention routes


def _jax_seq_sharded(inp, world):
    q, k, v = (jnp.asarray(t) for t in inp["qkv"])
    mesh = jmake_mesh(("seq",), (world,), devices=jax.devices()[:world])
    spec = NamedSharding(mesh, P(None, None, "seq", None))

    def loss(q, k, v):
        out = jatt.sdpa_windowed_seq_sharded(q, k, v, window_size=inp["window"], seq_axis="seq")
        return (out ** 2).sum(), out

    with jactivate_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            *(jax.device_put(t, spec) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("route,markers", [
    ("dense", {"seq_sharded_shard_map", "banded_core"}),
    ("flash", {"seq_sharded_shard_map", "windowed_mha_halo", "flash_halo_plain", "flash_halo_bwd_plain"}),
])
def test_seq_sharded_attention_matches_unsharded_and_jax(ranks, attention_inputs, route, markers):
    world = len(ranks)
    got = [r["attention"][route] for r in ranks]
    assert all(g["seen"] == markers for g in got)
    out = _cat((g["out"] for g in got), 2)
    grads = [_cat((g["grads"][j] for g in got), 2) for j in range(3)]

    q, k, v = (torch.from_numpy(t).requires_grad_() for t in attention_inputs["qkv"])
    want = tatt.sdpa_windowed(q, k, v, window_size=attention_inputs["window"])
    (want ** 2).sum().backward()
    jax_out, jax_grads = _jax_seq_sharded(attention_inputs, world)
    for ref_out, ref_grads in ((want.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]),
                               (jax_out, jax_grads)):
        np.testing.assert_allclose(out, ref_out, atol=1e-4, rtol=0)
        for name, g, r in zip("qkv", grads, ref_grads):
            np.testing.assert_allclose(g, r, atol=1e-4, rtol=0, err_msg=f"d{name}")


def test_flash_route_dropout_uses_one_seed_per_shard(ranks, attention_inputs):
    """The ranks draw n seeds from the shared generator and rank i takes
    seed i: a one-process emulation of the shards gives the same outputs."""
    world, w = len(ranks), attention_inputs["window"]
    seeds = torch.randint(0, 2**31 - 1, (world,), generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32)
    q, k, v = (torch.from_numpy(t).chunk(world, dim=2) for t in attention_inputs["qkv"])
    for i, r in enumerate(ranks):
        zeros = torch.zeros_like(k[i][:, :, -w:])
        k_ext = torch.cat([k[i - 1][:, :, -w:] if i else zeros, k[i]], 2)
        v_ext = torch.cat([v[i - 1][:, :, -w:] if i else zeros, v[i]], 2)
        want = tfa.windowed_mha_halo(q[i], k_ext, v_ext, window_size=w, has_prev=int(i > 0),
                                     dropout_rate=0.2, dropout_seed=seeds[i:i + 1])
        torch.testing.assert_close(r["attention"]["dropout"], want, rtol=0, atol=1e-6)
    assert not torch.equal(ranks[0]["attention"]["dropout"],
                           tatt.sdpa_windowed_seq_sharded(q[0], k[0], v[0], window_size=w, seq_axis="seq"))


def test_shard_not_a_multiple_of_the_window_raises_jax_error(ranks):
    s = ATT["s"]
    for r in ranks:
        assert r["attention"]["bad_window"] == f"seq shard {s}//{len(ranks)} not a multiple of window 3"


def test_halo_exchange_and_all_reduce_adjoints(ranks):
    n = len(ranks)
    for i, r in enumerate(ranks):
        c = r["collectives"]
        # Rank i receives rank i-1's x (= i), rank 0 zeros; the cotangent
        # (i + 2) of rank i+1 comes back to rank i, none to the last rank.
        assert torch.equal(c["ppermute"], torch.full((2, 3), float(i)))
        assert torch.equal(c["ppermute_grad"], torch.full((2, 3), float(i + 2) if i + 1 < n else 0.0))
        assert torch.equal(c["all_reduce"], torch.full((4,), n * (n + 1) / 2))
        assert torch.equal(c["all_reduce_grad"], torch.full((4,), n * (n + 1) / 2))


# ---------------------------------------------------------- (b) dispatch rows


@pytest.mark.parametrize("key", list(DISPATCH_ROWS))
def test_dispatch_rows_with_seq_axis_match_jax(ranks, dispatch_inputs, key):
    impl, window, axes, expect = DISPATCH_ROWS[key]
    x = dispatch_inputs["x"]
    got = [r["dispatch"][key] for r in ranks]
    for seen, _ in got:
        assert expect <= seen, f"expected {sorted(expect)}, ran {sorted(seen)}"
        assert ("seq_sharded_shard_map" in seen) == (key in ("windowed_seq", "flash_seq"))
    out = _cat((o for _, o in got), 1) if "seq" in axes else got[0][1].numpy()
    want = jatt.multi_head_attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), 2, impl=impl,
                                     window_size=window)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-5, rtol=0)


def test_dispatch_row_without_a_mesh_and_ring(ranks, dispatch_inputs):
    x = torch.from_numpy(dispatch_inputs["x"])
    with dispatch_trace.capture() as seen:
        tatt.multi_head_attention(x, x, x, 2, impl="windowed", window_size=8, seq_axis="seq")
    assert seen == {"sdpa_windowed", "banded_core"}
    assert all("item 11" in r["dispatch"]["ring"] for r in ranks)


# -------------------------------------------------------- (c) the transformer


@pytest.mark.parametrize("impl", ["windowed", "flash"])
def test_transformer_seq_axis_matches_unsharded_jax(ranks, transformer_inputs, impl):
    _, want = transformer_inputs
    got = _cat((r["transformer"][impl] for r in ranks), 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


# ------------------------------------------------- (d), (e) the flagship step


def test_seq_parallel_train_step_matches_unsharded_jax(ranks, video_reference):
    _, variables, want_vars, want_metrics = video_reference
    before, want = convert.from_flax(variables), convert.from_flax(want_vars)
    for r in ranks:
        v = r["video"]
        assert {"seq_sharded_shard_map", "windowed_mha_halo", "flash_halo_plain", "flash_halo_bwd_plain"} <= v["seen"]
        assert not v["seen"] & {"sdpa_xla", "sdpa_windowed", "flash_windowed"}
        np.testing.assert_allclose(v["metrics"]["loss"], want_metrics["loss"], rtol=1e-5, err_msg="loss")
        np.testing.assert_allclose(v["metrics"]["psnr"], want_metrics["psnr"], rtol=1e-5, err_msg="psnr")
        # SGD (lr 1, Nesterov 0.9): p1 = p0 - 1.9 g
        g_jax = {k: (before[k].numpy() - want[k].numpy()) / 1.9 for k in v["grads"]}
        grad_atol = 2e-2 * max(np.abs(g).max() for g in g_jax.values())
        for key, val in v["state"].items():
            if key.endswith("num_batches_tracked"):
                continue
            if key in v["grads"]:
                np.testing.assert_allclose(v["grads"][key].numpy(), g_jax[key], atol=grad_atol, err_msg=f"grad {key}")
                np.testing.assert_allclose(val.numpy(), want[key].numpy(), atol=1.9 * grad_atol, err_msg=key)
            else:
                np.testing.assert_allclose(val.numpy(), want[key].numpy(), atol=1e-5, err_msg=key)


def test_params_and_batch_stats_are_bit_equal_across_ranks(ranks):
    for r in ranks:
        assert all(r["video"]["equal_across"].values())
    for r in ranks[1:]:
        for key, val in r["video"]["state"].items():
            assert torch.equal(val, ranks[0]["video"]["state"][key]), key


def test_seq_parallel_options_not_ported_raise(ranks):
    for r in ranks:
        assert len(r["video"]["unported"]) == 2 and all("item 11" in m for m in r["video"]["unported"])


def test_posenc_offset_forward_matches_single_process(ranks, video_reference):
    """Each rank's frames through the eval forward equal the single-process
    forward's rows: the positional encoding is the global one."""
    inputs = video_reference[0]
    model = tvideo.VideoHybridNet(inputs["config"], device="cpu")
    model.load_state_dict(inputs["state"], strict=True)
    with torch.no_grad():
        tokens, recon = model.eval()(torch.from_numpy(inputs["clip"]))
    np.testing.assert_allclose(_cat((r["video"]["eval"][0] for r in ranks), 1), tokens.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_cat((r["video"]["eval"][1] for r in ranks), 1), recon.numpy(), atol=1e-5, rtol=1e-5)
    # The eval step on the global batch: the PSNR of the global MSE.
    state = tstate.create_train_state(model, tstate.make_optimizer(1.0, optimizer="sgd"))
    psnr = tsteps.make_video_eval_step(SIZE)(state, torch.from_numpy(inputs["batch"]))
    for r in ranks:
        np.testing.assert_allclose(r["video"]["eval_psnr"], float(psnr["psnr"]), atol=1e-4)


def test_ranks_loaded_no_jax(ranks):
    assert all(r["jax_loaded"] == [] for r in ranks)
