"""The port's spatial partitioning over the ``spatial`` axis against the JAX
package's unsharded models, on 4 gloo ranks; and tensor parallelism beside
``spatial``, beside ``seq`` and under QAT.

Counterpart of JAX's ``tests/test_parallel.py::test_spatial_partition_matches_unsharded``,
``::test_spatial_partition_train_step_bn_stats``,
``::test_fct_ring_spatial_attention_matches_unsharded``,
``::test_fct_fully_distributed_sp_plus_ring`` and
``tests/test_flow_parallel.py::test_videoflow_spatial_partition_engages``.
One ``torch.multiprocessing`` launch of 4 ranks runs
``tests/torch_dist.py::run_spatial`` (which imports no JAX): spatial=2 on a
("rep", "spatial") mesh of (2, 2) ("rep" is an axis nothing reads: the two
rows are replicas), each rank holding its half of every map's rows; then
data=2 x spatial=2, spatial=2 x model=2, seq=2 x model=2 and model=2 under
QAT. Forwards are held to JAX at JAX's own limits (2e-5; FCT 5e-5 and
1e-4); train steps (dropout and input noise off, SGD lr 1) at
``tests/test_torch_data_parallel.py``'s; the float64 train-mode forward
and backward of Autoencoder32K to the port's unsharded one at 1e-9 (train-
mode BatchNorm chains put any two fp32 runs 1-5 % of the largest gradient
apart, so exactness is shown in float64).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_data_parallel as dp
import torch_dist
from test_torch_tensor_parallel import _seeded
from tchvp_tpu import config as jcfg
from tchvp_tpu.models.fct import FCT as JFCT
from tchvp_tpu.models.resnet_ae import Autoencoder32K as JAutoencoder32K
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.config import ResNetAEConfig
from tchvp_tpu_torch.models.resnet_ae import Autoencoder32K
from tchvp_tpu_torch.ops.blocks import Conv2d
from tchvp_tpu_torch.parallel import spatial
from tchvp_tpu_torch.train.qat import qat_fake_quant
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD = 4
LAUNCH_DEADLINE_S = 900
FCT_FILTERS = (4, 8, 8, 8, 8, 8, 8, 8, 4)


@pytest.fixture(scope="module")
def ae_case():
    jmodel = JAutoencoder32K(config=jcfg.ResNetAEConfig(token_latent=False))
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = _seeded(jmodel, jnp.asarray(x), 3)
    latent, recon = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    state = convert.from_flax(variables)
    state64 = {k: v.double() if v.is_floating_point() else v for k, v in state.items()}
    return {"x": x, "state": state, "state64": state64}, (np.asarray(latent), np.asarray(recon))


@pytest.fixture(scope="module")
def fct_case():
    jmodel = JFCT(config=jcfg.FCTConfig(filters=FCT_FILTERS, attn_impl="xla"))
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    variables = _seeded(jmodel, jnp.asarray(x), 5)
    want = jax.jit(lambda v, t: jmodel.apply(v, t, deterministic=True))(variables, jnp.asarray(x))
    config = tcfg.FCTConfig(filters=FCT_FILTERS, attn_impl="xla")
    x224 = np.random.default_rng(6).uniform(size=(1, 224, 32, 3)).astype(np.float32)
    return {"x": x, "x224": x224, "state": convert.from_flax(variables), "config": config}, np.asarray(want)


def _port_case(inputs, **kw):
    tc = dp._no_dropout(tcfg.flagship_video_config(image_size=dp.SIZE, num_heads=8, hidden_dim=32, **kw))
    return {**inputs, "config": tc}


@pytest.fixture(scope="module")
def video_cases():
    inputs, want, metrics = dp._video_case({"attn_impl": "xla"}, {"attn_impl": "flash", "sp_axis": "spatial"}, 4, 5)
    return {
        "spatial2": (inputs, want, metrics),
        "data_spatial": (inputs, want, metrics),
        "spatial_model": (_port_case(inputs, attn_impl="flash", sp_axis="spatial", tp_axis="model"), want, metrics),
        "seq_model": dp._video_case({"attn_impl": "windowed", "window_size": 2},
                                    {"attn_impl": "flash", "window_size": 2, "seq_axis": "seq", "tp_axis": "model"},
                                    4, 6),
    }


def _qat_stack():
    return torch.nn.Sequential(Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(), Conv2d(8, 8, 3, padding=1, bias=True))


@pytest.fixture(scope="module")
def qat_case():
    torch.manual_seed(0)
    stack = _qat_stack()
    with torch.no_grad():
        stack[2].bias.normal_()
    return {"state": {k: v.clone() for k, v in stack.state_dict().items()},
            "x": np.random.default_rng(8).normal(size=(2, 3, 8, 8)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ae_case, fct_case, video_cases, qat_case):
    tmp = tmp_path_factory.mktemp("spatial")
    inputs = {"ae": ae_case[0], "fct": fct_case[0], "qat_convs": qat_case,
              **{k: v[0] for k, v in video_cases.items()}}
    ctx = mp.start_processes(torch_dist.run_spatial, args=(WORLD, str(tmp / "rendezvous"), str(tmp), inputs),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    return [torch.load(tmp / f"spatial_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _data_block(x: np.ndarray, key: str, rank: int) -> np.ndarray:
    """The rows of the batch a rank of ``key``'s mesh is given: its data
    block on data x spatial, the whole batch on rep x spatial."""
    if key.startswith("data"):
        half = x.shape[0] // 2
        return x[(rank // 2) * half:(rank // 2 + 1) * half]
    return x


@pytest.mark.parametrize("key", ["ae", "data_ae"], ids=["spatial2", "data2_spatial2"])
def test_spatial_partition_matches_unsharded(ranks, ae_case, key):
    """Autoencoder32K with every conv stack's rows in halves matches JAX's
    unsharded model; the rows were constrained and halo'd."""
    _, (latent, recon) = ae_case
    for rank, r in enumerate(ranks):
        got = r[key]
        assert {"sp_constrain_conv", "sp_halo", "sp_gather"} <= got["seen"], sorted(got["seen"])
        np.testing.assert_allclose(got["latent"].numpy(), _data_block(latent, key, rank), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["recon"].numpy(), _data_block(recon, key, rank), rtol=2e-5, atol=2e-5)


def test_row_blocks_are_never_gathered_in_the_conv_stack(ranks):
    """JAX's "no all-gather" check: the encoder's rows are sliced once at its
    entry, exchange one halo per conv whose kernel reaches past its block
    (every 3x3 and 7x7; no 1x1), and are never gathered; the latent is this
    rank's 8 of 16 rows."""
    encoder = Autoencoder32K(ResNetAEConfig(token_latent=False), device="cpu").encoder
    engaged = 0
    for m in encoder.modules():
        if isinstance(m, Conv2d):
            top = m.padding[0]
            engaged += bool(top or spatial.halo_rows(m.kernel_size[0], m.stride[0], m.dilation[0], top))
    assert engaged == 1 + 7 + 4  # the stem, a 3x3 a Bottleneck, the squeeze chain
    for r in ranks:
        assert r["ae"]["counts"] == {"halo": engaged, "slice": 1, "gather": 0}
        assert r["ae"]["enc_rows"] == 8


def test_spatial_gate_and_indivisible_rows(ranks, ae_case):
    """``conv_constrain(sp_axis=)`` slices a whole map's rows where the axis
    divides them and keeps an indivisible map whole; ``shard_batch`` places
    a batch's rows as JAX's does; a stack whose blocks cannot halve at its
    strided stages stays whole on every rank, as JAX's gate keeps such maps
    (no slice, halo or gather), and equals the unsharded model; entered
    outside its scope, such a stack is refused."""
    inputs, _ = ae_case
    model = Autoencoder32K(ResNetAEConfig(token_latent=False), device="cpu").eval()
    model.load_state_dict(inputs["state"])
    with torch.no_grad():
        want = model(torch.from_numpy(inputs["x"][:, :36]))
    for rank, r in enumerate(ranks):
        got = r["ae"]
        assert got["odd_whole"]
        i = rank % 2  # the spatial index of a ("rep", "spatial") mesh
        assert got["rows"] == [2.0 * i, 2.0 * i + 1]
        # shard_batch(sp_axis=, sp_dim=2): a clip's rows in blocks; a 3-D
        # image batch's dim 2 is its width here, 1 wide: left whole.
        clip, image = got["placed"]
        assert clip.flatten().tolist() == [4.0 * i + j for j in range(4)] and image.shape == (1, 8, 1)
        assert "6 rows over spatial=2" in got["gate_error"] and "by 8" in got["gate_error"]
        assert "sp_whole" in got["whole_seen"] and "sp_constrain_conv" not in got["whole_seen"]
        assert got["whole_counts"] == {"halo": 0, "slice": 0, "gather": 0}
        for g, w in zip(got["whole"], want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_spatial_train_step_grads_and_bn_stats_float64(ranks, ae_case):
    """A train-mode forward and backward of Autoencoder32K over spatial=2
    (Dropout2d on, one draw on every rank) equals the unsharded one in
    float64: the outputs and every gradient (summed over the axis); the
    moved BatchNorm stats, which both paths move by fp32 statistics, to
    fp32's precision."""
    _check_f64_step(ranks, ae_case, "blocks", 64)


def test_whole_stack_train_step_float64(ranks, ae_case):
    """A stack kept whole (36 rows: a rank's 18 do not halve at the
    encoder's strides) over spatial=2, train mode: the outputs, every
    gradient (each rank's 1/2 of it, summed over the axis) and the moved
    BatchNorm stats equal the unsharded step's, in float64."""
    _check_f64_step(ranks, ae_case, "whole", 36)


def _check_f64_step(ranks, ae_case, key: str, rows: int) -> None:
    inputs, _ = ae_case
    model = Autoencoder32K(ResNetAEConfig(token_latent=False), device="cpu").double().train()
    model.load_state_dict(inputs["state64"])
    latent, recon = model(torch.from_numpy(inputs["x"][:, :rows]).double(),
                          generator=torch.Generator().manual_seed(7))
    (recon.square().mean() + latent.mean()).backward()
    gmax = max(p.grad.abs().max().item() for p in model.parameters())
    for r in ranks:
        got = r["ae64"][key]
        torch.testing.assert_close(got["recon"], recon.detach(), rtol=0, atol=1e-10)
        torch.testing.assert_close(got["latent"], latent.detach(), rtol=0, atol=1e-10)
        for k, p in model.named_parameters():
            torch.testing.assert_close(got["grads"][k], p.grad, rtol=0, atol=1e-9 * gmax, msg=k)
        for k, b in model.named_buffers():  # the running stats move by fp32 statistics in either path
            torch.testing.assert_close(got["buffers"][k], b, rtol=1e-6, atol=1e-6, msg=k)


@pytest.mark.parametrize("case", ["spatial2", "data_spatial", "spatial_model", "seq_model"])
def test_spatial_and_tensor_steps_match_jax(ranks, video_cases, case):
    """One step of the flagship equals JAX's unsharded step on the global
    batch: spatial=2, data=2 x spatial=2, tensor parallelism beside
    spatial=2 and beside seq=2 (the halo kernels' plain versions on 4 of 8
    heads)."""
    inputs, want, metrics = video_cases[case]
    got = [r[case] for r in ranks]
    dp._check_video(got, inputs, want, metrics)
    for r in got:
        if "spatial" in case:
            assert {"sp_constrain_conv", "sp_halo"} <= r["seen"], sorted(r["seen"])
        if "model" in case:
            assert {"tp_constrain", "tp_constrain_conv"} <= r["seen"], sorted(r["seen"])
        if case == "seq_model":
            assert "windowed_mha_halo" in r["seen"], sorted(r["seen"])


@pytest.mark.parametrize("key", ["fct", "data_fct"], ids=["spatial2", "data2_spatial2"])
@pytest.mark.parametrize("impl,marker", [("xla", "seq_gathered"), ("ring", "ring_shard_map")])
def test_fct_spatial_matches_unsharded(ranks, fct_case, key, impl, marker):
    """FCT with its rows in halves: the H*W-token attention gathers the keys
    and values over the axis, or rides the ring over it; either equals
    JAX's unsharded FCT at JAX's limits."""
    _, want = fct_case
    for rank, r in enumerate(ranks):
        got = r[key][impl]
        assert {"sp_constrain_conv", marker} <= got["seen"], sorted(got["seen"])
        np.testing.assert_allclose(got["out"].numpy(), _data_block(want, key, rank), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_fct_whole_at_224_rows_matches_unsharded(ranks, fct_case, impl):
    """FCT at its published 224 rows over spatial=2: a rank's 112 rows do not
    halve 5 times, so the network stays whole on every rank (no row block,
    the attention on the whole sequence) where the port used to refuse;
    a train-mode forward and backward equals the unsharded FCT's, the
    gradients summed over the axis."""
    import dataclasses

    from tchvp_tpu_torch.models.fct import FCT

    inputs, _ = fct_case
    model = FCT(dataclasses.replace(inputs["config"], attn_impl=impl, seq_axis="spatial" if impl == "ring" else None),
                device="cpu").train()
    model.load_state_dict(inputs["state"])
    x = torch.from_numpy(inputs["x224"]).requires_grad_()
    out = model(x, generator=torch.Generator().manual_seed(3))
    out.square().mean().backward()
    for r in ranks:
        got = r["fct"][f"{impl}_224"]
        assert "sp_whole" in got["seen"] and "sp_constrain_conv" not in got["seen"], sorted(got["seen"])
        torch.testing.assert_close(got["out"], out.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["x_grad"], x.grad, rtol=1e-5, atol=1e-7)
        for k, p in model.named_parameters():
            torch.testing.assert_close(got["grads"][k], p.grad, rtol=1e-5, atol=1e-7, msg=k)


def test_tensor_parallel_under_qat_matches_one_process(ranks, qat_case):
    """QAT's fake quant under model=2: the whole kernel quantized per output
    channel, then sliced; the activation scale the max over the channel
    blocks. Output and gradients equal one process's; the flagship's QAT
    step runs under model=2."""
    stack = _qat_stack()
    stack.load_state_dict(qat_case["state"])
    x = torch.from_numpy(qat_case["x"]).requires_grad_()
    with qat_fake_quant():
        out = stack(x)
    out.square().sum().backward()
    for r in ranks:
        got = r["qat_convs"]
        assert {"qat_fake_quant", "tp_constrain_conv"} <= got["seen"], sorted(got["seen"])
        torch.testing.assert_close(got["out"], out.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["x_grad"], x.grad, rtol=1e-4, atol=1e-4)
        for k, p in stack.named_parameters():
            torch.testing.assert_close(got["grads"][k], p.grad, rtol=1e-4, atol=1e-4, msg=k)
        flow = r["qat_flow"]
        assert {"qat_fake_quant", "tp_constrain_conv"} <= flow["seen"], sorted(flow["seen"])
        assert np.isfinite(float(flow["printed"].split("loss ")[1].split()[0]))


def test_ranks_loaded_no_jax(ranks):
    for r in ranks:
        assert not r["jax_loaded"], r["jax_loaded"]


def test_batchnorm_over_two_of_three_axes(tmp_path):
    """On a data x spatial x model mesh of (2, 2, 2) (8 gloo ranks), the group
    over data and spatial holds the 4 ranks of one model index, and a
    train-mode BatchNorm on a rank's block of the batch, rows and channels
    equals the unsharded one's block; its running stats the unsharded
    ones."""
    from tchvp_tpu_torch.ops.blocks import BatchNorm

    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 4, 8, 3)).astype(np.float32)
    bn = BatchNorm(4).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    inputs = {"bn": {k: v.clone() for k, v in bn.state_dict().items()}, "x": x}
    ctx = mp.start_processes(torch_dist.run_groups, args=(8, str(tmp_path / "rendezvous"), str(tmp_path), inputs),
                             nprocs=8, join=False, start_method="spawn")
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"8 ranks did not finish in {LAUNCH_DEADLINE_S} s")
    want = bn(torch.from_numpy(x)).detach()
    for r in range(8):
        got = torch.load(tmp_path / f"groups_rank{r}.pt", weights_only=False)
        d, s, m = got["index"]
        assert sorted(got["members"]) == sorted(float(q) for q in range(8) if q % 2 == r % 2)
        torch.testing.assert_close(got["out"], want[d * 2:(d + 1) * 2, m * 2:(m + 1) * 2, s * 4:(s + 1) * 4],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["stats"][0], bn.running_mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["stats"][1], bn.running_var, rtol=1e-5, atol=1e-6)
