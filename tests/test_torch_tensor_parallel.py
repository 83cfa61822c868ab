"""The port's tensor parallelism over the ``model`` axis against the JAX
package's unsharded models, on 4 gloo ranks.

Counterpart of JAX's ``tests/test_parallel.py::test_tensor_parallel_matches_unsharded``,
``::test_conv_tensor_parallel_matches_unsharded``,
``::test_conv_tp_skips_indivisible_channels`` and
``tests/test_flow_parallel.py::test_videoflow_tensor_parallel_engages``. One
``torch.multiprocessing`` launch of 4 ranks runs
``tests/torch_dist.py::run_tp`` (which imports no JAX): model=2 on a
("rep", "model") mesh of (2, 2) ("rep" is an axis nothing reads: the two
rows are replicas), each rank computing its half of the heads, of the FFN
hidden dim and of the conv channels; then data=2 x model=2, where a
gradient off by the model axis's size (a replicated weight's slices not
summed over it, or summed twice) or by the data axis's (the mean taken
twice, or not at all) fails; then ``video --mesh data=2,model=2`` through
the CLI against one process. Dropout and input noise are off, SGD lr 1, as
in ``tests/test_torch_data_parallel.py``, whose tolerances hold: metrics
rtol 1e-5, parameters 2e-2 x the largest gradient, BatchNorm stats 1e-5.
"""

import contextlib
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_data_parallel as dp
import torch_dist
from tchvp_tpu import config as jcfg
from tchvp_tpu.models import TransformerEncoder as JTransformerEncoder
from tchvp_tpu.models.resnet_ae import Autoencoder32K as JAutoencoder32K
from tchvp_tpu_torch import cli
from tchvp_tpu_torch import config as tcfg
from tchvp_tpu_torch import convert
from tchvp_tpu_torch.models.transformer import TransformerEncoder
from tchvp_tpu_torch.ops import attention as tatt
from tchvp_tpu_torch.parallel import tp
from tchvp_tpu_torch.train import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD = 4
LAUNCH_DEADLINE_S = 900
ENC = dict(input_dim=32, hidden_dim=16, num_layers=2, num_heads=4, dropout_rate=0.0)
CLI_ARGV = ["video", "--synthetic", "1", "--epochs", "1", "--image-size", "32", "--layers", "1",
            "--batch-size", "4", "--clip-len", "2", "--optimizer", "sgd", "--lr", "1",
            "--device-prefetch", "0", "--device", "cpu", "--attn-impl", "flash"]


def _seeded(model, x, seed: int):
    """Flax variables of ``model``'s shapes filled from numpy (the weights
    of ``tests/test_torch_data_parallel.py``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, v.shape)
        return rng.normal(0.0, 0.1 if name == "bias" else 0.2, v.shape)

    return {c: jax.tree_util.tree_map_with_path(lambda p, v: leaf(p, v).astype(np.float32), shapes[c])
            for c in shapes}


@pytest.fixture(scope="module")
def transformer_case():
    jmodel = JTransformerEncoder(config=jcfg.TransformerConfig(**ENC))
    x = np.random.default_rng(0).normal(size=(4, 6, 32)).astype(np.float32)
    variables = _seeded(jmodel, jnp.asarray(x), 1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), deterministic=True))
    state = {k[len("temporal."):]: v
             for k, v in convert.from_flax({"params": {"temporal": variables["params"]}}).items()}
    return {"config": ENC, "x": x, "state": state}, want


@pytest.fixture(scope="module")
def autoencoder_case():
    jmodel = JAutoencoder32K(config=jcfg.ResNetAEConfig(token_latent=False))
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    variables = _seeded(jmodel, jnp.asarray(x), 2)
    latent, recon = jmodel.apply(variables, jnp.asarray(x))
    return {"x": x, "state": convert.from_flax(variables)}, (np.asarray(latent), np.asarray(recon))


@pytest.fixture(scope="module")
def video_cases():
    return {"model2": dp._video_case({"attn_impl": "xla"}, {"attn_impl": "flash", "tp_axis": "model"}, 4, 3),
            "data_model": dp._video_case({"attn_impl": "xla"}, {"attn_impl": "flash", "tp_axis": "model"}, 4, 4)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, transformer_case, autoencoder_case, video_cases):
    tmp = tmp_path_factory.mktemp("tp")
    inputs = {"transformer": transformer_case[0], "autoencoder": autoencoder_case[0],
              "model2": video_cases["model2"][0], "data_model": video_cases["data_model"][0],
              "cli": CLI_ARGV + ["--mesh", "data=2,model=2", "--checkpoint-dir", str(tmp / "cli")]}
    ctx = mp.start_processes(torch_dist.run_tp, args=(WORLD, str(tmp / "rendezvous"), str(tmp), inputs),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    return tmp, [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_tensor_parallel_matches_unsharded(ranks, transformer_case):
    """The transformer on 2 heads of 4 a rank equals JAX's unsharded encoder;
    its gradients (the tokens', and every parameter's summed over the axis)
    equal the port's unsharded ones."""
    _, results = ranks
    inputs, want = transformer_case
    model = TransformerEncoder(tcfg.TransformerConfig(**ENC))
    model.load_state_dict(inputs["state"])
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    (model.train()(x) ** 2).sum().backward()
    for r in results:
        got = r["transformer"]
        assert "tp_constrain" in got["seen"], sorted(got["seen"])
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got["x_grad"], x.grad, rtol=1e-4, atol=1e-4)
        for k, p in model.named_parameters():
            torch.testing.assert_close(got["grads"][k], p.grad, rtol=1e-4, atol=1e-4, msg=k)


def test_conv_tensor_parallel_matches_unsharded(ranks, autoencoder_case):
    """Autoencoder32K with every conv stage's channels in halves: the
    encoder's latent comes out as this rank's 4 of 8 channels, the returned
    latent and reconstruction equal JAX's unsharded model."""
    _, results = ranks
    _, (latent, recon) = autoencoder_case
    for r in results:
        got = r["autoencoder"]
        assert "tp_constrain_conv" in got["seen"], sorted(got["seen"])
        assert got["enc_channels"] == 4
        np.testing.assert_allclose(got["latent"].numpy(), latent, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["recon"].numpy(), recon, rtol=2e-5, atol=2e-5)


def test_conv_tp_skips_indivisible_channels(ranks):
    """3 channels over model=2 stay whole, without the marker; 4 channels
    split, this rank keeping its 2; no mesh, no change; ``tp_constrain``'s
    gate likewise on the trailing dim."""
    x = torch.ones(2, 3, 8, 8)
    assert tp.conv_tp_constrain(x, "model") is x  # no ambient mesh
    _, results = ranks
    for rank, r in enumerate(results):
        got = r["autoencoder"]
        assert got["three_same"] and "tp_constrain_conv" not in got["three_seen"]
        i = rank % 2  # the model index of a ("rep", "model") mesh
        assert "tp_constrain_conv" in got["four_seen"]
        assert got["four"].flatten().tolist() == [2.0 * i, 2.0 * i + 1]
        # tp_constrain: the trailing dim's block; an indivisible one with
        # require_divisible stays whole.
        assert "tp_constrain" in got["six_seen"] and got["odd_same"]
        assert got["six"].flatten().tolist() == [3.0 * i, 3.0 * i + 1, 3.0 * i + 2]


@pytest.mark.parametrize("case", ["model2", "data_model"])
def test_tensor_parallel_step_matches_jax(ranks, video_cases, case):
    """model=2 (each rank the whole batch) and data=2 x model=2 (each data
    rank its half): one step of the flagship equals JAX's unsharded step on
    the global batch; the flash kernel's plain version runs on 4 of 8 heads;
    the parameters used through a slice are the ones expected."""
    _, results = ranks
    inputs, want, metrics = video_cases[case]
    got = [r[case] for r in results]
    dp._check_video(got, inputs, want, metrics)
    for r in got:
        assert {"tp_constrain", "tp_constrain_conv", "flash_mha_plain"} <= r["seen"], sorted(r["seen"])
        assert "temporal.layers.0.ffn1.weight" in r["sliced"] and "encoder.stem_conv.weight" in r["sliced"]
        assert "decoder.head_conv.weight" not in r["sliced"]  # 3 channels: whole on every rank


@pytest.mark.parametrize("name", ["temporal.layers.0.ffn1.weight", "temporal.layers.0.attention.out_linear.bias",
                                  "temporal.layers.0.norm.weight", "encoder.stem_conv.weight",
                                  "decoder.head_conv.weight", "encoder.stem_bn.weight"])
def test_data_model_gradients_are_not_scaled(ranks, video_cases, name):
    """The trap of JAX's ``parallel/tp.py`` note: under data=2 x model=2
    each weight's update (1.9 x its gradient under SGD's first Nesterov
    step) is JAX's, neither twice (model slices summed twice, the data mean
    skipped) nor half (the mean taken twice). The ratio of the updates'
    norms is held within 2 %."""
    _, results = ranks
    inputs, want, _ = video_cases["data_model"]
    init = inputs["state"][name]
    got = results[0]["data_model"]["state"][name]
    ratio = float((init - got).norm() / (init - want[name]).norm())
    assert abs(ratio - 1.0) < 0.02, ratio


def test_videoflow_tensor_parallel_engages(ranks):
    _, results = ranks
    for r in results:
        got = r["flow"]
        assert {"tp_constrain", "tp_constrain_conv"} <= got["seen"], sorted(got["seen"])
        assert got["step"] == 1 and "Video epoch 1" in got["printed"]
        assert np.isfinite(float(got["printed"].split("loss ")[1].split()[0]))


def test_video_data_model_cli_ranks_match_one_process(ranks, tmp_path, monkeypatch):
    """``video --mesh data=2,model=2`` as 4 ranks through the CLI: the
    markers, and its checkpoint against one process's on the same batch."""
    tmp, results = ranks
    for r in results:
        assert {"tp_constrain", "tp_constrain_conv"} <= r["cli"]["seen"], sorted(r["cli"]["seen"])
        assert not r["jax_loaded"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcfg, "flagship_video_config", torch_dist.flagship_without_dropout)
    from tchvp_tpu_torch.train import steps as tsteps

    monkeypatch.setattr(tsteps, "make_video_train_step",
                        __import__("functools").partial(tsteps.make_video_train_step, noise_std=0.0))
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(CLI_ARGV + ["--checkpoint-dir", str(tmp_path / "one")])
    one = ckpt.restore_state(str(tmp_path / "one" / "step_1"))["model"]
    many = ckpt.restore_state(str(tmp / "cli" / "step_1"))["model"]
    init = cli._video_model(cli._build_parser()[0].parse_args(CLI_ARGV), "cpu").state_dict()
    grads = {k: (init[k] - one[k]) / 1.9 for k in one if "running" not in k and "num_batches" not in k}
    atol = 1.9 * 2e-2 * max(g.abs().max().item() for g in grads.values())
    assert one.keys() == many.keys()
    for k in one:
        torch.testing.assert_close(many[k], one[k], atol=atol if k in grads else 1e-5, rtol=0, msg=k)


@pytest.mark.parametrize("core", ["xla", "flash"])
def test_tensor_parallel_attention_dropout_draws(core):
    """A rank's attention dropout under model=2: the dense core keeps its
    heads of the whole keep mask, the kernels take one seed a rank."""
    whole = tatt.draw_attention_dropout(core, (2, 4, 8), 0.3, torch.Generator().manual_seed(0), torch.device("cpu"))
    parts = [tatt.draw_attention_dropout(core, (2, 4, 8), 0.3, torch.Generator().manual_seed(0),
                                         torch.device("cpu"), head_shards=(2, j)) for j in range(2)]
    if core == "xla":
        assert torch.equal(torch.cat(parts, dim=1), whole)
    else:
        assert all(p.shape == (1,) for p in parts) and not torch.equal(parts[0], parts[1])
