"""The port's launch over several hosts on the CPU: what each rank learns at
the rendezvous, and the hybrid mesh grouped by host, against the JAX
package's.

* ``host_layout``'s table: the host of each rank (hosts numbered by their
  lowest rank), its local rank, the card it takes and the backend, from
  every rank's identity (its host's name and the cards it sees);
* one spawn of 4 gloo ranks (``tests/torch_dist.py::run_hosts``) launched
  as two emulated hosts (``host=``), as two hosts whose ranks interleave,
  as one host and as hosts of 3 and 1 ranks: each rank's layout, read back
  while the group lives and gone after it, and ``make_hybrid_mesh``'s
  groups and refusals against JAX's ``make_hybrid_mesh`` over 4 CPU devices
  whose ``slice_index`` is the host;
* in the same spawn, ``video --mesh data=4`` through ``cli.main`` as two
  hosts (each rank's ``socket.gethostname`` giving its host) and as one:
  rank 0's launch line, the same first step bit for bit, held to JAX's
  step on the global batch from the same weights.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist
from tchvp_tpu import config as jcfg
from tchvp_tpu.models import video as jvideo
from tchvp_tpu.parallel.mesh import make_hybrid_mesh as jax_hybrid_mesh
from tchvp_tpu.train import state as jstate
from tchvp_tpu.train import steps as jsteps
from tchvp_tpu_torch import cli, convert
from tchvp_tpu_torch.config import TrainConfig
from tchvp_tpu_torch.data.synthetic import SyntheticClips
from tchvp_tpu_torch.parallel import host_layout, launch_line
from tchvp_tpu_torch.train import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD, SIZE, FRAMES, BATCH = 4, 32, 4, 4
LAUNCH_DEADLINE_S = 300
# The hosts of each spawned launch: a host name a rank.
HOSTS = {"two": ["h0", "h0", "h1", "h1"], "interleaved": ["h0", "h1", "h0", "h1"],
         "one": ["h0"] * 4, "uneven": ["h0", "h0", "h0", "h1"]}
CLI_HOSTS = {"cli_two": ["node0", "node0", "node1", "node1"], "cli_one": ["node0"] * 4}
ARGV = ["video", "--synthetic", "1", "--epochs", "1", "--save-every", "1", "--image-size", str(SIZE), "--layers",
        "1", "--batch-size", str(BATCH), "--clip-len", str(FRAMES), "--attn-impl", "flash", "--optimizer", "sgd",
        "--lr", "1", "--device-prefetch", "0", "--device", "cpu", "--mesh", f"data={WORLD}"]


def cards(*uuids):
    return [f"GPU-{u}" for u in uuids]


# (identities, rank, cuda) -> (host_index, local_rank, local_world, card, backend, hosts)
LAYOUTS = [
    pytest.param([["a", cards(0)]] * 2, 1, True, (0, 1, 2, 0, "gloo", 1), id="one_host_2_ranks_1_card"),
    pytest.param([["a", cards(0, 1, 2, 3)]] * 4, 2, True, (0, 2, 4, 2, "nccl", 1), id="one_host_4_ranks_4_cards"),
    pytest.param([["a", cards(0, 1, 2, 3)]] * 4 + [["b", cards(4, 5, 6, 7)]] * 4, 5, True, (1, 1, 4, 1, "nccl", 2),
                 id="two_hosts_4_ranks_4_cards"),
    pytest.param([["a", cards(0, 1)], ["a", cards(0, 1)], ["a", cards(2, 3)], ["a", cards(2, 3)]], 3, True,
                 (1, 1, 2, 1, "nccl", 2), id="one_name_two_card_sets"),
    pytest.param([["a", cards(0, 1)], ["b", cards(2, 3)], ["a", cards(0, 1)], ["b", cards(2, 3)]], 2, True,
                 (0, 1, 2, 1, "nccl", 2), id="interleaved_hosts"),
    pytest.param([["a", cards(0, 1)]] * 3 + [["b", cards(2, 3)]], 3, True, (1, 0, 1, 0, "gloo", 2),
                 id="one_host_short_of_cards"),
    pytest.param([["a", cards(0, 1)]] * 3 + [["b", cards(2, 3)]], 2, True, (0, 2, 3, 0, "gloo", 2),
                 id="ranks_sharing_two_cards"),
    pytest.param([["a", []], ["a", []], ["b", []], ["b", []]], 3, False, (1, 1, 2, None, "gloo", 2),
                 id="cpu_launch"),
]


@pytest.mark.parametrize("identities,rank,cuda,want", LAYOUTS)
def test_host_layout(identities, rank, cuda, want):
    layout = host_layout(identities, rank, cuda)
    got = (layout.host_index, layout.local_rank, layout.local_world, layout.card, layout.backend, layout.hosts)
    assert got == want
    # Every rank reads the same table: the same hosts and backend.
    for r in range(len(identities)):
        other = host_layout(identities, r, cuda)
        assert (other.host_of, other.host_cards, other.backend) == (layout.host_of, layout.host_cards, layout.backend)


@pytest.mark.parametrize("identities,cuda,line", [
    ([["a", cards(0, 1)]] * 2 + [["b", cards(2, 3)]] * 2, True, "launch: 2 hosts x 2 ranks, a card a rank, backend nccl"),
    ([["a", cards(0)]] * 2, True, "launch: 1 host x 2 ranks, ranks share cards (2 ranks on 1 card), so backend gloo "
                                  "(NCCL needs a card a rank)"),
    ([["a", []]] * 3 + [["b", []]], False, "launch: 2 hosts of 3, 1 ranks on the CPU, backend gloo"),
], ids=["nccl", "shared", "cpu"])
def test_launch_line(identities, cuda, line):
    assert launch_line(host_layout(identities, 0, cuda)) == line


def test_a_cuda_rank_without_a_card_is_refused():
    with pytest.raises(ValueError, match="ranks of host 1 see no card"):
        host_layout([["a", cards(0)], ["b", []]], 0, True)


@pytest.mark.parametrize("world,rank", [(2, 2), (2, -1), (1, 1)])
def test_a_process_id_outside_the_world_exits(world, rank):
    with pytest.raises(SystemExit, match=f"--process-id {rank}: a rank of --num-processes {world} is 0 to {world - 1}"):
        cli.main(["video", "--synthetic", "1", "--device", "cpu", "--coordinator", "localhost:1",
                  "--num-processes", str(world), "--process-id", str(rank)])


# ------------------------------------------------------------ the spawn


def _no_dropout(c):
    return dataclasses.replace(c, encoder=dataclasses.replace(c.encoder, dropout_rate=0.0),
                               temporal=dataclasses.replace(c.temporal, dropout_rate=0.0))


def _seeded_variables(jc, seed: int):
    """Flax variables of the JAX flagship's shapes, filled from numpy."""
    shapes = jax.eval_shape(jvideo.VideoHybridNet(config=jc).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0.0, 0.1 if name == "bias" else 0.2, x.shape)

    return {c: jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes[c])
            for c in ("params", "batch_stats")}


def _jax_step(jc, variables, batch):
    """JAX's step of the CLI's flow (SGD lr 1 clipped at 1.0, MSE at 32^2,
    no noise) on the whole batch: the new parameters and BatchNorm stats."""
    model = jvideo.VideoHybridNet(config=jc)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=jstate.make_optimizer(1.0, TrainConfig().weight_decay, grad_clip_norm=1.0, optimizer="sgd"),
        rng=jax.random.PRNGKey(1))
    new, _ = jsteps.make_video_train_step(SIZE, loss="mse", noise_std=0.0)(st, jnp.asarray(batch))
    return convert.from_flax({"params": jax.tree.map(np.asarray, new.params),
                              "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """Every rank's results, JAX's step on the CLI's global batch, the
    initial weights and the directory of the CLI runs. JAX's step runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("hosts")
    jc = _no_dropout(jcfg.flagship_video_config(image_size=SIZE, num_layers=1, attn_impl="xla"))
    variables = _seeded_variables(jc, 0)
    state = convert.from_flax(variables)
    inputs = {"hosts": HOSTS, "cli": CLI_HOSTS, "argv": ARGV, "state": state}
    ctx = mp.start_processes(torch_dist.run_hosts, args=(WORLD, str(tmp / "rendezvous"), str(tmp), inputs),
                             nprocs=WORLD, join=False, start_method="spawn")
    batch = next(iter(SyntheticClips(BATCH, FRAMES, SIZE, 1)))  # the CLI's --synthetic 1
    want = _jax_step(jc, variables, batch)
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {LAUNCH_DEADLINE_S} s")
    ranks = [torch.load(tmp / f"hosts_rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, want, state, tmp


@pytest.mark.parametrize("case", HOSTS)
def test_each_rank_learns_its_host_at_the_rendezvous(hosts, case):
    ranks = hosts[0]
    for r, got in enumerate(ranks):
        want = host_layout([[h, []] for h in HOSTS[case]], r, cuda=False)
        assert got[case]["layout"] == got[case]["read_back"] == want
        assert got[case]["after"] is None  # the group is gone
        assert want.backend == "gloo" and want.card is None
    locals_ = {"two": [0, 1, 0, 1], "interleaved": [0, 0, 1, 1], "one": [0, 1, 2, 3], "uneven": [0, 1, 2, 0]}
    assert [g[case]["layout"].local_rank for g in ranks] == locals_[case]


def _jax_meshes(case: str) -> list:
    """JAX's make_hybrid_mesh over 4 CPU devices whose slice is the host of
    ``case``: each case's device ids, or the refusal's message in the
    port's words (ranks for devices)."""

    class Device:
        def __init__(self, device, slice_index):
            self.device, self.slice_index = device, slice_index

        def __getattr__(self, name):
            return getattr(self.device, name)

    order = {}
    devices = [Device(d, order.setdefault(h, len(order))) for d, h in zip(jax.devices()[:WORLD], HOSTS[case])]
    got = []
    for ici, dcn in torch_dist.HYBRID_CASES:
        try:
            mesh = jax_hybrid_mesh(("data",), ici, dcn_size=dcn, devices=devices)
            got.append(np.vectorize(lambda d: d.id)(mesh.devices).tolist())
        except ValueError as e:
            got.append(str(e).replace("devices", "ranks"))
    return got


# What the port builds for torch_dist.HYBRID_CASES ((2,) default and
# dcn 2, (4,) default, (1,) with dcn 4), case by case.
MESHES = {
    "one": ["1 slices x (2,) ici = 2 ranks, have 4", [[0, 1], [2, 3]], [[0, 1, 2, 3]], [[0], [1], [2], [3]]],
    "two": [[[0, 1], [2, 3]], [[0, 1], [2, 3]], "2 slices x (4,) ici = 8 ranks, have 4", [[0], [1], [2], [3]]],
    "interleaved": [[[0, 2], [1, 3]], [[0, 2], [1, 3]], "2 slices x (4,) ici = 8 ranks, have 4",
                    [[0], [1], [2], [3]]],
    "uneven": ["uneven slices: [3, 1] ranks per slice, need 2", "uneven slices: [3, 1] ranks per slice, need 2",
               "2 slices x (4,) ici = 8 ranks, have 4", [[0], [1], [2], [3]]],
}


@pytest.mark.parametrize("case", HOSTS)
def test_hybrid_mesh_groups_by_host_as_jax_groups_by_slice(hosts, case):
    """One host: an explicit dcn_size groups ranks contiguously and the
    default (one slice) refuses an ICI shape short of the world, as JAX
    does; two hosts: dcn_size defaults to 2 and each group is a host's
    ranks, interleaved or not; uneven hosts are refused in JAX's words."""
    want = _jax_meshes(case)
    assert want == MESHES[case]
    for got in hosts[0]:
        assert got[case]["meshes"] == want


def test_video_data_mesh_two_hosts_equals_one_host_and_jax(hosts):
    """``video --mesh data=4`` as two hosts of two ranks and as one host of
    four: rank 0 prints the launch, run.json records the host, the first
    step is the same bit for bit, and it is JAX's step on the global batch
    (parameters within 2e-2 of the largest update, as
    ``tests/test_torch_data_parallel.py`` holds data=2; BatchNorm stats
    within 1e-5)."""
    import json

    ranks, want, init, tmp = hosts
    lines = {name: ranks[0][name]["printed"].splitlines()[0] for name in CLI_HOSTS}
    assert lines == {"cli_two": "launch: 2 hosts x 2 ranks on the CPU, backend gloo",
                     "cli_one": "launch: 1 host x 4 ranks on the CPU, backend gloo"}
    assert not any("launch:" in g[n]["printed"] for g in ranks[1:] for n in CLI_HOSTS)
    assert [g["cli_two"]["layout"].host_index for g in ranks] == [0, 0, 1, 1]
    assert all("flash_mha_plain" in g[n]["seen"] for g in ranks for n in CLI_HOSTS)
    assert not any(g["jax_loaded"] for g in ranks)
    env = {n: json.loads((tmp / n / "run.json").read_text())["environment"] for n in CLI_HOSTS}
    assert [(env[n]["host_index"], env[n]["local_world"], env[n]["world_size"]) for n in CLI_HOSTS] == \
        [(0, 2, 4), (0, 4, 4)]
    two, one = (ckpt.restore_state(str(tmp / n / "step_1"))["model"] for n in CLI_HOSTS)
    assert two.keys() == one.keys()
    assert all(torch.equal(two[k], one[k]) for k in one)
    assert set(want) <= set(one)
    update = max((init[k] - want[k]).abs().max().item() for k in want if "running" not in k)
    for key, val in want.items():
        if "num_batches" in key:  # JAX keeps no count
            continue
        atol = 1e-5 if "running" in key else 2e-2 * update
        np.testing.assert_allclose(one[key].numpy(), val.numpy(), atol=atol, rtol=0, err_msg=key)
