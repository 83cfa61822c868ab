"""The port's ClipPack loader against the JAX package's.

On the same file, the port's ``ClipPackDataset`` (native library built
with ``g++`` into ``tchvp_tpu_torch/_build/``, and the numpy reader) gives
the batches of ``tchvp_tpu.data.clippack.ClipPackDataset`` bit for bit:
shuffled and not, over two epochs, after a ``seek`` mid-epoch, after an
abandoned iterator, and sharded over ``num_shards`` hosts. The shuffle
(``epoch_permutation``) equals JAX's; a corrupt header raises; and with
``prefer_native=True`` a compiler that cannot run raises instead of
falling back to the numpy reader. ``pack_from_manifest`` is held to JAX's
in ``test_torch_manifest.py``.
"""

import numpy as np
import pytest

from tchvp_tpu.data import clippack as jcp
from tchvp_tpu_torch.data import clippack as tcp
from tchvp_tpu_torch.kernels import build


def _pack(tmp_path, n=17, shape=(2, 4, 6, 3), seed=0):
    clips = np.random.default_rng(seed).integers(0, 256, (n,) + shape, dtype=np.uint8)
    path = str(tmp_path / "clips.cpk")
    tcp.pack_clips(path, clips)
    return path, clips


def _jax(path, **kw):
    return jcp.ClipPackDataset(path, prefer_native=False, **kw)


def _equal_streams(a, b, epochs=2):
    """Iterates both ``epochs`` times; returns the batches per iteration."""
    counts = []
    for _ in range(epochs):
        got, want = list(a), list(b)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)
        assert a.position() == b.position()
        counts.append(len(got))
    return counts


def test_pack_clips_writes_the_jax_file(tmp_path):
    _, clips = _pack(tmp_path)
    jcp.pack_clips(str(tmp_path / "jax.cpk"), clips)
    assert (tmp_path / "clips.cpk").read_bytes() == (tmp_path / "jax.cpk").read_bytes()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_equal_jax_over_two_epochs(tmp_path, native, shuffle):
    path, clips = _pack(tmp_path)
    ds = tcp.ClipPackDataset(path, batch_size=4, shuffle=shuffle, seed=7, prefer_native=native)
    assert ds._native == native and ds.clip_shape == clips.shape[1:] and len(ds) == 4
    assert _equal_streams(ds, _jax(path, batch_size=4, shuffle=shuffle, seed=7)) == [4, 4]
    if not shuffle:
        np.testing.assert_array_equal(np.concatenate(list(tcp.ClipPackDataset(
            path, batch_size=4, shuffle=False, prefer_native=native))), clips[:16])
    ds.close()


@pytest.mark.parametrize("native", [True, False])
def test_seek_mid_epoch_equals_jax(tmp_path, native):
    path, _ = _pack(tmp_path)
    ds = tcp.ClipPackDataset(path, batch_size=4, seed=3, prefer_native=native)
    ref = _jax(path, batch_size=4, seed=3)
    for d in (ds, ref):
        d.seek(1, 2)
        assert d.position() == {"epoch": 1, "batch": 2}
    assert _equal_streams(ds, ref) == [2, 4]
    with pytest.raises(ValueError):
        ds.seek(0, 4)
    ds.close()


@pytest.mark.parametrize("native", [True, False])
def test_abandoned_iterator_equals_jax(tmp_path, native):
    path, _ = _pack(tmp_path, n=16)
    ds = tcp.ClipPackDataset(path, batch_size=4, seed=5, prefer_native=native)
    ref = _jax(path, batch_size=4, seed=5)
    for d in (ds, ref):
        for i, _ in enumerate(d):
            if i == 1:
                assert d.position() == {"epoch": 0, "batch": 2}
                break
    assert _equal_streams(ds, ref) == [4, 4]
    ds.close()


@pytest.mark.parametrize("native", [True, False])
def test_shards_concatenate_to_the_jax_batch(tmp_path, native):
    path, _ = _pack(tmp_path, n=24)
    whole = _jax(path, batch_size=8, seed=11)
    shards = [tcp.ClipPackDataset(path, batch_size=4, seed=11, prefer_native=native,
                                  shard_id=i, num_shards=2) for i in range(2)]
    assert len(whole) == len(shards[0]) == 3
    for _ in range(2):
        for b_whole, b0, b1 in zip(whole, *shards):
            np.testing.assert_array_equal(np.concatenate([b0, b1]), b_whole)
    for ds in shards:
        ds.close()
    with pytest.raises(ValueError, match="shard_id"):
        tcp.ClipPackDataset(path, batch_size=4, shard_id=2, num_shards=2, prefer_native=native)
    with pytest.raises(ValueError, match="global batch"):
        tcp.ClipPackDataset(path, batch_size=16, num_shards=2, prefer_native=native)


@pytest.mark.parametrize("n,seed,epoch", [(17, 7, 0), (17, 7, 1), (1000, 123, 5), (2, 0, 3)])
def test_epoch_permutation_equals_jax(n, seed, epoch):
    for shuffle in (True, False):
        np.testing.assert_array_equal(tcp.epoch_permutation(n, seed, epoch, shuffle),
                                      jcp.epoch_permutation(n, seed, epoch, shuffle))


@pytest.mark.parametrize("native", [True, False])
def test_corrupt_header_raises(tmp_path, native):
    bad = tmp_path / "bad.cpk"
    bad.write_bytes(b"not a clippack file at all" * 4)
    with pytest.raises(OSError, match="not a clippack"):
        tcp.ClipPackDataset(str(bad), batch_size=1, prefer_native=native)
    short = tmp_path / "short.cpk"
    short.write_bytes(b"CLPK")
    with pytest.raises(OSError, match="not a clippack"):
        tcp.ClipPackDataset(str(short), batch_size=1, prefer_native=native)


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    path, _ = _pack(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "HOST_CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tcp.ClipPackDataset(path, batch_size=4)
    monkeypatch.setattr(build, "HOST_CXX", "false")  # runs, and fails
    with pytest.raises(RuntimeError, match="failed building clippack"):
        tcp.ClipPackDataset(path, batch_size=4)
    assert not list((tmp_path / "build").glob("*/libclippack.so"))
    ds = tcp.ClipPackDataset(path, batch_size=4, prefer_native=False)  # only when asked
    assert not ds._native and len(list(ds)) == 4

