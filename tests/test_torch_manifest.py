"""The port's CSV-manifest datasets against the JAX package's.

On PNGs written into ``tmp_path`` with PIL (frames of two sizes, so the
host resize runs for some), the port's ``write_manifest``,
``write_clip_manifest``, ``read_manifest``, ``ImageDataset``,
``ImageMaskDataset``, ``ClipDataset``, ``make_loaders`` and
``pack_from_manifest`` give the files, rows, batches and positions of
``tchvp_tpu.data.manifest``'s, bit for bit: shuffled, over two epochs,
with the prefetch thread, after a seek and after an abandoned iterator.
"""

import numpy as np
import pytest

from tchvp_tpu.data import clippack as jcp
from tchvp_tpu.data import manifest as jm
from tchvp_tpu_torch.config import IngestConfig
from tchvp_tpu_torch.data import clippack as tcp
from tchvp_tpu_torch.data import manifest as tm

Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven images and masks in one directory, five clip directories of
    3 frames (one of 2), frames of 8x8 and 10x12."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    imgs = root / "imgs"
    imgs.mkdir()
    for i in range(7):
        shape = (8, 8) if i % 2 else (10, 12)
        Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).save(imgs / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(imgs / f"{i}_mask.png")
    (imgs / "notes.txt").write_text("not an image")
    clip_dirs = []
    for c in range(5):
        d = root / f"clip{c}"
        d.mkdir()
        for f in range(2 if c == 4 else 3):
            Image.fromarray(rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)).save(d / f"f{f}.png")
        clip_dirs.append(str(d))
    pairs = root / "pairs.csv"
    pairs.write_text("img,mask\n" + "".join(f"{imgs / f'{i}.png'},{imgs / f'{i}_mask.png'}\n"
                                              for i in range(7)))
    return root, clip_dirs, str(pairs)


def _same_batches(a, b, epochs=2):
    for _ in range(epochs):
        got, want = list(a), list(b)
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
                assert u.dtype == v.dtype == np.uint8
                np.testing.assert_array_equal(u, v)
        assert a.position() == b.position()


def test_write_and_read_manifests_equal_jax(corpus):
    root, clip_dirs, _ = corpus
    for mod in (tm, jm):
        assert mod.write_manifest(str(root / "imgs"), str(root / f"{mod.__name__}.csv")) == 14
        assert mod.write_clip_manifest(clip_dirs, str(root / f"{mod.__name__}_clips.csv"), clip_len=3) == 4
    for name in ("", "_clips"):
        t, j = (root / f"{m.__name__}{name}.csv" for m in (tm, jm))
        assert t.read_text() == j.read_text()
        for header in (None, True, False):
            assert tm.read_manifest(str(t), header=header) == jm.read_manifest(str(t), header=header)
        assert tm.read_manifest(str(t), 0.5) == jm.read_manifest(str(t), 0.5)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_image_dataset_equals_jax(corpus, prefetch, shuffle):
    root, _, _ = corpus
    csv = str(root / "images.csv")
    tm.write_manifest(str(root / "imgs"), csv)
    args = dict(batch_size=3, image_size=8, shuffle=shuffle, seed=4, prefetch=prefetch)
    _same_batches(tm.ImageDataset(csv, **args), jm.ImageDataset(csv, **args))


def test_image_mask_dataset_equals_jax(corpus):
    _, _, pairs = corpus
    args = dict(batch_size=2, image_size=8, seed=1)
    ours, theirs = tm.ImageMaskDataset(pairs, **args), jm.ImageMaskDataset(pairs, **args)
    assert len(ours) == len(theirs) == 3
    _same_batches(ours, theirs)
    img, mask = next(iter(ours))
    assert img.shape == (2, 8, 8, 3) and mask.shape == (2, 8, 8, 1)


@pytest.mark.parametrize("clip_len", [None, 2, 3])
def test_clip_dataset_equals_jax_with_seek_and_abandon(corpus, clip_len):
    root, clip_dirs, _ = corpus
    csv = str(root / f"clips{clip_len}.csv")
    tm.write_clip_manifest(clip_dirs[:4], csv)
    args = dict(batch_size=1, image_size=8, clip_len=clip_len, seed=2)
    ours, theirs = tm.ClipDataset(csv, **args), jm.ClipDataset(csv, **args)
    _same_batches(ours, theirs, epochs=1)
    for d in (ours, theirs):
        d.seek(3, 1)
    _same_batches(ours, theirs)
    for d in (ours, theirs):
        next(iter(d))
        assert d.position()["batch"] == 1
    _same_batches(ours, theirs)


def test_make_loaders_equal_jax(corpus):
    root, _, _ = corpus
    csv = str(root / "loaders.csv")
    tm.write_manifest(str(root / "imgs"), csv)
    ours, theirs = tm.make_loaders(csv, csv, None, 4, 8, 5), jm.make_loaders(csv, csv, None, 4, 8, 5)
    assert ours[2] is None and theirs[2] is None
    for a, b in zip(ours[:2], theirs[:2]):
        _same_batches(a, b, epochs=1)


def test_pack_from_manifest_equals_jax(corpus):
    root, clip_dirs, _ = corpus
    csv = str(root / "pack.csv")
    tm.write_clip_manifest(clip_dirs, csv)
    assert tcp.pack_from_manifest(csv, str(root / "t.cpk"), image_size=8, clip_len=3) == (4, 3)
    assert jcp.pack_from_manifest(csv, str(root / "j.cpk"), image_size=8, clip_len=3) == (4, 3)
    assert (root / "t.cpk").read_bytes() == (root / "j.cpk").read_bytes()


def test_ingest_config_reads_the_environment(monkeypatch):
    assert tm._ingest_config() == IngestConfig()
    monkeypatch.setenv("TCHVP_DECODE_THREADS", "3")
    monkeypatch.setenv("TCHVP_DECODE_CACHE_MB", "16")
    assert tm._ingest_config() == IngestConfig(decode_threads=3, cache_mb=16)
    assert jm._ingest_config().cache_mb == 16


def test_decode_cache_evicts_the_oldest_within_its_budget():
    cache = tm._DecodeCache(budget_bytes=300)
    for i in range(4):
        cache.put(i, np.zeros(100, np.uint8))
    assert cache.get(0) is None and all(cache.get(i) is not None for i in (1, 2, 3))
    cache.put("big", np.zeros(301, np.uint8))
    assert cache.get("big") is None
