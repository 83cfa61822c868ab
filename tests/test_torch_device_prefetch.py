"""The port's DevicePrefetch against the JAX package's contract, on the CPU.

With ``device="cpu"`` the wrapper yields the inner dataset's stream as
tensors, reports ``position()`` as the inner position minus the batches it
still holds (near the epoch end too), mirrors the inner dataset's
``position``/``seek`` under ``hasattr``, refuses a seek mid-iteration, and
places nested (image, mask) batches leaf by leaf. The JAX wrapper, given
the same inner datasets, reports the same positions. Asking for
``device="cuda"`` where there is no card raises. The copy stream, pinned
memory and events are exercised on the card by ``chip_smoke.py`` phase 15.
"""

import numpy as np
import pytest
import torch

from tchvp_tpu.data import device_prefetch as jdp
from tchvp_tpu.data.synthetic import SyntheticImageMasks as JaxImageMasks
from tchvp_tpu_torch.data import clippack as tcp
from tchvp_tpu_torch.data.device_prefetch import DevicePrefetch
from tchvp_tpu_torch.data.synthetic import SyntheticClips, SyntheticImageMasks


def _cpu(data, size=2, **kw):
    return DevicePrefetch(data, size=size, device="cpu", **kw)


class _Positionable:
    """The repo's position contract: counts pulls from its iterator, and
    normalizes the epoch-final position to (epoch + 1, 0)."""

    def __init__(self, spe=5):
        self.spe, self.epoch, self.consumed = spe, 0, 0

    def __len__(self):
        return self.spe

    def __iter__(self):
        self.consumed = 0
        for i in range(self.spe):
            self.consumed = i + 1
            yield np.full((2, 2), i, np.float32)
        self.epoch += 1
        self.consumed = 0

    def position(self):
        if self.consumed >= self.spe:
            return {"epoch": self.epoch + 1, "batch": 0}
        return {"epoch": self.epoch, "batch": self.consumed}

    def seek(self, epoch, batch=0):
        self.epoch, self.consumed = epoch, batch


@pytest.mark.parametrize("size", [1, 2, 8])
def test_yields_the_inner_stream_as_tensors(size):
    mk = lambda: SyntheticClips(2, 3, 8, num_batches=5, seed=3)  # noqa: E731
    wrapped = _cpu(mk(), size)
    got = list(wrapped)
    assert len(got) == len(wrapped) == 5
    for g, want in zip(got, mk()):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.uint8 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), want)


def test_nested_batches_are_placed_leaf_by_leaf():
    got = list(_cpu(SyntheticImageMasks(2, 8, 3, seed=1)))
    for (img, mask), (want_img, want_mask) in zip(got, JaxImageMasks(2, 8, 3, seed=1)):
        assert isinstance(img, torch.Tensor) and isinstance(mask, torch.Tensor)
        np.testing.assert_array_equal(img.numpy(), want_img)
        np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_place_is_the_callers_when_given():
    got = list(_cpu(SyntheticClips(1, 1, 4, num_batches=2), place=lambda b: ("placed", b.shape)))
    assert got == [("placed", (1, 1, 4, 4, 3))] * 2


@pytest.mark.parametrize("size", [1, 2, 3])
def test_position_subtracts_held_lookahead_as_jax_does(size):
    ours, theirs = _cpu(_Positionable(5), size), jdp.DevicePrefetch(_Positionable(5), size=size)
    assert ours.position() == theirs.position() == {"epoch": 0, "batch": 0}
    seen = []
    for a, b in zip(ours, theirs):
        seen.append(int(a[0, 0]))
        assert int(np.asarray(b)[0, 0]) == seen[-1]
        want = {"epoch": 0 if seen[-1] + 1 < 5 else 1, "batch": (seen[-1] + 1) % 5}
        assert ours.position() == theirs.position() == want
    assert seen == [0, 1, 2, 3, 4]
    assert ours.position() == {"epoch": 1, "batch": 0}


def test_position_near_epoch_end_with_held_batches():
    data = _Positionable(spe=3)
    wrapped = _cpu(data, 2)
    it = iter(wrapped)
    assert int(next(it)[0, 0]) == 0
    assert data.position() == {"epoch": 1, "batch": 0}  # the inner one ran to its end
    assert wrapped.position() == {"epoch": 0, "batch": 1}


def test_position_over_a_clippack_mid_epoch(tmp_path):
    path = str(tmp_path / "c.cpk")
    tcp.pack_clips(path, np.random.default_rng(0).integers(0, 256, (12, 1, 2, 2, 3), dtype=np.uint8))
    inner = tcp.ClipPackDataset(path, batch_size=2, prefer_native=False)
    wrapped = _cpu(inner, 2)
    for i, _ in enumerate(wrapped):
        assert inner.position()["batch"] == min(i + 3, 6) % 6
        assert wrapped.position() == {"epoch": 0 if i < 5 else 1, "batch": (i + 1) % 6}


def test_hasattr_mirrors_the_inner_dataset():
    assert not hasattr(_cpu(SyntheticClips(1, 1, 4, num_batches=2)), "position")
    assert not hasattr(_cpu(SyntheticClips(1, 1, 4, num_batches=2)), "seek")
    wrapped = _cpu(_Positionable())
    assert hasattr(wrapped, "position") and hasattr(wrapped, "seek")


def test_seek_guard_and_delegation():
    data = _Positionable(spe=5)
    wrapped = _cpu(data)
    wrapped.seek(2, 3)
    assert data.position() == {"epoch": 2, "batch": 3}
    it = iter(wrapped)
    next(it)
    with pytest.raises(RuntimeError, match="seek during iteration"):
        wrapped.seek(0)
    it.close()
    assert wrapped.position() == data.position()  # nothing held after abandoning
    wrapped.seek(0)


def test_validation_and_missing_device():
    with pytest.raises(ValueError):
        _cpu(_Positionable(), 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            DevicePrefetch(_Positionable())
        with pytest.raises(RuntimeError, match="not available"):
            DevicePrefetch(_Positionable(), device="cuda")
