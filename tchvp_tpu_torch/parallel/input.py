"""Data-parallel input: each rank reads only its slice of every global batch.

Counterpart of ``tchvp_tpu/parallel/input.py``. JAX runs one process a
host, which reads its host's slice of the batch (``host_local_batch_slice``)
and assembles the hosts' local arrays into one global ``jax.Array`` laid
out over the mesh; here every rank is a process, on whatever host, and
reads its own slice: a rank's arrays are its part of the global batch as
they are, so a loader yields this rank's block of dim 0 along the ``data``
axis, and the contiguous ranks of a host together read what JAX's process
on that host reads. The ClipPack
loader slices a shared epoch permutation (``ClipPackDataset``'s
``shard_id``/``num_shards``), so the ranks' slices concatenate to exactly
the single-process batch. With gradient accumulation a rank reads its
share of every microbatch of the global batch, in order (``microbatches``),
so that its i-th local microbatch is its part of the single process's i-th.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from tchvp_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, shard_batch


def local_rows(batch, mesh, axis: str = DATA_AXIS, microbatches: int = 1):
    """This rank's rows of a global batch (an array, a tensor, or a tuple
    or list of them) along ``axis``: its block of each of the batch's
    ``microbatches`` consecutive microbatches, concatenated in order (with
    one, :func:`~.mesh.shard_batch`)."""
    if microbatches == 1:
        return shard_batch(batch, mesh, axis)
    if isinstance(batch, (tuple, list)):
        return type(batch)(local_rows(b, mesh, axis, microbatches) for b in batch)
    n = axis_size(mesh, axis) if axis in (mesh.mesh_dim_names or ()) else 1
    if batch.shape[0] % (microbatches * n):
        raise ValueError(f"global batch {batch.shape[0]} does not split into {microbatches} microbatches "
                         f"over {axis}={n}")
    mb = batch.shape[0] // microbatches
    parts = [shard_batch(batch[k * mb:(k + 1) * mb], mesh, axis) for k in range(microbatches)]
    return torch.cat(parts) if isinstance(batch, torch.Tensor) else np.concatenate(parts)


class GlobalBatchLoader:
    """This rank's part of each batch of ``loader`` along ``axis`` of
    ``mesh``: with ``local`` the loader already yields the rank's slice (a
    sharded ClipPack), which passes as it is; else it yields global batches
    (arrays or tuples of arrays, every rank the same), of which the rank
    keeps its rows (:func:`local_rows`, its share of each of
    ``microbatches``). ``len``, ``position`` and ``seek`` are the
    loader's."""

    def __init__(self, loader: Iterable, mesh, axis: str = DATA_AXIS, local: bool = False,
                 microbatches: int = 1):
        self.loader = loader
        self.mesh = mesh
        self.axis = axis
        self.local = local
        self.microbatches = microbatches

    def __len__(self) -> int:
        return len(self.loader)  # type: ignore[arg-type]

    def __getattr__(self, name):  # position, seek: the loader's
        if name in ("position", "seek"):
            return getattr(self.loader, name)
        raise AttributeError(name)

    def __iter__(self) -> Iterator:
        for batch in self.loader:
            yield batch if self.local else local_rows(batch, self.mesh, self.axis, self.microbatches)


class _Concatenated:
    """Sharded datasets read in step: each batch is their batches, one
    each, concatenated. ``len``, ``position`` and ``seek`` are common to
    them (they share the epoch permutation and the batch count)."""

    def __init__(self, parts):
        self.parts = parts

    def __len__(self) -> int:
        return len(self.parts[0])

    def position(self) -> dict:
        return self.parts[0].position()

    def seek(self, epoch: int, batch: int = 0) -> None:
        for p in self.parts:
            p.seek(epoch, batch)

    def __iter__(self) -> Iterator:
        its = [iter(p) for p in self.parts]
        for first in its[0]:
            yield np.concatenate([first] + [next(it) for it in its[1:]])
        for it in its[1:]:
            next(it, None)  # ends each part's epoch as the first's ended


def sharded_clippack_loader(path: str, global_batch: int, mesh, axis: str = DATA_AXIS, shuffle: bool = True,
                            seed: int = 0, num_threads: int = 4, prefer_native: bool = True,
                            microbatches: int = 1) -> GlobalBatchLoader:
    """ClipPack -> this rank's loader of its slice -> its part of each global
    batch. ``global_batch`` splits evenly over ``microbatches`` and
    ``axis``; every rank shares the epoch permutation (same seed) and reads
    only its slice: with k microbatches over n ranks the global batch is k·n
    shards, of which rank i reads shards i, n + i, ... (one dataset each)."""
    from tchvp_tpu_torch.data.clippack import ClipPackDataset

    n = axis_size(mesh, axis) if axis in (mesh.mesh_dim_names or ()) else 1
    if global_batch % (n * microbatches):
        raise ValueError(f"global batch {global_batch} does not split into {microbatches} microbatches "
                         f"over {axis}={n}")
    i = mesh.get_local_rank(axis) if n > 1 else 0
    parts = [ClipPackDataset(path, batch_size=global_batch // (n * microbatches), shuffle=shuffle, seed=seed,
                             num_threads=max(1, num_threads // microbatches), prefer_native=prefer_native,
                             shard_id=k * n + i, num_shards=n * microbatches) for k in range(microbatches)]
    return GlobalBatchLoader(parts[0] if microbatches == 1 else _Concatenated(parts), mesh, axis, local=True,
                             microbatches=microbatches)
