"""Host-to-device batch pipeline.

Port of ``otto_tpu/data/loader.py``: batches are sliced from host arrays in
a given row order and shipped to the device, the remainder dropped or
wrapped to full size.  The JAX loader prefetches on a background thread
because a dispatch there waits for its inputs; here every launch is queued
asynchronously and a batch goes up by one pinned, non-blocking copy, so the
host already slices the next batch while the card runs the last one and a
thread would only add contention for the interpreter lock.  JAX's
``sharding=`` becomes ``mesh=`` and ``data_axis=``: each rank slices and
ships only its block of each batch.
"""

from __future__ import annotations

import numpy as np
import torch


class BatchLoader:
    """Iterate fixed-shape batches of ``arrays`` on ``device``.

    - ``order``: explicit row order (e.g. an epoch permutation); default
      sequential.  The remainder batch is dropped when ``drop_remainder`` or
      wrapped to full size (tiled as often as needed when the batch exceeds
      the epoch).
    - ``transform``: host-side callable applied to each batch tuple before
      the copy; returns the tuple of arrays to ship (one array, e.g. the
      batch's columns stacked, ships as one copy).

    - ``mesh``: a :func:`otto_tpu_torch.parallel.make_mesh` mesh (every rank
      builds the loader with the same arguments): each batch splits over its
      ``data_axis`` and this rank ships only its block (``batch_size`` must
      divide by the axis size), which it yields as a ``DTensor`` sharded over
      that axis (global shape ``[batch_size, ...]``, the counterpart of the
      reference's ``NamedSharding(mesh, P('data'))``); ``device`` is the
      rank's own or None.  A ``transform`` then runs on the rank's rows.

    ``len()`` is the number of batches; each iteration slices anew.
    """

    def __init__(self, arrays, batch_size: int, *, order: np.ndarray | None = None,
                 drop_remainder: bool = True, transform=None, mesh=None,
                 data_axis: str = "data", device: str | torch.device | None):
        self._arrays = tuple(arrays)
        n = len(self._arrays[0])
        for a in self._arrays[1:]:
            if len(a) != n:
                raise ValueError("arrays must share their leading dimension")
        self._order = np.arange(n) if order is None else np.asarray(order)
        n = len(self._order)
        self._B = batch_size
        if drop_remainder:
            self._n_batches = max(n // batch_size, 1) if n else 0
        else:
            self._n_batches = -(-n // batch_size) if n else 0
        self._transform = transform
        self._mesh, self._axis, self._rows = mesh, data_axis, slice(0, batch_size)
        if mesh is None:
            if device is None:
                raise ValueError("BatchLoader: device is None without a mesh")
            self._device = torch.device(device)
        else:
            from otto_tpu_torch.parallel.mesh import axis_size, data_slice, rank_device

            self._device = rank_device(mesh, device)
            if batch_size % axis_size(mesh, data_axis):
                raise ValueError(f"BatchLoader: batch_size {batch_size} does not split over "
                                 f"the {axis_size(mesh, data_axis)} ranks of {data_axis!r}")
            self._rows = data_slice(mesh, batch_size, data_axis)[0]

    def __len__(self) -> int:
        return self._n_batches

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device.type == "cpu":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def __iter__(self):
        B = self._B
        n = len(self._order)
        for i in range(self._n_batches):
            sel = self._order[i * B:(i + 1) * B]
            if len(sel) < B:  # wrap to keep every batch the same shape
                reps = -(-(B - len(sel)) // max(n, 1))
                sel = np.concatenate([sel] + [self._order] * reps)[:B]
            sel = sel[self._rows]
            host = tuple(a[sel] for a in self._arrays)
            if self._transform is not None:
                host = self._transform(*host)
            batch = tuple(self._put(a) for a in host)
            if self._mesh is not None:
                batch = tuple(self._sharded(t) for t in batch)
            yield batch

    def _sharded(self, block: torch.Tensor):
        from torch.distributed.tensor import DTensor

        from otto_tpu_torch.parallel.mesh import batch_sharded

        return DTensor.from_local(block, self._mesh, batch_sharded(self._mesh, self._axis),
                                  run_check=False)
