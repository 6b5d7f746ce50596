"""Host-to-device batch pipeline.

Port of ``otto_tpu/data/loader.py``: batches are sliced from host arrays in
a given row order and shipped to the device, the remainder dropped or
wrapped to full size.  The JAX loader prefetches on a background thread
because a dispatch there waits for its inputs; here every launch is queued
asynchronously and a batch goes up by one pinned, non-blocking copy, so the
host already slices the next batch while the card runs the last one and a
thread would only add contention for the interpreter lock.  There is no
``sharding`` argument: the port trains on one card.
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

    ``len()`` is the number of batches; each iteration slices anew.
    """

    def __init__(self, arrays, batch_size: int, *, order: np.ndarray | None = None,
                 drop_remainder: bool = True, transform=None,
                 device: str | torch.device):
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
        self._device = torch.device(device)

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
            host = tuple(a[sel] for a in self._arrays)
            if self._transform is not None:
                host = self._transform(*host)
            yield tuple(self._put(a) for a in host)
