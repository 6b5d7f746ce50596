"""Matrix-factorization and collaborative-filtering embedding models.

Port of ``otto_tpu/models/matrix_factorization.py`` (the reference's torch
stack: src/matrix_factorization/torch_modules.py:4-38, torch_trainer.py):

- **CollaborativeFiltering**: one shared aid table; score = dot(e[x1], e[x2]);
  BCE-with-logits on pair labels.  Pair datasets (numpy, copied, bit-equal
  to the JAX package's for the same generator): 'diff' — positives are
  next-aid pairs, negatives in-session shuffles (torch_trainer.py:229-255);
  'time' — session self-join with label = (0 < dt <= hour_difference)
  aggregated per pair (:198-226).
- **MatrixFactorization**: session table x aid table; MSE regression of the
  event-type value (samples are raw (session, aid, type) rows,
  torch_trainer.py:278-289).

Training is the reference's sparse path (both trainers pass
``sparse_lookups``; its dense optax branch is unreachable and not ported):
a step gathers the batch's rows, forms the closed-form gradient and applies
per-coordinate adagrad to the looked-up rows only, every duplicate's square
added to the accumulator before any row is scaled, with ``index_add_``; the
learning rate is optax's float32 exponential staircase over the steps of
all epochs; early stopping on the validation loss keeps the best epoch's
tables (a copy: the port updates its tables in place).  The step losses are
read back once an epoch.

The numpy draws (pairs, the validation split, one permutation an epoch)
keep the reference's order, so splits and batches are bit-equal; the
initial tables come from a ``torch.Generator`` seeded ``config.seed``
(:func:`init_tables`), equal to the reference's in distribution only.
Float ``index_add_`` on CUDA adds duplicate rows with atomics in no fixed
order, so a run on the card is not bit-reproducible; on the CPU it is.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from otto_tpu_torch.config import CFConfig, MFConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.loader import BatchLoader
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.embeddings import _adagrad
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)


# ---------------------------------------------------------------- pair data
def cf_pairs_diff(store: EventStore, rng: np.random.Generator):
    """'diff' strategy: positives (aid_i, aid_{i+1}); negatives (aid_i,
    in-session shuffled aid); both deduped; same-aid pairs dropped."""
    sidx = store.session_idx
    aid = store.aid.astype(np.int64)
    same_sess = sidx[:-1] == sidx[1:]

    x1_pos = aid[:-1][same_sess]
    x2_pos = aid[1:][same_sess]

    # in-session shuffle: a random permutation *within* each session block
    # (events are session-contiguous, so lexsort by (session, random) pairs
    # each position with a random same-session event)
    r = rng.random(store.n_events)
    order = np.lexsort((r, sidx))
    x3 = aid[order]

    keep_pos = (x1_pos != x2_pos)
    pos = np.stack([x1_pos[keep_pos], x2_pos[keep_pos]], axis=1)
    pos = np.unique(pos, axis=0)

    x1_neg = aid
    keep_neg = x1_neg != x3
    neg = np.stack([x1_neg[keep_neg], x3[keep_neg]], axis=1)
    neg = np.unique(neg, axis=0)

    x = np.concatenate([pos, neg], axis=0)
    y = np.concatenate([np.ones(len(pos), np.float32), np.zeros(len(neg), np.float32)])
    # positive label wins on duplicates (reference concatenates pos first and
    # dedups on (x1, x2))
    _, first_idx = np.unique(x, axis=0, return_index=True)
    return x[first_idx, 0].astype(np.int32), x[first_idx, 1].astype(np.int32), y[first_idx]


def cf_pairs_time(
    store: EventStore,
    rng: np.random.Generator,
    hour_difference: float = 1.0,
    sample_frac: float = 0.15,
    target_aggregation: str = "mean",
):
    """'time' strategy: sampled session self-join; pair target = mean/max of
    (0 < dt <= hour_difference) over co-occurrences."""
    keep = rng.random(store.n_events) < sample_frac
    sidx = store.session_idx[keep]
    aid = store.aid[keep].astype(np.int64)
    ts = store.ts[keep]

    # self-join per session via offsets over the kept subset
    uniq, inv, counts = np.unique(sidx, return_inverse=True, return_counts=True)
    order = np.argsort(inv, kind="stable")
    aid, ts, inv = aid[order], ts[order], inv[order]

    xs, ys, tg = [], [], []
    # vectorized per-offset pairing (sessions are short; offsets bounded)
    max_len = counts.max() if len(counts) else 0
    for d in range(1, int(max_len)):
        valid = inv[:-d] == inv[d:]
        a_x, a_y = aid[:-d][valid], aid[d:][valid]
        dt_f = (ts[d:][valid] - ts[:-d][valid]) / 3600.0
        dt_b = -dt_f
        for ax, ay, dt in ((a_x, a_y, dt_f), (a_y, a_x, dt_b)):
            ok = ax != ay
            xs.append(ax[ok])
            ys.append(ay[ok])
            tg.append(((dt[ok] > 0) & (dt[ok] <= hour_difference)).astype(np.float32))
    if not xs:
        return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.float32),)
    x1 = np.concatenate(xs)
    x2 = np.concatenate(ys)
    t = np.concatenate(tg)
    key = x1 * (store.aid.max() + 1) + x2
    order = np.argsort(key, kind="stable")
    key, x1, x2, t = key[order], x1[order], x2[order], t[order]
    head = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.flatnonzero(head)
    sums = np.add.reduceat(t, starts)
    cnts = np.diff(np.concatenate([starts, [len(t)]]))
    if target_aggregation == "mean":
        target = (sums / cnts >= 0.5).astype(np.float32)
    elif target_aggregation == "max":
        target = (sums > 0).astype(np.float32)
    else:
        raise ValueError(target_aggregation)
    return x1[starts].astype(np.int32), x2[starts].astype(np.int32), target


def mf_samples(store: EventStore):
    """(session_idx, aid, target=event type) rows (torch_trainer.py:278-289).
    Sessions are compact indices into the session table."""
    return (
        store.session_idx.astype(np.int32),
        store.aid.astype(np.int32),
        store.type.astype(np.float32),
    )


# ------------------------------------------------------------------- models
@dataclass
class EmbeddingModelState:
    params: dict
    best_params: dict | None = None
    history: list = field(default_factory=list)


def init_tables(shapes: dict[str, tuple[int, int]], seed: int) -> dict[str, torch.Tensor]:
    """The initial tables, normal x 0.05 as the reference draws them,
    float32 on the CPU, in the order of ``shapes`` from one
    ``torch.Generator`` seeded ``seed`` (so a card run and a CPU run start
    from the same tables).  Tests replace it to feed the JAX package's
    draws."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(shape, generator=gen).mul_(0.05) for k, shape in shapes.items()}


def lr_at(config: MFConfig | CFConfig, step: int) -> float:
    """``optax.exponential_decay(learning_rate, lr_decay_steps,
    lr_decay_rate, staircase=True)`` at ``step``, in float32 as the
    reference evaluates it: ``learning_rate`` up to step 0, then
    ``learning_rate * rate ** floor(step / steps)``; a float32 denormal is
    flushed to 0, as XLA flushes it."""
    init = np.float32(config.learning_rate)
    if step <= 0:
        return float(init)
    p = np.float32(np.floor(step / config.lr_decay_steps))
    lr = init * np.power(np.float32(config.lr_decay_rate), p)
    return float(lr) if abs(lr) >= np.finfo(np.float32).tiny else 0.0


def _dot_score(e1, e2):
    return (e1 * e2).sum(dim=-1)


def _pair_forward(tables, x1, x2):
    e = tables["embeddings"]
    return _dot_score(e[x1], e[x2])


def _mf_forward(tables, sessions, aids):
    return _dot_score(tables["session_embeddings"][sessions], tables["aid_embeddings"][aids])


def _make_loss(loss: str) -> Callable:
    if loss == "bce":  # optax.sigmoid_binary_cross_entropy's form
        return lambda logits, y: (-y * F.logsigmoid(logits)
                                  - (1.0 - y) * F.logsigmoid(-logits)).mean()
    if loss == "mse":
        return lambda logits, y: ((logits - y) ** 2).mean()
    raise ValueError(loss)


def sparse_step(tables: dict, accs: dict, lookups, loss: str, lr: float, *batch) -> torch.Tensor:
    """One step on ``batch`` (its index columns and the targets last):
    gather the rows of the two ``lookups`` ``((table, column), (table,
    column))``, the closed-form gradient of the mean loss (BCE:
    ``(sigmoid(l) - y) / B``; MSE: ``2 (l - y) / B``), then adagrad on the
    looked-up rows in place.  Two lookups into one table (CF) share its
    accumulator: both gradients come from the rows before the step, both
    squares go in before either update.  Returns the batch's loss on the
    device (``_train_epochs``' ``sparse_step``, reference :215-238)."""
    (k1, p1), (k2, p2) = lookups
    i1, i2, y = batch[p1], batch[p2], batch[-1]
    e1 = tables[k1][i1]
    e2 = tables[k2][i2]
    logits = _dot_score(e1, e2)
    value = _make_loss(loss)(logits, y)
    B = y.shape[0]
    if loss == "bce":
        dl = (torch.sigmoid(logits) - y) / B
    else:  # mse: d mean((l-y)^2) / dl
        dl = 2.0 * (logits - y) / B
    g1 = dl[:, None] * e2
    g2 = dl[:, None] * e1
    if k1 == k2:
        _adagrad(tables[k1], accs[k1], lr, [(i1, g1), (i2, g2)])
    else:
        _adagrad(tables[k1], accs[k1], lr, [(i1, g1)])
        _adagrad(tables[k2], accs[k2], lr, [(i2, g2)])
    return value


def _train_epochs(
    tables: dict[str, torch.Tensor],
    forward,
    loss_name: str,
    data: tuple[np.ndarray, ...],
    batch_size: int,
    epochs: int,
    patience: int,
    rng: np.random.Generator,
    lookups,
    lr_schedule,
    *,
    device: torch.device,
    val_fraction: float = 0.05,
    log_prefix: str = "model",
):
    """The reference's protocol (:171-277) on its sparse path: a validation
    split, one permutation an epoch through a ``BatchLoader`` (the short
    epoch wrapped into one full batch), the lr of the global step,
    early stopping when the validation loss fails to improve by 1e-7 for
    ``patience`` epochs.  ``tables`` (on the CPU) are copied to ``device``
    and trained there; returns (the best epoch's tables, or ``tables``
    when no epoch improved, history, the validation columns on the
    device, the steps taken)."""
    loss_fn = _make_loss(loss_name)
    n = len(data[0])
    perm = rng.permutation(n)
    n_val = max(int(n * val_fraction), 1)
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    train = tuple(d[train_idx] for d in data)
    val = tuple(torch.as_tensor(d[val_idx], device=device) for d in data)

    state = {k: t.to(device, copy=True) for k, t in tables.items()}
    accs = {k: torch.zeros_like(state[k]) for k in dict.fromkeys(k for k, _ in lookups)}

    best_val = np.inf
    best = None
    bad_epochs = 0
    history = []
    global_step = 0
    for epoch in range(epochs):
        order = rng.permutation(len(train[0]))
        tl = []
        for batch in BatchLoader(train, batch_size, order=order, device=device):
            tl.append(sparse_step(state, accs, lookups, loss_name, lr_schedule(global_step),
                                  *batch))
            global_step += 1
        train_loss = float(torch.stack(tl).to(torch.float64).mean())
        vl = float(loss_fn(forward(state, *val[:-1]), val[-1]))
        history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": vl})
        log.info("%s epoch %d: train %.5f val %.5f", log_prefix, epoch, train_loss, vl)
        if vl < best_val - 1e-7:
            best_val, bad_epochs = vl, 0
            if best is None:
                best = {k: t.clone() for k, t in state.items()}
            else:
                for k, t in state.items():
                    best[k].copy_(t)
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                log.info("%s: early stopping at epoch %d (best val %.5f)", log_prefix, epoch,
                         best_val)
                break
    return (tables if best is None else best), history, val, global_step


def _record(stats_out: dict | None, t0: float, pairs_s: float, n: int, steps: int,
            val) -> None:
    if stats_out is not None:
        stats_out.update({"pairs_s": pairs_s, "train_s": time.perf_counter() - t0,
                          "samples": n, "steps": steps,
                          "val": tuple(v.cpu().numpy() for v in val)})


@dataclass
class CFModel:
    embeddings: np.ndarray  # [n_aids, d]
    config: CFConfig
    history: list = field(default_factory=list)

    def score_pairs(self, x1, x2):
        e = self.embeddings
        return np.sum(e[x1] * e[x2], axis=-1)

    def save(self, path):
        np.savez_compressed(path, embeddings=self.embeddings)

    @classmethod
    def load(cls, path, config=CFConfig()):
        return cls(np.load(path)["embeddings"], config)


@dataclass
class MFModel:
    session_embeddings: np.ndarray
    aid_embeddings: np.ndarray
    config: MFConfig
    history: list = field(default_factory=list)

    def save(self, path):
        np.savez_compressed(
            path, session_embeddings=self.session_embeddings, aid_embeddings=self.aid_embeddings
        )

    @classmethod
    def load(cls, path, config=MFConfig()):
        z = np.load(path)
        return cls(z["session_embeddings"], z["aid_embeddings"], config)


def train_cf(store: EventStore, n_aids: int, config: CFConfig = CFConfig(), *,
             device: str | torch.device, stats_out: dict | None = None) -> CFModel:
    """Train the CF table on ``device``.  ``stats_out`` receives the host's
    pair-building seconds, ``train_s`` (initial tables to trained ones on
    the host), the sample count, the steps taken and the validation
    columns (x1, x2, y)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(config.seed)
    if config.sampling_strategy == "diff":
        x1, x2, y = cf_pairs_diff(store, rng)
    elif config.sampling_strategy == "time":
        x1, x2, y = cf_pairs_time(store, rng, hour_difference=config.hour_difference)
    else:
        raise ValueError(config.sampling_strategy)
    log.info("cf pairs: %d (%.2f%% positive)", len(y), 100 * y.mean() if len(y) else 0.0)
    t1 = time.perf_counter()

    tables = init_tables({"embeddings": (n_aids, config.n_factors)}, config.seed)
    best, history, val, steps = _train_epochs(
        tables,
        _pair_forward,
        config.loss,
        (x1, x2, y),
        config.batch_size,
        config.epochs,
        config.early_stopping_patience,
        rng,
        (("embeddings", 0), ("embeddings", 1)),
        partial(lr_at, config),
        device=dev,
        log_prefix="cf",
    )
    model = CFModel(best["embeddings"].cpu().numpy(), config, history)
    _record(stats_out, t1, t1 - t0, len(y), steps, val)
    return model


def train_mf(store: EventStore, n_aids: int, config: MFConfig = MFConfig(), *,
             device: str | torch.device, stats_out: dict | None = None) -> MFModel:
    """Train the session and aid tables on ``device`` (``stats_out`` as
    :func:`train_cf`'s; the validation columns are (session, aid,
    target))."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(config.seed)
    sessions, aids, target = mf_samples(store)
    t1 = time.perf_counter()
    tables = init_tables({"session_embeddings": (store.n_sessions, config.n_factors),
                          "aid_embeddings": (n_aids, config.n_factors)}, config.seed)
    best, history, val, steps = _train_epochs(
        tables,
        _mf_forward,
        config.loss,
        (sessions, aids, target),
        config.batch_size,
        config.epochs,
        config.early_stopping_patience,
        rng,
        (("session_embeddings", 0), ("aid_embeddings", 1)),
        partial(lr_at, config),
        device=dev,
        log_prefix="mf",
    )
    model = MFModel(best["session_embeddings"].cpu().numpy(),
                    best["aid_embeddings"].cpu().numpy(), config, history)
    _record(stats_out, t1, t1 - t0, len(target), steps, val)
    return model
