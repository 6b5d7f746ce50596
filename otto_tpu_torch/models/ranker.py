"""The dense listwise scoring tower: the replacement for the LightGBM /
XGBoost lambdarank rerankers (reference: src/ranker/lgb_trainer.py,
xgb_trainer.py, models/lightgbm/config.yaml).

Port of ``otto_tpu/models/ranker.py``.  Candidates stay in their listwise
shape ``[sessions, C, F]`` and a small MLP scores all candidates of a batch
of sessions at once.

- :class:`RankerData` (:135), :func:`group_kfold` (:39),
  :func:`negative_sample_mask` (:283), :func:`top_k_predictions` (:399) and
  :class:`FeatureNormalizer` (:151) are numpy, copied;
- :func:`init_tower` (:53) and :class:`Tower` (``tower_forward``, :64): the
  inputs and weights rounded to ``compute_dtype`` (bfloat16), their
  products summed in float32, the bias added in float32, then relu, dropout
  on the float32 values and the rounding again; the products are float32
  matrix products of the rounded values with TF32 off, which is what the
  reference's ``preferred_element_type=float32`` dot computes;
  :func:`tower_params_from_numpy` and :func:`tower_params_to_numpy` carry the
  JAX package's ``{w0, b0, ...}`` arrays (``w{i}`` [in, out]) across;
- the losses :func:`lambdarank_loss`, :func:`listwise_softmax_loss` and
  :func:`bce_loss` (:87-127) in torch;
- :class:`RankerModel` (:183) with the reference's npz layout, so either
  package loads the other's ``ranker_<type>.npz``, and :func:`train_ranker`
  (:296-396): 5-fold GroupKFold by session (lgb_trainer.py:81-86), negative
  sampling 0.30 restricted to sessions with >= 1 positive (:117-133), AdamW
  with the reference's cosine schedule, per-fold MAP@20 and recall@20 on the
  held-out fold, fold-averaged prediction (:248-263).

JAX's draws (the initial weights, dropout) are matched in distribution only:
here they come from ``torch.Generator`` objects seeded as the reference
seeds its keys.  Everything runs on the caller's device; nothing falls back
to the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.eval.metrics import map_at_k
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.utils.runtime import full_f32_matmul, resolve_device

log = get_logger(__name__)

# The reference's tower_forward default: bfloat16 operands, float32 sums.
COMPUTE_DTYPE = torch.bfloat16
# Rows scored a batch by RankerModel.predict_rows (4,096 sessions of the
# reference's 128 candidates); predict goes through the same batches, so
# both give the same bits.
PREDICT_ROWS = 1 << 19
# optax.cosine_decay_schedule(lr, DECAY_STEPS, DECAY_ALPHA), the reference's
DECAY_STEPS, DECAY_ALPHA = 10_000, 0.1


@dataclass
class RankerData:
    """Listwise candidate features for ranking.

    features: float32 [S, C, F]; labels: int8 [S, C]; mask: bool [S, C];
    session_ids: [S]; candidates: int32 [S, C] (for emitting predictions).
    """

    features: np.ndarray
    labels: np.ndarray
    mask: np.ndarray
    session_ids: np.ndarray
    candidates: np.ndarray
    feature_names: list[str] = field(default_factory=list)


# ------------------------------------------------------------------ folds
def group_kfold(session_sizes: np.ndarray, n_folds: int) -> np.ndarray:
    """sklearn-style GroupKFold: groups sorted by size descending, greedily
    assigned to the currently smallest fold.  Returns fold id per group."""
    order = np.argsort(-session_sizes, kind="stable")
    fold_sizes = np.zeros(n_folds, np.int64)
    fold_of = np.empty(len(session_sizes), np.int32)
    for g in order:
        f = int(np.argmin(fold_sizes))
        fold_of[g] = f
        fold_sizes[f] += session_sizes[g]
    return fold_of


def negative_sample_mask(
    labels: np.ndarray, mask: np.ndarray, ratio: float, rng: np.random.Generator
) -> np.ndarray:
    """Training-candidate keep mask: all positives, plus ``ratio`` of the
    negatives in sessions that have at least one positive
    (lgb_trainer.py:117-133).  Sessions without positives are dropped."""
    has_pos = (labels * mask).sum(axis=1) > 0
    keep = mask & (labels > 0)
    negs = mask & (labels == 0) & has_pos[:, None]
    sampled = negs & (rng.random(labels.shape) < ratio)
    return keep | sampled


# ------------------------------------------------------------------ model
def init_tower(n_features: int, hidden_dims, generator: torch.Generator) -> dict:
    """He-normal weights (a standard normal times sqrt(2 / fan_in)) and zero
    biases, float32 on the CPU, drawn from ``generator``: ``w{i}`` [in, out],
    ``b{i}`` [out], the last layer one wide."""
    params = {}
    dims = [n_features, *hidden_dims, 1]
    for i in range(len(dims) - 1):
        scale = float(np.sqrt(2.0 / dims[i]))
        params[f"w{i}"] = torch.randn(dims[i], dims[i + 1], generator=generator) * scale
        params[f"b{i}"] = torch.zeros(dims[i + 1])
    return params


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held in float32 (products of the
    rounded values are then exact, their sums float32)."""
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


class Tower(nn.Module):
    """The scoring MLP (``tower_forward``): x [..., F] -> scores [...].

    Its parameters carry the JAX package's names and layout, ``w{i}`` [in,
    out] and ``b{i}`` [out].  The caller turns TF32 off on the card
    (:func:`~otto_tpu_torch.utils.runtime.full_f32_matmul`), as
    :func:`train_step` and :meth:`RankerModel.predict_rows` do.
    """

    def __init__(self, params: dict):
        super().__init__()
        self.n_layers = sum(1 for k in params if k.startswith("w"))
        for i in range(self.n_layers):
            for k in (f"w{i}", f"b{i}"):
                v = params[k]
                v = (v.detach().clone() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v, np.float32)))
                self.register_parameter(k, nn.Parameter(v.to(torch.float32)))

    def forward(self, x: torch.Tensor, *, dropout: float = 0.0,
                generator: torch.Generator | None = None,
                compute_dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
        """Dropout (on the hidden layers' float32 values, kept with
        probability ``1 - dropout`` and scaled by its inverse) draws from
        ``generator`` and is off without one."""
        h = _rounded(x, compute_dtype)
        for i in range(self.n_layers):
            h = h @ _rounded(getattr(self, f"w{i}"), compute_dtype) + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                h = torch.relu(h)
                if dropout > 0.0 and generator is not None:
                    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - dropout
                    h = torch.where(keep, h / (1.0 - dropout), 0.0)
                h = _rounded(h, compute_dtype)
        return h[..., 0]


def tower_params_from_numpy(params: dict, *, device: str | torch.device) -> Tower:
    """A :class:`Tower` on ``device`` from the JAX package's ``{w0, b0,
    ...}`` arrays (any array type numpy reads)."""
    return Tower({k: np.array(v, np.float32) for k, v in params.items()}).to(
        resolve_device(device))


def tower_params_to_numpy(tower: Tower) -> dict:
    """The tower's parameters as the JAX package's ``{w0, b0, ...}`` float32
    numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in tower.named_parameters()}


# ------------------------------------------------------------------ losses
NEG_SCORE = -1e30  # masked slots' score in the losses


def _dcg_discounts(C: int, device) -> torch.Tensor:
    return 1.0 / torch.log2(torch.arange(C, dtype=torch.float32, device=device) + 2.0)


def lambdarank_loss(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                    k: int = 20) -> torch.Tensor:
    """Pairwise logistic weighted by |delta DCG@k| of swapping the pair.

    scores/labels/mask: [B, C].  Ranks come from the current scores (a
    stable descending sort, ties to the lower column, as ``jnp.argsort``);
    the discount difference of the two positions scales each pair's
    logistic loss ``log(1 + exp(-sdiff))`` (the LambdaMART weighting)."""
    B, C = scores.shape
    s = torch.where(mask, scores, NEG_SCORE)
    order = torch.argsort(-s, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    disc = _dcg_discounts(C, scores.device)
    disc_at = torch.where(ranks < k, disc[ranks.clamp(0, C - 1)], 0.0)
    lab = labels.to(torch.float32)
    pos_pair = (lab[:, :, None] > lab[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    sdiff = s[:, :, None] - s[:, None, :]
    delta = (disc_at[:, :, None] - disc_at[:, None, :]).abs()
    pair_loss = torch.logaddexp(-sdiff, torch.zeros((), device=scores.device)) * delta
    total = torch.where(pos_pair, pair_loss, 0.0).sum()
    return total / pos_pair.sum().clamp(min=1)


def listwise_softmax_loss(scores: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Per-session cross-entropy of the positives under a softmax over the
    session's candidates, averaged over sessions with a positive."""
    s = torch.where(mask, scores, NEG_SCORE)
    logp = s - torch.logsumexp(s, dim=1, keepdim=True)
    lab = labels.to(torch.float32) * mask
    n_pos = lab.sum(dim=1)
    per_session = -(lab * logp).sum(dim=1) / n_pos.clamp(min=1)
    has_pos = n_pos > 0
    return torch.where(has_pos, per_session, 0.0).sum() / has_pos.sum().clamp(min=1)


def bce_loss(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pointwise binary cross-entropy over the masked slots, as
    ``optax.sigmoid_binary_cross_entropy``: ``-y log sigmoid(x) - (1 - y)
    log sigmoid(-x)``, each log-sigmoid a ``-logaddexp(., 0)``."""
    y = labels.to(scores.dtype)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    per = y * torch.logaddexp(-scores, zero) + (1.0 - y) * torch.logaddexp(scores, zero)
    return torch.where(mask, per, 0.0).sum() / mask.sum().clamp(min=1)


LOSSES = {"lambdarank": lambdarank_loss, "listwise_softmax": listwise_softmax_loss,
          "bce": bce_loss}


# ------------------------------------------------------------------ normalizer
@dataclass
class FeatureNormalizer:
    """Standardizer with automatic signed-log1p compression of heavy-tailed
    columns.  GBDTs are invariant to monotone transforms; MLPs are not —
    count-like features spanning orders of magnitude crush the useful signal
    into a corner of the activation range without compression."""

    mean: np.ndarray
    std: np.ndarray
    log_cols: np.ndarray  # bool [F]

    @classmethod
    def fit(cls, features: np.ndarray, mask: np.ndarray,
            log_threshold: float = 50.0) -> "FeatureNormalizer":
        flat = features[mask].astype(np.float64)
        with np.errstate(invalid="ignore"):
            max_abs = np.nanmax(np.abs(flat), axis=0)
        log_cols = np.nan_to_num(max_abs) > log_threshold
        comp = flat.copy()
        comp[:, log_cols] = np.sign(comp[:, log_cols]) * np.log1p(np.abs(comp[:, log_cols]))
        mean = np.nanmean(comp, axis=0)
        std = np.nanstd(comp, axis=0)
        return cls(mean.astype(np.float32), np.maximum(std, 1e-6).astype(np.float32), log_cols)

    def __call__(self, features: np.ndarray) -> np.ndarray:
        out = np.asarray(features, np.float32).copy()
        lc = self.log_cols
        out[..., lc] = np.sign(out[..., lc]) * np.log1p(np.abs(out[..., lc]))
        out = (out - self.mean) / self.std
        return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``__call__`` on a float32 tensor, on its device."""
        lc = torch.as_tensor(self.log_cols, device=x.device)
        out = torch.where(lc, torch.sign(x) * torch.log1p(x.abs()), x)
        out = (out - torch.as_tensor(self.mean, device=x.device)) / torch.as_tensor(
            self.std, device=x.device)
        return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


# ------------------------------------------------------------------ fold model
@dataclass
class RankerModel:
    """K-fold towers: fold-averaged ``predict`` and ``predict_rows``, npz
    ``save``/``load`` in the JAX package's layout, and ``prior_alpha`` (the
    two-stage prior blend's weight: score = scaled prior + alpha * scaled
    tower; NaN when none was selected).  ``params_per_fold`` holds each
    fold's ``{w0, b0, ...}`` as float32 numpy arrays; the towers are built
    on a device at its first use.  ``epoch_losses`` (per fold, each epoch's
    mean training loss) is filled by :func:`train_ranker` and not saved."""

    params_per_fold: list[dict]
    normalizer: FeatureNormalizer
    config: RankerConfig
    feature_names: list[str] = field(default_factory=list)
    fold_recalls: list[float] = field(default_factory=list)
    oof_recall: float = float("nan")
    prior_alpha: float = float("nan")
    epoch_losses: list[list[float]] = field(default_factory=list)
    # the fold towers, one list per device
    _towers: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def towers(self, device: str | torch.device) -> list[Tower]:
        """The fold towers on ``device`` (made once per device)."""
        dev = resolve_device(device)
        if str(dev) not in self._towers:
            self._towers[str(dev)] = [tower_params_from_numpy(p, device=dev).requires_grad_(False)
                                      for p in self.params_per_fold]
        return self._towers[str(dev)]

    def predict(self, features: np.ndarray, mask: np.ndarray, mesh=None, *,
                device: str | torch.device | None) -> np.ndarray:
        """Fold-averaged scores [S, C] (lgb_trainer.py:248-263 semantics) of
        a float32 [S, C, F] feature tensor, -inf where ``mask`` is False: the
        rows cross to ``device`` once and :meth:`predict_rows` scores them.

        With ``mesh`` (every rank calls with the same arguments and
        ``device`` its own or None), each rank scores its slice of the
        sessions over the mesh's ``data`` axis and the slices are gathered:
        every rank returns all the scores."""
        S, C, F = features.shape
        feats = np.ascontiguousarray(features, np.float32)
        if mesh is None:
            x = torch.as_tensor(feats.reshape(S * C, F), device=resolve_device(device))
            scores = self.predict_rows(x).cpu().numpy().reshape(S, C)
            return np.where(mask, scores, -np.inf)
        from otto_tpu_torch.parallel.mesh import data_slice, gather_batch, rank_device

        dev = rank_device(mesh, device)
        sl, _ = data_slice(mesh, S)
        part = feats[sl]
        if len(part) < sl.stop - sl.start:  # the last slices pad with zero rows
            part = np.concatenate([part, np.zeros((sl.stop - sl.start - len(part), C, F),
                                                  np.float32)])
        x = torch.as_tensor(part.reshape(-1, F), device=dev)
        scores = gather_batch(mesh, self.predict_rows(x).reshape(-1, C), S)
        return np.where(mask, scores.cpu().numpy(), -np.inf)

    @torch.no_grad()
    def predict_rows(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        """Fold-averaged scores float32 [N] of float32 feature rows [N, F] on
        their device: normalised there, each fold's tower in bfloat16
        compute, the folds summed in order and divided by their count, in
        batches of ``PREDICT_ROWS`` rows.  ``stats`` is the forest's
        interface (its binning seconds); a tower bins nothing."""
        towers = self.towers(x.device)
        out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        with full_f32_matmul():
            for start in range(0, x.shape[0], PREDICT_ROWS):
                xb = self.normalizer.apply(x[start:start + PREDICT_ROWS])
                acc = None
                for tower in towers:
                    s = tower(xb)
                    acc = s if acc is None else acc + s
                out[start:start + PREDICT_ROWS] = acc / len(towers)
        return out

    def save(self, path) -> None:
        """The ``.npz`` that ``otto_tpu``'s ``RankerModel.save`` writes."""
        flat = {}
        for i, p in enumerate(self.params_per_fold):
            for k, v in p.items():
                flat[f"fold{i}_{k}"] = np.asarray(v)
        np.savez_compressed(
            path, __n_folds=len(self.params_per_fold),
            __mean=self.normalizer.mean, __std=self.normalizer.std,
            __logcols=self.normalizer.log_cols,
            __features=np.asarray(self.feature_names, dtype=object),
            __fold_recalls=np.asarray(self.fold_recalls, np.float64),
            __oof=np.float64(self.oof_recall),
            __prior_alpha=np.float64(self.prior_alpha),
            **flat,
        )

    @classmethod
    def load(cls, path, config: RankerConfig = RankerConfig()) -> "RankerModel":
        """Read an ``.npz`` written by either package's ``save``."""
        with np.load(path, allow_pickle=True) as z:
            params = []
            for i in range(int(z["__n_folds"])):
                prefix = f"fold{i}_"
                params.append({k[len(prefix):]: np.asarray(z[k], np.float32)
                               for k in z.files if k.startswith(prefix)})
            return cls(
                params,
                FeatureNormalizer(z["__mean"], z["__std"], z["__logcols"]),
                config,
                feature_names=[str(f) for f in z["__features"]] if "__features" in z.files else [],
                fold_recalls=list(z["__fold_recalls"]) if "__fold_recalls" in z.files else [],
                oof_recall=float(z["__oof"]) if "__oof" in z.files else float("nan"),
                prior_alpha=(float(z["__prior_alpha"]) if "__prior_alpha" in z.files
                             else float("nan")),
            )


# ------------------------------------------------------------------ trainer
def learning_rate(config: RankerConfig, t: int) -> float:
    """The learning rate of update ``t`` (from 0):
    ``optax.cosine_decay_schedule(lr, 10_000, 0.1)``."""
    frac = min(t, DECAY_STEPS) / DECAY_STEPS
    return config.learning_rate * ((1.0 - DECAY_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * frac))
                                   + DECAY_ALPHA)


def make_optimizer(tower: Tower, config: RankerConfig) -> torch.optim.AdamW:
    """``optax.adamw`` as the reference builds it: b1 0.9, b2 0.999, eps
    1e-8, ``weight_decay`` on every parameter; :func:`train_step` sets the
    learning rate of each update."""
    return torch.optim.AdamW(tower.parameters(), lr=config.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=config.weight_decay)


def train_step(tower: Tower, optimizer: torch.optim.Optimizer, x: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor, lr: float, *, loss: str,
               dropout: float = 0.0, generator: torch.Generator | None = None,
               compute_dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
    """One update of ``tower`` on a batch ([B, C, F] rows, [B, C] labels and
    keep mask) at learning rate ``lr``: the loss of ``LOSSES[loss]`` and its
    gradient, then the optimizer's step.  Returns the loss before the update
    (a 0-d tensor on the batch's device; nothing is read back)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    with full_f32_matmul():
        value = LOSSES[loss](tower(x, dropout=dropout, generator=generator,
                                   compute_dtype=compute_dtype), labels, mask)
        value.backward()
    optimizer.step()
    return value.detach()


def train_ranker(
    data: RankerData,
    config: RankerConfig = RankerConfig(),
    eval_recall=None,
    *,
    device: str | torch.device,
) -> tuple[RankerModel, np.ndarray]:
    """K-fold training on ``device``; returns the model and the OOF scores
    [S, C] (-inf where the mask is False).

    The features go to ``device`` once and are normalised there
    (:class:`FeatureNormalizer`, fit on the host).  One
    ``np.random.default_rng(config.seed)`` stream draws each fold's
    negative-sampling mask and then its epochs' permutations, so the folds,
    keep masks and batch order equal the reference's.  Each fold's tower is
    initialised from a generator seeded ``config.seed + fold`` and its
    dropout draws from another so seeded on ``device``.  An epoch takes
    ``max(n_train // batch_sessions, 1)`` steps; a batch short of
    ``batch_sessions`` is padded with its own head.  Each fold then scores
    its held-out sessions (OOF), reports MAP@20 there and, with
    ``eval_recall(session_indices, scores) -> float``, its recall@20 (and
    ``oof_recall`` over all sessions).  No early stopping, as in the
    reference."""
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    S, C, F = data.features.shape
    normalizer = FeatureNormalizer.fit(data.features, data.mask)
    x_all = normalizer.apply(torch.as_tensor(np.ascontiguousarray(data.features, np.float32),
                                             device=dev))
    labels = torch.as_tensor(data.labels, device=dev)
    mask = torch.as_tensor(data.mask, device=dev)
    fold_of = group_kfold(data.mask.sum(axis=1), config.n_folds)
    B = config.batch_sessions

    oof = torch.zeros((S, C), dtype=torch.float32, device=dev)
    params_per_fold, fold_recalls, epoch_losses = [], [], []
    for fold in range(config.n_folds):
        val_sessions = np.flatnonzero(fold_of == fold)
        train_sessions = np.flatnonzero(fold_of != fold)
        keep = negative_sample_mask(data.labels[train_sessions], data.mask[train_sessions],
                                    config.negative_sampling_ratio, rng)
        usable = keep.sum(axis=1) > 0
        train_sessions = train_sessions[usable]
        keep = torch.as_tensor(keep[usable], device=dev)

        tower = Tower(init_tower(F, config.hidden_dims,
                                 torch.Generator().manual_seed(config.seed + fold))).to(dev)
        optimizer = make_optimizer(tower, config)
        dropout_gen = torch.Generator(device=dev).manual_seed(config.seed + fold)
        n_train = len(train_sessions)
        n_steps = max(n_train // B, 1)
        t = 0
        epoch_losses.append([])
        for _ in range(config.epochs):
            order = rng.permutation(n_train)
            sels = []
            for i in range(n_steps):
                sel = order[i * B:(i + 1) * B]
                if len(sel) < B:  # pad to the batch shape with the batch's own head
                    sel = np.concatenate([sel, sel[:B - len(sel)]])
                sels.append(sel)
            sels = np.stack(sels)  # every batch of an epoch has one length
            sel_dev = torch.as_tensor(sels, device=dev)
            sidx_dev = torch.as_tensor(train_sessions[sels], device=dev)
            losses = []
            for i in range(n_steps):
                sidx = sidx_dev[i]
                losses.append(train_step(
                    tower, optimizer, x_all[sidx], labels[sidx], keep[sel_dev[i]],
                    learning_rate(config, t), loss=config.loss, dropout=config.dropout,
                    generator=dropout_gen))
                t += 1
            epoch_losses[-1].append(float(torch.stack(losses).mean()))
        # validation-fold scores
        val = torch.as_tensor(val_sessions, device=dev)
        with torch.no_grad(), full_f32_matmul():
            for start in range(0, len(val_sessions), 4096):
                sl = val[start:start + 4096]
                oof[sl] = tower(x_all[sl])
        params_per_fold.append(tower_params_to_numpy(tower))
        # MAP@20 on the held-out fold: the reference GBDTs' eval metric
        # (models/lightgbm/config.yaml:94-96)
        fold_map = float(map_at_k(oof[val], labels[val].to(torch.int32), mask[val], k=20))
        if eval_recall is not None:
            r = eval_recall(val_sessions, np.where(data.mask[val_sessions],
                                                   oof[val].cpu().numpy(), -np.inf))
            fold_recalls.append(float(r))
            log.info("fold %d: loss %.4f recall@20 %.6f map@20 %.6f",
                     fold, epoch_losses[-1][-1], r, fold_map)
        else:
            log.info("fold %d: loss %.4f map@20 %.6f", fold, epoch_losses[-1][-1], fold_map)

    oof = np.where(data.mask, oof.cpu().numpy(), -np.inf)
    model = RankerModel(params_per_fold, normalizer, config, list(data.feature_names),
                        fold_recalls, epoch_losses=epoch_losses)
    if eval_recall is not None:
        model.oof_recall = float(eval_recall(np.arange(S), oof))
        log.info("OOF recall@20 %.6f", model.oof_recall)
    return model, oof


def top_k_predictions(candidates: np.ndarray, scores: np.ndarray, k: int = 20) -> np.ndarray:
    """Per-session top-k candidates by score: [S, C] -> [S, k] padded -1
    (a stable argsort of ``-scores``: ties keep candidate order)."""
    S, C = candidates.shape
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    rows = np.arange(S)[:, None]
    out = candidates[rows, order]
    picked_scores = scores[rows, order]
    return np.where(np.isfinite(picked_scores), out, -1).astype(np.int32)
