"""Typed configuration for the ported slice.

Copied from ``otto_tpu/config.py`` (no jax inside): the config base,
:class:`DataConfig`, :class:`SGNSConfig`, ``COVISIT_KINDS``,
:class:`CovisitConfig` and :class:`GBDTConfig` (the committed fold models'
``__config`` is one).  The other model families' configs are copied
with the modules that use them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Sequence


def _asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


@dataclass(frozen=True)
class ConfigBase:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_yaml(cls, path: str | Path):
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DataConfig(ConfigBase):
    """Dataset-scale constants (reference: models/matrix_factorization/config.yaml:8-9)."""

    n_aids: int = 1_855_604
    n_sessions: int = 14_571_582
    # Last-train-week session-id cutoff used for local validation
    # (reference: src/validation.py:61).
    validation_session_cutoff: int = 11_098_528
    # First test-session id (reference: src/recbole/dataset.py:14-20).
    test_session_cutoff: int = 12_899_779
    seed: int = 42


@dataclass(frozen=True)
class SGNSConfig(ConfigBase):
    """Skip-gram negative-sampling aid embeddings — the replacement for
    fastText (models/fasttext/config.yaml: skipgram, dim 32, ws 10, neg 40,
    loss ns, lr .05, epoch 5) and gensim Word2Vec (models/word2vec/config.yaml:
    window 12, negative 40, ns_exponent .75, sample .003)."""

    dim: int = 32
    window: int = 10
    negatives: int = 40
    epochs: int = 5
    learning_rate: float = 0.05
    min_learning_rate: float = 1e-4
    ns_exponent: float = 0.75
    objective: str = "ns"  # "ns" (negative sampling) or "hs" (hierarchical
    # softmax over a Huffman tree — the reference word2vec's hs: 1)
    subsample_t: float = 1e-4  # frequent-aid downsampling threshold (fastText `t`)
    batch_centers: int = 8192  # center positions per optimizer step
    steps_per_call: int = 8  # optimizer steps scanned per device dispatch
    seed: int = 42
    table_dtype: str = "float32"


COVISIT_KINDS = (
    "time_weighted",
    "click_weighted",
    "cart_weighted",
    "order_weighted",
    "click_cart",
    "click_order",
    "cart_order",
)


@dataclass(frozen=True)
class CovisitConfig(ConfigBase):
    """Covisitation-matrix construction. The reference only *consumes*
    precomputed shards (src/covisitation/inference.py:87-112); this framework
    builds all seven kinds on device (see otto_tpu_torch.models.covisitation)."""

    kinds: Sequence[str] = COVISIT_KINDS
    top_k_wide: int = 50  # per-aid neighbor rows kept for candidate generation ("top_*")
    top_k_narrow: int = 15  # per-aid rows for the heuristic recommender ("top_15_*")
    window_seconds: int = 24 * 60 * 60  # pair time window |ts_a - ts_b|
    max_span: int = 64  # max forward positions paired per event (bounded context)
    session_tail: int = 30  # most recent events per session considered
    # Event-type weights applied to the *target* event of a pair.
    click_weight: float = 1.0
    cart_weight: float = 6.0
    order_weight: float = 3.0
    accumulator_capacity: int = 64 * 1024 * 1024  # running (key, weight) rows on device


@dataclass(frozen=True)
class GBDTConfig(ConfigBase):
    """Histogram gradient-boosted trees — the TPU-native re-implementation of
    the LightGBM/XGBoost lambdarank engines themselves
    (reference: src/ranker/lgb_trainer.py + models/lightgbm/config.yaml).

    Defaults mirror the reference's shipped LightGBM parameters:
    num_leaves 128 (= level-wise ``max_depth`` 7), learning_rate 0.05,
    bagging_fraction/feature_fraction 0.9, min_data_in_leaf 2000,
    min_gain_to_split 1e-5, lambda_l2 0.01, max_bin 255 (+ a reserved missing
    bin), 1000 boosting rounds with MAP@20 early stopping at patience 200
    (models/lightgbm/config.yaml:85-165)."""

    n_trees: int = 1000
    early_stopping_rounds: int = 200
    eval_every: int = 10  # ES metric cadence in trees
    learning_rate: float = 0.05
    max_depth: int = 7  # 2^7 = 128 leaves = the reference's num_leaves
    n_bins: int = 256  # 255 value bins + bin 0 reserved for missing
    reg_lambda: float = 0.01  # lambda_l2
    min_split_gain: float = 1e-5  # min_gain_to_split
    min_data_in_leaf: int = 2000
    min_child_weight: float = 1e-3
    subsample: float = 0.9  # bagging_fraction (per tree)
    colsample: float = 0.9  # feature_fraction (per tree, via gain masking)
    loss: str = "lambdarank"  # or 'bce'
    lambdarank_k: int = 20
    # per-session |dDCG| normalization by the ideal DCG@k (LightGBM's
    # ``lambdarank_norm``, default true — rank_objective.hpp): without it,
    # positive-heavy sessions dominate the gradient mass, the defect behind
    # the r4 lambdarank-vs-bce MAP gap (VERDICT r4 weak #6)
    lambdarank_norm: bool = True
    n_folds: int = 5
    negative_sampling_ratio: float = 0.30
    seed: int = 42
    chunk_sessions: int = 1024  # lambdarank gradient lax.map chunk
    hist_rows_per_chunk: int = 1 << 18  # histogram streaming chunk
    # 'matmul': factored one-hot MXU histograms with sibling subtraction
    # (8.5x the scatter path on a v5e at level-6 shapes); 'scatter': the
    # naive XLA scatter-add (kept as a numerical oracle)
    hist_impl: str = "matmul"
    # >1 scans that many whole trees per device dispatch (one host round-trip
    # per segment).  Growth is HBM/MXU-bound, so this only pays off when
    # per-dispatch latency rivals per-tree compute (small datasets or a
    # remote-attached device) — and it multiplies XLA compile time by the
    # segment length.  ES metric cadence follows the segment when > 1.
    trees_per_call: int = 1
