"""Typed configuration for the ported slice.

Copied from ``otto_tpu/config.py`` (no jax inside): the config base,
:class:`DataConfig` and :class:`SGNSConfig`.  The other model families'
configs are copied with the modules that use them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any


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
