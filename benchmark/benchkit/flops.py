"""Operation counts of the sequence models, from a configuration's shapes.

A multiply-add counts two operations.  The encoder is counted over all
``max_len`` positions, padded or not, as the model is defined over them;
the attention over all ``max_len`` keys of each position (the product the
encoder computes before its causal mask); layer norms, activations and
softmaxes are not counted.
"""

from __future__ import annotations


def encoder_flops(cfg: dict) -> float:
    """One session's encoder forward, to the session vector."""
    L, D = cfg["max_len"], cfg["dim"]
    if cfg["architecture"] == "transformer":
        F = cfg["ffn_dim"]
        per_position = 2 * 3 * D * D + 2 * 2 * L * D + 2 * D * D + 2 * 2 * D * F
        return float(cfg["n_layers"] * L * per_position + 2 * D * D)
    if cfg["architecture"] == "gru":
        H = cfg["hidden"]
        return float(L * (2 * D * 3 * H + 2 * H * 3 * H) + 2 * H * D)
    raise ValueError(f"no operation count for architecture {cfg['architecture']!r}")


def score_flops(cfg: dict, n_items: int) -> float:
    """A session vector's dot products with ``n_items`` items."""
    return 2.0 * cfg["dim"] * n_items

