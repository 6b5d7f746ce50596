"""A sequence model's parameters made on the card from the seed.

The tree has the port's layout (the names and shapes its encoders read,
``otto_tpu_torch/models/sequence.py::init_params``), so the program can
serve it; the benchmark makes it, and both the program and the reference
read it.  Every leaf is a view into one buffer drawn by one call of a
``torch.Generator`` on the device: normal leaves at the port's scales,
biases small and nonzero, layer-norm scales near 1, so that every term of
the encoder matters to the check.
"""

from __future__ import annotations

import math

import torch


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, float, float]]:
    """(path, shape, scale, offset) of every leaf: value = offset + scale *
    N(0, 1).  Paths name the tree's keys joined by dots."""
    n, d = cfg["n_aids"] + 1, cfg["dim"]  # the PAD row at n_aids
    if cfg["architecture"] == "transformer":
        heads = cfg["n_heads"]
        ffn = cfg["ffn_dim"]
        s = math.sqrt(1.0 / d)
        out = [("item_emb", (n, d), 0.05, 0.0), ("pos_emb", (cfg["max_len"], d), 0.05, 0.0),
               ("out_proj", (d, d), s, 0.0),
               ("final_ln.scale", (d,), 0.1, 1.0), ("final_ln.bias", (d,), 0.02, 0.0)]
        for i in range(cfg["n_layers"]):
            p = f"layers.{i}."
            out += [(p + "wq", (d, heads, d // heads), s, 0.0),
                    (p + "wk", (d, heads, d // heads), s, 0.0),
                    (p + "wv", (d, heads, d // heads), s, 0.0),
                    (p + "wo", (d, d), s, 0.0),
                    (p + "ln1.scale", (d,), 0.1, 1.0), (p + "ln1.bias", (d,), 0.02, 0.0),
                    (p + "ln2.scale", (d,), 0.1, 1.0), (p + "ln2.bias", (d,), 0.02, 0.0),
                    (p + "ffn_w1", (d, ffn), s, 0.0), (p + "ffn_b1", (ffn,), 0.02, 0.0),
                    (p + "ffn_w2", (ffn, d), math.sqrt(1.0 / ffn), 0.0),
                    (p + "ffn_b2", (d,), 0.02, 0.0)]
        return out
    if cfg["architecture"] == "gru":
        h = cfg["hidden"]
        return [("item_emb", (n, d), 0.05, 0.0),
                ("gru_wx", (d, 3 * h), math.sqrt(1.0 / d), 0.0),
                ("gru_wh", (h, 3 * h), math.sqrt(1.0 / h), 0.0),
                ("gru_b", (3 * h,), 0.02, 0.0),
                ("out_proj", (h, d), math.sqrt(1.0 / h), 0.0)]
    raise ValueError(f"no parameter layout for architecture {cfg['architecture']!r}")


def _put(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    node = tree
    for k, nxt in zip(keys[:-1], keys[1:]):
        if nxt.isdigit():
            node = node.setdefault(k, [])
        elif isinstance(node, list):
            i = int(k)
            while len(node) <= i:
                node.append({})
            node = node[i]
        else:
            node = node.setdefault(k, {})
    last = keys[-1]
    if isinstance(node, list):
        node.append(value)
    else:
        node[last] = value


def make_params(cfg: dict, seed: int, device: str | torch.device) -> dict:
    """The tree of float32 leaves, drawn on ``device`` from ``seed``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    at = 0
    for path, shape, scale, offset in specs:
        size = math.prod(shape)
        leaf = flat[at:at + size].view(shape)
        leaf.mul_(scale).add_(offset)
        _put(tree, path, leaf)
        at += size
    return tree


def flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs, dict keys sorted and lists in order (the port's
    leaf order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in flatten(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]
