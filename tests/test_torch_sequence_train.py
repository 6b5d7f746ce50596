"""The port's sequence-model training and its runner
(``otto_tpu_torch/models/sequence.py::train_sequence_model``,
``pipelines.run_sequence``) against ``otto_tpu``'s, on the CPU, at small
widths (dim 16, hidden 32, max_len 5, 2 layers, 2 heads, 4 experts), with
JAX's initial parameters injected into the port (its own draws match JAX's
in distribution only).

Tolerances:

- the numpy draws (each epoch's permutation, each step's negatives) and so
  every batch: bit-equal;
- each epoch's mean loss within 1e-4 relative; the final parameters within
  1e-4 * (|x| + 0.01) (float32 sums in other orders through a few Adam
  steps at the published learning rate, 1e-3: each step moves an entry by
  about the rate, so a flipped update would be 20 times the bound);
- ``run_sequence``: the same recall counts up to the lists' near-ties; the
  lists equal but where the two packages' models order two items whose
  scores (under the JAX model) lie within 1e-4 relative, counted.
"""

import jax
import numpy as np
import pytest
import torch

from otto_tpu import pipelines as jpipe
from otto_tpu.config import SequenceModelConfig as JConfig
from otto_tpu.data.events import EventStore as JStore
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth
from otto_tpu.data.splits import split_by_fraction as j_split
from otto_tpu.models import sequence as jseq
from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch import pipelines as tpipe
from otto_tpu_torch.config import SequenceModelConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.splits import split_by_fraction
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import sequence as tseq

torch.set_num_threads(1)

N_AIDS = 120
_DEFAULT_RNG = np.random.default_rng


class _Draws:
    """A numpy Generator that records what the trainer draws."""

    def __init__(self, seed, log):
        self._rng, self._log = _DEFAULT_RNG(seed), log

    def permutation(self, n):
        out = self._rng.permutation(n)
        self._log.append(("permutation", out.copy()))
        return out

    def integers(self, *a, **kw):
        out = self._rng.integers(*a, **kw)
        self._log.append(("integers", out.copy()))
        return out


def _jax_init(cfg):
    """The initial parameters JAX's train_sequence_model draws."""
    _, init_key = jax.random.split(jax.random.PRNGKey(cfg.seed))
    return jseq.init_params(init_key, cfg.n_aids, cfg.dim, cfg.hidden,
                            architecture=cfg.architecture, max_len=cfg.max_len,
                            n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                            moe_experts=cfg.moe_experts)


def _inject_jax_init(monkeypatch, jcfg):
    """Make the port's init_params return JAX's initial parameters."""
    params = jax.tree_util.tree_map(np.asarray, _jax_init(jcfg))

    def init(generator, n_aids, *a, **kw):
        return tseq._tree_map(lambda v: torch.tensor(v), params)

    monkeypatch.setattr(tseq, "init_params", init)


@pytest.fixture(scope="module")
def corpus():
    store = synthetic_events_v2(n_sessions=150, n_aids=N_AIDS, mean_length=6.0,
                                max_length=16, n_clusters=10, seed=3)
    arrays = (store.session_ids[store.session_idx], store.aid, store.ts, store.type)
    return JStore.from_flat(*arrays), EventStore.from_flat(*arrays)


CASES = {
    # (architecture, moe_experts, loss, batch_size): bpr_max's batch is larger
    # than the corpus's examples, so its one step a batch is tiled
    "gru": ("gru", 0, "sampled_softmax", 128),
    "gru_bpr_max": ("gru", 0, "bpr_max", 1024),
    "moe": ("transformer", 4, "sampled_softmax", 256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_protocol_equal_to_jax(corpus, monkeypatch, case):
    arch, moe, loss, batch = CASES[case]
    kw = dict(n_aids=N_AIDS, dim=16, hidden=32, max_len=5, batch_size=batch, epochs=2,
              n_negatives=16, learning_rate=1e-3, architecture=arch, loss=loss, bpr_reg=0.5,
              n_layers=2, n_heads=2, moe_experts=moe)
    jcfg, tcfg = JConfig(**kw), SequenceModelConfig(**kw)
    js, ts = corpus
    runs = {}
    for pkg in ("jax", "torch"):
        log = {"draws": [], "batches": []}
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed, _log=log: _Draws(seed, _log["draws"]))
        if pkg == "torch":
            _inject_jax_init(monkeypatch, jcfg)
            real_step = tseq.train_step

            def step(params, opt, seq, mask, tgt, negs, _log=log, **k):
                _log["batches"].append((tgt.numpy().copy(), negs.numpy().copy()))
                return real_step(params, opt, seq, mask, tgt, negs, **k)

            monkeypatch.setattr(tseq, "train_step", step)
            model = tseq.train_sequence_model(ts, tcfg, device="cpu")
        else:
            model = jseq.train_sequence_model(js, jcfg)
        monkeypatch.undo()
        runs[pkg] = log, model
    (jlog, jm), (tlog, tm) = runs["jax"], runs["torch"]
    assert [k for k, _ in tlog["draws"]] == [k for k, _ in jlog["draws"]]
    for (_, a), (_, b) in zip(tlog["draws"], jlog["draws"]):
        np.testing.assert_array_equal(a, b)
    # each step's targets and negatives as the reference slices them
    _, _, targets = jseq._training_examples(js, 5, N_AIDS)
    n, want = len(targets), []
    perms = iter(d for k, d in jlog["draws"] if k == "permutation")
    negs = iter(d for k, d in jlog["draws"] if k == "integers")
    for _ in range(2):
        order = next(perms)
        for i in range(max(n // batch, 1)):
            sel = order[i * batch:(i + 1) * batch]
            sel = np.tile(sel, -(-batch // len(sel)))[:batch]
            want.append((targets[sel], next(negs).astype(np.int32)))
    assert len(tlog["batches"]) == len(want)
    for (gt, gn), (wt, wn) in zip(tlog["batches"], want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gn, wn)
    assert [h["epoch"] for h in tm.history] == [0, 1]
    for g, w in zip(tm.history, jm.history):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4)
    for g, w in zip(tseq.tree_leaves(tseq.sequence_params_to_numpy(tm.params)),
                    jax.tree_util.tree_leaves(jm.params)):
        w = np.asarray(w)
        assert np.all(np.abs(g - w) <= 1e-4 * (np.abs(w) + 0.01))


def test_run_sequence_equal_to_jax(monkeypatch, tmp_path):
    """The slice as a whole: ``run_sequence`` in both packages from one
    config file (JAX's initial parameters injected), on the same split."""
    kw = dict(n_sessions=300, n_aids=N_AIDS, mean_length=20.0, max_length=64, n_clusters=4,
              seed=5)
    store_j, store_t = j_synth(**kw), synthetic_events_v2(**kw)
    sp_j, sp_t = j_split(store_j, 0.3, 1), split_by_fraction(store_t, val_fraction=0.3, seed=1)
    cfg_path = tmp_path / "sequence.yaml"
    cfg_path.write_text("dim: 16\nhidden: 32\nmax_len: 5\nbatch_size: 256\nepochs: 2\n"
                        "n_negatives: 16\n")
    jcfg = JConfig.from_yaml(cfg_path).replace(n_aids=N_AIDS)
    jm = {}
    real_train = jseq.train_sequence_model
    monkeypatch.setattr(jseq, "train_sequence_model",
                        lambda *a: jm.setdefault("m", real_train(*a)))
    want = jpipe.run_sequence(sp_j.train, sp_j.val_input, N_AIDS, sp_j.val_labels,
                              config_path=str(cfg_path))
    _inject_jax_init(monkeypatch, jcfg)
    got = tpipe.run_sequence(sp_t.train, sp_t.val_input, N_AIDS, sp_t.val_labels,
                             config_path=str(cfg_path), device="cpu")
    target = sp_t.val_input
    counts = np.array([len(set(target.aid[a:b]))
                       for a, b in zip(target.offsets[:-1], target.offsets[1:])])
    assert (counts >= 20).any() and (counts < 20).any()  # two routes taken
    vecs = jm["m"].encode_sessions(sp_j.val_input)
    items = np.asarray(jm["m"].params["item_emb"])[:N_AIDS]
    scores = vecs.astype(np.float64) @ items.T.astype(np.float64)
    g, w = got.predictions["clicks"], want.predictions["clicks"]
    rows = np.flatnonzero((g != w).any(axis=1))
    for r in rows:
        assert counts[r] < 20, r  # the recency route is bit-equal here
        for a, b in zip(g[r][g[r] != w[r]], w[r][g[r] != w[r]]):
            assert abs(scores[r, a] - scores[r, b]) <= 1e-4 * np.abs(scores[r]).max(), (r, a, b)
    assert len(rows) <= 3, rows
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], g)
    assert got.report.weighted == pytest.approx(want.report.weighted, abs=0.01)
