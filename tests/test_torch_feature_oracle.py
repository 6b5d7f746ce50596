"""The port's pandas feature oracle (``otto_tpu_torch/eval/feature_oracle.py``)
against the JAX package's, and the port's features against it, on the CPU.

A ``synthetic_events_v2`` store of 2,000 sessions over 500 aids (seed 3),
split by time (val 0.15), the covisitation build and ``regular_candidates``
of the port on its training part; the orders candidates and their scores
are the interaction grid.  Tolerances:

- oracle against oracle: the same pandas code over equal inputs, so every
  frame is equal (``assert_frame_equal``, exact) and the fold protocol's
  rows equal;
- the port's features against the oracle: every shared column within 1e-7
  relative to the column's scale (``tools/feature_parity_torch.py``'s
  ``compare``; the JAX package's bar at 50,000 sessions is 6e-8), NaN
  patterns equal; the fold sizes equal and no sampled negative outside a
  positive-bearing session;
- ``import otto_tpu_torch.eval`` and the entry points import no pandas.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parents[1]
STORE_KW = dict(n_sessions=2_000, n_aids=500, seed=3)
N_AIDS = STORE_KW["n_aids"]
RTOL = 1e-7


def _tool():
    from otto_tpu_torch.utils.runtime import load_file

    return load_file(REPO / "tools" / "feature_parity_torch.py", "feature_parity_torch")


@pytest.fixture(scope="module")
def setup():
    from otto_tpu.data.splits import split_by_time as jsplit_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2 as jsynthetic
    from otto_tpu.eval import feature_oracle as jfo
    from otto_tpu_torch.data.splits import split_by_time
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.eval import feature_oracle as fo
    from otto_tpu_torch.models.candidates import regular_candidates
    from otto_tpu_torch.models.covisitation import build_covisitation

    split = split_by_time(synthetic_events_v2(**STORE_KW), val_fraction=0.15, seed=3)
    jtarget = jsplit_by_time(jsynthetic(**STORE_KW), val_fraction=0.15, seed=3).val_input
    target = split.val_input
    for col in ("session_idx", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(target, col), getattr(jtarget, col))
    mats = build_covisitation(split.train, N_AIDS, device="cpu")
    cands = regular_candidates(target, mats, labels=split.val_labels, device="cpu")
    c, s = cands.candidates["orders"], cands.scores["orders"]
    df, jdf = fo.events_to_frame(target), jfo.events_to_frame(jtarget)
    return dict(fo=fo, jfo=jfo, target=target, c=c, s=s, labels=cands.labels["orders"],
                df=df, jdf=jdf)


def test_frames_equal_to_the_jax_oracle(setup):
    fo, jfo, df, jdf = setup["fo"], setup["jfo"], setup["df"], setup["jdf"]
    pd.testing.assert_frame_equal(df, jdf)
    aid, jaid = fo.oracle_aid_features(df), jfo.oracle_aid_features(jdf)
    pd.testing.assert_frame_equal(aid, jaid)
    pd.testing.assert_frame_equal(fo.oracle_session_features(df, aid),
                                  jfo.oracle_session_features(jdf, jaid))
    pd.testing.assert_frame_equal(fo.oracle_interaction_features(df, setup["c"], setup["s"]),
                                  jfo.oracle_interaction_features(jdf, setup["c"], setup["s"]))


def test_fold_protocol_equal_to_the_jax_oracle(setup):
    c, labels = setup["c"], setup["labels"]
    mask = (c >= 0).reshape(-1)
    sess = np.repeat(np.arange(c.shape[0]), c.shape[1])[mask]
    lab = labels.reshape(-1)[mask].astype(np.int64)
    got = setup["fo"].oracle_fold_and_sampling(sess, lab)
    want = setup["jfo"].oracle_fold_and_sampling(sess, lab)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_port_features_within_the_bars_of_the_oracle(setup):
    tool = _tool()
    fams = tool.feature_families(setup["fo"], setup["target"], N_AIDS, setup["c"], setup["s"])
    n_cols = {k: len(v["columns"]) for k, v in fams.items()}
    assert n_cols == {"aid_features": 223, "session_features": 77, "interaction_features": 25}
    for fam, res in fams.items():
        for col, st in res["columns"].items():
            assert st["max_rel_diff"] <= RTOL, (fam, col, st)
            assert st["nan_pattern_agree"] == 1.0, (fam, col, st)


def test_port_protocol_against_the_oracle(setup):
    got = _tool().protocol(setup["fo"], setup["c"], setup["labels"])
    assert got["framework_fold_row_sizes"] == got["oracle_fold_val_sizes"]
    assert got["framework_strays_outside_positive_sessions"] == 0
    assert got["oracle_strays_outside_positive_sessions"] == 0


def test_eval_and_entry_points_import_no_pandas():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('pandas', 'sklearn'):\n"
            "            raise ImportError(f'{name} is blocked')\n"
            "sys.meta_path.insert(0, Block())\n"
            "import otto_tpu_torch.eval, otto_tpu_torch.pipelines, otto_tpu_torch.twostage\n"
            "import otto_tpu_torch.streaming\n"
            "from otto_tpu_torch.eval import harness, metrics, oracle\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('pandas', 'sklearn')]\n"
            "try:\n"
            "    import otto_tpu_torch.eval.feature_oracle\n"
            "except ImportError as e:\n"
            "    print('oracle needs pandas:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "oracle needs pandas: pandas is blocked" in out.stdout
