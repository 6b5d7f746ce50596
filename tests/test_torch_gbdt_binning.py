"""The fit's binning and row lists in the port, against numpy and
``otto_tpu``, on the CPU: :func:`fit_bin_edges_rows` (the device route of
the edges, run here on CPU tensors), the binning twin, the row lists that
``_grow_tree`` keeps grouped by node, and the histogram wrapper over them.

Tolerances, and why:

- edges: equal as float32 values to numpy ``fit_bin_edges`` (the port's copy
  and the JAX package's) on adversarial columns.  Values, not bits: a sort
  does not order -0.0 and +0.0, so an order statistic that is zero may carry
  either sign (numpy's partition may pick the other one);
- bins: bit-equal to ``bin_features`` (the same counts of edges below a
  value);
- row lists: exact (integer positions);
- histograms: bit-equal to the float64 twin on dyadic vals (every sum is
  exact), and the plain fixed-point helper within the quantisation's bound of
  the twin on normal vals.
"""

import numpy as np
import pytest
import torch

from otto_tpu.models import gbdt as jg
from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.models import gbdt as tg
from otto_tpu_torch.models.ranker import RankerData
from otto_tpu_torch.ops import forest, hist

torch.set_num_threads(1)


def _columns(n: int, rng) -> np.ndarray:
    """Columns [n, 13] of awkward values: ties, NaN, +-inf, +-0.0, a constant
    column, an all-NaN one, one finite value, fewer distinct values than
    edges, heavy tails, denormals and float32 extremes."""
    cols = np.empty((n, 13), np.float32)
    cols[:, 0] = rng.normal(size=n)
    cols[:, 1] = rng.integers(0, 5, n)  # few distinct values: ties
    cols[:, 2] = rng.normal(size=n)
    cols[rng.random(n) < 0.3, 2] = np.nan
    cols[:, 3] = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    cols[rng.random(n) < 0.2, 3] = 1.0
    cols[:, 4] = 7.25  # constant
    cols[:, 5] = np.nan  # all NaN
    cols[:, 6] = np.nan
    cols[n // 2, 6] = -3.5  # one finite value
    cols[:, 7] = rng.normal(size=n)
    cols[rng.random(n) < 0.1, 7] = np.inf
    cols[rng.random(n) < 0.1, 7] = -np.inf
    cols[:, 8] = rng.integers(0, 40, n) * 0.1  # 40 distinct values, fewer than the edges
    cols[:, 9] = np.exp(rng.normal(size=n) * 8).astype(np.float32)  # heavy tail
    cols[:, 10] = rng.integers(-3, 4, n) * np.float32(1e-40)  # denormals
    cols[:, 11] = np.where(rng.random(n) < 0.5, np.finfo(np.float32).max,
                           -np.finfo(np.float32).max)  # differences overflow float32
    cols[rng.random(n) < 0.3, 11] = 0.0
    cols[:, 12] = np.arange(n, dtype=np.float32)  # distinct: every quantile interpolates
    return cols


# n - 1 a multiple of 255: (n - 1) q lands on integers (up to q's rounding)
@pytest.mark.parametrize("n", [1, 2, 3, 256, 511, 766, 1000, 2551])
@pytest.mark.parametrize("n_bins", [16, 256])
@pytest.mark.filterwarnings("ignore:overflow encountered", "ignore:invalid value encountered")
def test_fit_bin_edges_rows_equal_to_numpy(n, n_bins):
    rng = np.random.default_rng(n)
    cols = _columns(n, rng)
    mask = rng.random(n) < 0.9
    mask[0] = True
    got = tg.fit_bin_edges_rows(torch.as_tensor(cols), torch.as_tensor(mask), n_bins)
    want = tg.fit_bin_edges(cols[mask], n_bins)
    assert got.dtype == np.float32 and got.shape == (13, n_bins - 2)
    np.testing.assert_array_equal(got, want)  # as values: -0.0 == 0.0, NaN == NaN
    np.testing.assert_array_equal(got, jg.fit_bin_edges(cols[mask], n_bins))
    # the binning twin against numpy's, on the rows and on the edges' own
    # values; not on column 11, where numpy's interpolation itself overflows
    # float32 (NaN or decreasing edges, which pack_edges refuses)
    keep = np.arange(13) != 11
    packed = forest.pack_edges(got[keep], device="cpu")
    probe = np.ascontiguousarray(np.concatenate([cols, got.T])[:, keep])  # each edge a row
    np.testing.assert_array_equal(forest.bin_rows(torch.as_tensor(probe), packed).numpy(),
                                  jg.bin_features(probe, want[keep]))


def test_fit_bin_edges_rows_on_no_rows_and_all_masked():
    x = torch.tensor([[1.0, np.nan], [2.0, 3.0]])
    got = tg.fit_bin_edges_rows(x, torch.tensor([False, False]), 16)
    np.testing.assert_array_equal(got, np.zeros((2, 14), np.float32))
    got = tg.fit_bin_edges_rows(torch.empty((0, 2)), torch.empty(0, dtype=torch.bool), 16)
    np.testing.assert_array_equal(got, np.zeros((2, 14), np.float32))


def test_bin_rows_checks_its_inputs():
    x = torch.zeros((4, 3))
    edges = forest.pack_edges(np.zeros((3, 14), np.float32), device="cpu")
    assert forest.bin_rows(x, edges).dtype == torch.uint8
    with pytest.raises(TypeError):
        forest.bin_rows(x.double(), edges)
    with pytest.raises(ValueError):
        forest.bin_rows(torch.zeros((4, 2)), edges)
    before = forest.bin_rows.launches
    forest.bin_rows(x, edges)
    assert forest.bin_rows.launches == before  # the CPU runs the twin


def _listed(order, seg):
    return [order[seg[j]:seg[j + 1]].tolist() for j in range(len(seg) - 1)]


def test_row_lists_split_stably_by_node():
    """The row list after each level: every node's rows in row order (a
    stable split of its parent's), the rows with zero vals on no node's
    stretch; equal to a stable sort of the listed rows by node."""
    rng = np.random.default_rng(3)
    N = 500
    vals = torch.as_tensor(rng.normal(size=(N, 3)).astype(np.float32))
    vals[rng.random(N) < 0.3] = 0.0
    vals[5] = torch.tensor([0.0, -0.0, 0.0])
    order, seg = tg._row_list(vals)
    adds = (vals != 0).any(dim=1).numpy()
    assert seg.tolist() == [0, int(adds.sum())]
    assert order.tolist() == np.flatnonzero(adds).tolist()
    node = torch.zeros(N, dtype=torch.int64)
    for level in range(4):
        node = node * 2 + torch.as_tensor(rng.random(N) < 0.4).long()
        order, seg = tg._split_rows(order, seg, node)
        assert order.dtype == torch.int32 and len(seg) == (2 << level) + 1
        nodes = node.numpy()
        for j, rows in enumerate(_listed(order, seg)):
            want = [r for r in np.flatnonzero(adds) if nodes[r] == j]
            assert rows == want, (level, j)
        assert int(seg[-1]) == len(order) == adds.sum()


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
def test_node_histograms_over_a_row_list_equal_to_the_twin(kind):
    """The wrapper over a row list (left children of a split level, as the
    tree keys them) against the twin with one key a row; on dyadic vals the
    fixed-point helper (the kernel's arithmetic) equals both bit for bit."""
    rng = np.random.default_rng(4)
    N, F, NB = 700, 37, 16  # 37 features: two groups of 32, padded
    binned = torch.as_tensor(rng.integers(0, NB + 2, (N, F)).astype(np.uint8))  # some >= NB
    vals = torch.as_tensor(((rng.integers(-255, 256, (N, 3)) / 256) if kind == "dyadic"
                            else rng.normal(size=(N, 3))).astype(np.float32))
    vals[:50] = 0.0
    order, seg = tg._row_list(vals)
    node = torch.as_tensor(rng.integers(0, 2, N)).long()
    order, seg = tg._split_rows(order, seg, node)
    node = node * 2 + torch.as_tensor(rng.integers(0, 2, N)).long()
    order, seg = tg._split_rows(order, seg, node)
    start = seg[0:-1:2]
    pre = torch.cat([seg.new_zeros(1), torch.cumsum(seg[1::2] - start, dim=0)])
    rows = hist.pad_rows(binned)
    assert rows.shape == (N, 64) and torch.equal(rows[:, :F], binned) and not rows[:, F:].any()
    got = hist.node_histograms(rows, F, vals, vals.abs().amax(dim=0), order, start, pre, NB)
    key = torch.where((node & 1) == 0, node >> 1, -1).to(torch.int32)
    key[:50] = -1  # rows with zero vals are on no key's list
    assert torch.equal(hist.list_keys(order, start, pre, N), key)
    want = hist._build_histogram_reference(binned, key, vals, 2, NB)
    assert torch.equal(got, want)
    fixed = hist._fixed_point_histogram(binned, key, vals, 2, NB)
    if kind == "dyadic":
        assert torch.equal(fixed, want)
    else:  # a value moves by < N max|v| 2^-61 when quantised; then each rounds once
        bound = N * N * vals.abs().amax(dim=0) * 2.0 ** -61 + 2.0 ** -23 * want.abs()
        assert bool(((fixed - want).abs() <= bound).all())
    with pytest.raises(ValueError):  # rows not padded by pad_rows
        hist.node_histograms(binned, F, vals, vals.abs().amax(dim=0), order, start, pre, NB)
    with pytest.raises(TypeError):
        hist.node_histograms(rows, F, vals, vals.abs().amax(dim=0), order.long(), start, pre,
                             NB)


def test_grow_tree_with_and_without_the_fits_padded_rows():
    rng = np.random.default_rng(5)
    N, F, NB = 800, 10, 16
    binned = torch.as_tensor(rng.integers(0, NB, (N, F)).astype(np.uint8))
    grad = (rng.integers(-9, 10, N) / 64).astype(np.float32)
    hess = (rng.integers(1, 9, N) / 64).astype(np.float32)
    weight = (rng.random(N) < 0.7).astype(np.float32)
    args = [binned, *map(torch.as_tensor, (grad, hess, weight)), torch.ones(N),
            torch.ones(F, dtype=torch.bool)]
    kw = dict(depth=4, n_bins=NB)
    a = tg._grow_tree(*args, 0.01, 1e-5, 10.0, 1e-3, 0.1, **kw)
    b = tg._grow_tree(*args, 0.01, 1e-5, 10.0, 1e-3, 0.1, rows=hist.pad_rows(binned), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_train_gbdt_ranker_takes_float32_features():
    rng = np.random.default_rng(6)
    S, C, F = 12, 8, 4
    X = rng.normal(size=(S, C, F))
    data = RankerData(X, (rng.random((S, C)) < 0.2).astype(np.int8), np.ones((S, C), bool),
                      np.arange(S), np.zeros((S, C), np.int32))
    with pytest.raises(TypeError, match="float32"):
        tg.train_gbdt_ranker(data, GBDTConfig(n_trees=2, n_folds=2, n_bins=16), device="cpu")
