"""Skip-gram SGNS aid embeddings: training, the embedding-kNN recommender
and pooled session embeddings.

Port of ``otto_tpu/models/embeddings.py``.  Sessions are the "sentences",
aids the "words"; aid ids index the tables directly.

Training (:func:`train_sgns`, :func:`train_sgns_device`) replaces the
reference's fastText / gensim Word2Vec trainers:

- host side: vectorized skip-gram pairs with per-center reduced windows
  and frequent-aid subsampling (:func:`skipgram_pairs`, numpy, bit-equal
  to the JAX package's for the same generator), or pairs sampled on the
  card (:func:`train_sgns_device`);
- on the device: one step per batch of pairs, gathering the batch's rows,
  sigmoid BCE against negatives from the unigram^0.75 distribution (or
  hierarchical softmax over a Huffman tree, :func:`build_huffman_paths`),
  and sparse per-coordinate adagrad applied with ``index_add_`` so no step
  writes the whole table;
- the linear learning-rate decay over all steps, with a floor.

Every draw the reference makes with numpy is made here with a
``numpy.random.Generator`` seeded from ``config.seed``, in the reference's
order, so pairs, permutations and initial tables are bit-equal; the draws
it makes with ``jax.random`` come from a ``torch.Generator`` on the device.
Float ``index_add_`` on CUDA adds with atomics, so a run on the card is not
bit-reproducible (on the CPU it is).

Serving: :class:`SGNSModel` (neighbor table, ``.npz`` in the JAX package's
format), :func:`recursive_neighbors`, :func:`embedding_knn_predictions`
(sessions with >= 20 distinct aids get typed recency-weight scores on the
device; the rest their ascending-unique aids padded with kNN neighbors of
the last aid, on the host), and the Doc2Vec analog
:func:`session_embeddings` / :class:`SessionEmbeddingModel`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import SGNSConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.ops.retrieval import build_neighbor_table
from otto_tpu_torch.utils.runtime import full_f32_matmul, resolve_device

log = get_logger(__name__)


def skipgram_pairs(
    store: EventStore,
    window: int,
    rng: np.random.Generator,
    subsample_t: float = 0.0,
    counts: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized skip-gram pair generation over all sessions.

    Each surviving event draws a reduced window b ~ U{1..window}; pairs are
    (center, context) for every context within b positions in the same
    session.  With ``subsample_t`` > 0, frequent aids are dropped with
    word2vec's probability 1 - (sqrt(t/f) + t/f).
    """
    aid = store.aid
    sidx = store.session_idx
    n = len(aid)

    keep = np.ones(n, dtype=bool)
    if subsample_t > 0 and counts is not None:
        freq = counts[aid] / max(counts.sum(), 1)
        p_keep = np.sqrt(subsample_t / np.maximum(freq, 1e-12)) + subsample_t / np.maximum(
            freq, 1e-12
        )
        keep = rng.random(n) < np.minimum(p_keep, 1.0)

    aid_k = aid[keep]
    sidx_k = sidx[keep]
    m = len(aid_k)
    b = rng.integers(1, window + 1, size=m)

    centers, contexts = [], []
    for d in range(1, window + 1):
        same = sidx_k[:-d] == sidx_k[d:] if d < m else np.zeros(0, bool)
        fwd = same & (b[:-d] >= d)  # context d positions ahead of center
        bwd = same & (b[d:] >= d)  # context d positions behind center
        centers.append(aid_k[:-d][fwd])
        contexts.append(aid_k[d:][fwd])
        centers.append(aid_k[d:][bwd])
        contexts.append(aid_k[:-d][bwd])
    c = np.concatenate(centers).astype(np.int32)
    x = np.concatenate(contexts).astype(np.int32)
    drop_same = c != x
    return c[drop_same], x[drop_same]


def build_huffman_paths(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Huffman tree over aid frequencies -> per-leaf classifier paths, for
    the hierarchical-softmax objective (the reference word2vec's ``hs: 1``).

    Returns ``(nodes int32 [V, L], signs int8 [V, L])``: row ``v`` lists the
    inner-node ids (0..V-2) on ``v``'s root->leaf path with ``sign =
    1-2*code``; positions past the path depth pad with node 0 / sign 0
    (their gradients are exactly zero).  Built with the two-queue O(V)
    merge after one stable sort; paths are extracted by climbing all leaves
    one level per pass.
    """
    V = len(counts)
    if V < 2:
        return np.zeros((V, 1), np.int32), np.zeros((V, 1), np.int8)
    order = np.argsort(counts, kind="stable")
    leaf_w = np.asarray(counts, np.float64)[order]
    n_inner = V - 1
    inner_w = np.zeros(n_inner, np.float64)
    parent = np.full(V + n_inner, -1, np.int64)  # leaves: original ids; inner: V+i
    code = np.zeros(V + n_inner, np.int8)
    li = ii = 0
    for k in range(n_inner):  # two-queue merge: both queues stay sorted
        for j in range(2):
            take_leaf = li < V and (ii >= k or leaf_w[li] <= inner_w[ii])
            if take_leaf:
                node_id, w = order[li], leaf_w[li]
                li += 1
            else:
                node_id, w = V + ii, inner_w[ii]
                ii += 1
            parent[node_id] = V + k
            code[node_id] = j
            inner_w[k] += w
    root = V + n_inner - 1
    steps = []
    cur = np.arange(V, dtype=np.int64)
    active = cur != root
    while active.any():
        p = np.where(active, parent[cur], cur)
        steps.append((p, code[cur], active))
        cur = p
        active = cur != root
    nodes = np.zeros((V, len(steps)), np.int32)
    signs = np.zeros((V, len(steps)), np.int8)
    for i, (p, c, a) in enumerate(steps):
        idx = np.flatnonzero(a)
        nodes[idx, i] = (p[idx] - V).astype(np.int32)
        signs[idx, i] = 1 - 2 * c[idx]
    return nodes, signs


# ---------------------------------------------------------------------------
# The steps.  Each updates the four tables in place and returns the step's
# loss (a 0-d tensor, left on the device).  Gradients are closed-form over
# the gathered rows; the sparse adagrad adds every occurrence's square into
# ``acc`` first (``index_add_``, which keeps every duplicate: ``t[idx] += v``
# would keep one write per duplicated index) and then scales each occurrence
# by the batch-complete accumulator gathered after the add.
# ---------------------------------------------------------------------------


def negative_cdf(counts: np.ndarray, exponent: float, *, device: torch.device) -> torch.Tensor:
    """float32 CDF of the unigram^``exponent`` negative-sampling
    distribution over aids (the reference's float64 host arithmetic)."""
    p = counts ** exponent
    p /= p.sum()
    return torch.as_tensor(np.cumsum(p).astype(np.float32), device=device)


def draw_negatives(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of aid ids for uniforms ``u`` in [0, 1).

    A uniform above ``cdf[-1]`` (a float32 CDF may end below 1) makes
    ``searchsorted`` return ``len(cdf)``.  JAX clamps that index on a
    gather and drops it on a scatter; a CUDA gather would stop on a
    device-side assert.  The clamp keeps every id in range: such a draw is
    the last aid, gathered as JAX gathers it and, unlike JAX, updated.
    """
    return torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)


def negative_uniforms(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """The uniforms of :func:`train_sgns`'s negative draws (one call a
    group of steps).  Tests replace it to feed the JAX package's draws."""
    return torch.rand(shape, generator=gen, device=gen.device)


def _adagrad(w, acc, lr: float, updates) -> None:
    """Add each ``(idx, g)``'s squares into ``acc``, then every update
    scaled by the batch-complete ``acc`` into ``w``."""
    for idx, g in updates:
        acc.index_add_(0, idx, g * g)
    for idx, g in updates:
        w.index_add_(0, idx, -lr * g * torch.rsqrt(acc[idx] + 1e-10))


def sgns_step(w_in, w_out, acc_in, acc_out, centers, contexts, negatives, lr: float,
              weight=None):
    """One SGNS step with per-pair negatives ``[B, n_negatives]``.

    ``weight`` (float32 [B], 0 = a rejected draw pointing at row 0) scales
    every pair's loss and gradient, the masked form of the device pair
    sampler; the loss is then divided by ``max(sum(weight), 1)``, else by B
    (``_sgns_step_impl`` and ``_sgns_weighted_step`` of the reference).
    """
    c_rows = w_in[centers]  # [B, D]
    pos_rows = w_out[contexts]  # [B, D]
    neg_rows = w_out[negatives]  # [B, Neg, D]
    pos_logit = (c_rows * pos_rows).sum(dim=1)
    neg_logit = torch.einsum("bd,bnd->bn", c_rows, neg_rows)
    g_pos = torch.sigmoid(pos_logit) - 1.0
    g_neg = torch.sigmoid(neg_logit)
    pos_loss = -F.logsigmoid(pos_logit)
    neg_loss = -F.logsigmoid(-neg_logit)
    if weight is None:
        loss = (pos_loss.sum() + neg_loss.sum()) / centers.shape[0]
    else:
        loss = ((weight * pos_loss).sum() + (weight[:, None] * neg_loss).sum()) \
            / weight.sum().clamp(min=1.0)
        g_pos = weight * g_pos
        g_neg = weight[:, None] * g_neg
    g_c = g_pos[:, None] * pos_rows + torch.einsum("bn,bnd->bd", g_neg, neg_rows)
    g_ctx = g_pos[:, None] * c_rows
    g_negrows = g_neg[:, :, None] * c_rows[:, None, :]
    out_idx = torch.cat([contexts, negatives.reshape(-1)])
    g_out = torch.cat([g_ctx, g_negrows.reshape(-1, g_ctx.shape[1])])
    _adagrad(w_in, acc_in, lr, [(centers, g_c)])
    _adagrad(w_out, acc_out, lr, [(out_idx, g_out)])
    return loss


def sgns_shared_neg_step(w_in, w_out, acc_in, acc_out, centers, contexts, weight, negatives,
                         lr: float, n_negatives: int):
    """SGNS step with one set of ``[Nn]`` negatives shared by the batch:
    every pair scores against all of them through one [B, D] x [D, Nn]
    product, and the negative rows' gradients reduce over the batch with
    the transposed product, so only Nn negative rows are scattered.  The
    negative term is scaled by ``n_negatives / Nn`` so gradient magnitudes
    match the per-pair objective in expectation.  Both ``acc_out`` adds
    (contexts, then negatives) come before any ``w_out`` update, so a
    context that is also a negative sees both (``_sgns_shared_neg_step``).
    Run it under :func:`full_f32_matmul`: the reference asks for float32
    accumulation in the three products.
    """
    scale = float(np.float32(n_negatives / negatives.shape[0]))
    c_rows = w_in[centers]  # [B, D]
    pos_rows = w_out[contexts]  # [B, D]
    neg_rows = w_out[negatives]  # [Nn, D]
    pos_logit = (c_rows * pos_rows).sum(dim=1)
    neg_logit = c_rows @ neg_rows.T  # [B, Nn]
    loss = (weight * -F.logsigmoid(pos_logit)).sum() + scale * (
        weight[:, None] * -F.logsigmoid(-neg_logit)).sum()
    g_pos = weight * (torch.sigmoid(pos_logit) - 1.0)
    g_neg = scale * weight[:, None] * torch.sigmoid(neg_logit)
    g_c = g_pos[:, None] * pos_rows + g_neg @ neg_rows
    g_ctx = g_pos[:, None] * c_rows
    g_negrows = g_neg.T @ c_rows  # [Nn, D]
    _adagrad(w_in, acc_in, lr, [(centers, g_c)])
    _adagrad(w_out, acc_out, lr, [(contexts, g_ctx), (negatives, g_negrows)])
    return loss / weight.sum().clamp(min=1.0)


def hs_step(w_in, w_node, acc_in, acc_node, centers, path_nodes, path_signs, lr: float):
    """One hierarchical-softmax step with the same sparse adagrad.

    ``path_nodes`` / ``path_signs`` [B, L] are the context aid's Huffman
    path; loss = sum of -log sigmoid(sign * h.w_node) over valid positions.
    Pad positions (sign 0) give exactly zero gradient and scatter a zero
    row into node 0 (``_hs_step_impl``).
    """
    h = w_in[centers]  # [B, D]
    rows = w_node[path_nodes]  # [B, L, D]
    sgn = path_signs.to(torch.float32)
    t = sgn * torch.einsum("bd,bld->bl", h, rows)
    valid = sgn != 0
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    loss = torch.where(valid, -F.logsigmoid(t), zero).sum()
    g_logit = torch.where(valid, sgn * (torch.sigmoid(t) - 1.0), zero)
    g_c = torch.einsum("bl,bld->bd", g_logit, rows)
    g_rows = (g_logit[:, :, None] * h[:, None, :]).reshape(-1, h.shape[1])
    _adagrad(w_in, acc_in, lr, [(centers, g_c)])
    _adagrad(w_node, acc_node, lr, [(path_nodes.reshape(-1), g_rows)])
    return loss / centers.shape[0]


def sgns_state_from_jax(w_in, w_out, acc_in, acc_out, *, device: str | torch.device):
    """The four float32 tables of a JAX SGNS training state (numpy arrays)
    as tensors on ``device``, in the order the steps take them."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
                 for a in (w_in, w_out, acc_in, acc_out))


def _init_tables(rng: np.random.Generator, n_aids: int, n_out: int, d: int,
                 dev: torch.device):
    """``w_in`` uniform in +-1/d from the host generator (the reference's
    draw), the output table and both accumulators zero."""
    scale = 1.0 / d
    w_in = torch.as_tensor(rng.uniform(-scale, scale, size=(n_aids, d)).astype(np.float32),
                           device=dev)
    return (w_in, torch.zeros((n_out, d), device=dev), torch.zeros((n_aids, d), device=dev),
            torch.zeros((n_out, d), device=dev))


def _lrs(config: SGNSConfig, step: int, n: int, total: int) -> np.ndarray:
    """float32 learning rates of steps ``step .. step + n - 1`` of the
    linear decay over ``total`` steps, floored at ``min_learning_rate``."""
    min_ratio = config.min_learning_rate / config.learning_rate
    return config.learning_rate * np.maximum(
        1.0 - (step + np.arange(n)) / max(total, 1), min_ratio).astype(np.float32)


def train_sgns(
    store: EventStore,
    n_aids: int,
    config: SGNSConfig = SGNSConfig(),
    log_every: int = 200,
    checkpoint_dir: str | None = None,
    stop_after_epochs: int | None = None,
    pairs_out: dict | None = None,
    *,
    device: str | torch.device,
) -> "SGNSModel":
    """Train SGNS (``config.objective`` "ns") or hierarchical softmax ("hs")
    on host-generated skip-gram pairs, on ``device``.

    Each epoch draws pairs and a permutation with the host generator and
    ships ``steps_per_call`` batches of ``batch_centers`` pairs at a time
    (one pinned copy); the short tail wraps.  With ``checkpoint_dir`` the
    tables, accumulators and the device generator's state are saved after
    every epoch and training resumes from the latest epoch, replaying the
    host generator over the finished epochs; ``stop_after_epochs`` ends a
    run early (a simulated preemption).  ``pairs_out`` receives
    ``pairs_trained`` and ``steps`` of this call, ``train_s``, ``pairs_per_s`` and
    ``losses`` (the mean loss of each logged group, the last of each epoch
    included, as ``(epoch, group, loss)``).
    """
    from otto_tpu_torch.data.loader import BatchLoader
    from otto_tpu_torch.utils.checkpoint import CheckpointManager

    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)

    counts = np.bincount(store.aid, minlength=n_aids).astype(np.float64)
    cdf = negative_cdf(counts, config.ns_exponent, device=dev)
    use_hs = config.objective == "hs"
    n_out = n_aids
    if use_hs:  # the output table holds the V-1 Huffman inner nodes
        nodes, signs = build_huffman_paths(counts)
        hs_nodes = torch.as_tensor(nodes, dtype=torch.int64, device=dev)
        hs_signs = torch.as_tensor(signs, device=dev)
        n_out = max(n_aids - 1, 1)
        log.info("sgns: hierarchical softmax, max path depth %d", nodes.shape[1])
        del nodes, signs
    w_in, w_out, acc_in, acc_out = _init_tables(rng, n_aids, n_out, config.dim, dev)

    mgr = None
    start_epoch = 0
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir, max_to_keep=2)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest)
            for t, name in ((w_in, "w_in"), (w_out, "w_out"), (acc_in, "acc_in"),
                            (acc_out, "acc_out")):
                t.copy_(state[name])
            gen.set_state(state["generator"])
            start_epoch = latest
            log.info("sgns: resumed from epoch %d", start_epoch)

    B = config.batch_centers
    G = max(config.steps_per_call, 1)
    total_steps = None
    step = 0

    def epoch_groups(n_pairs: int) -> int:
        # must equal len(BatchLoader(..., G*B, drop_remainder=False)): the lr
        # schedule, loss logging and the resume replay all count on it
        return -(-n_pairs // (G * B)) if n_pairs else 0

    # replay the host generator over the finished epochs, so pairs continue
    # as in an uninterrupted run, and advance the lr schedule
    for _ in range(start_epoch):
        c, _x = skipgram_pairs(store, config.window, rng, subsample_t=config.subsample_t,
                               counts=counts)
        rng.permutation(len(c))
        ng = epoch_groups(len(c))
        if total_steps is None:
            total_steps = ng * G * config.epochs
        step += ng * G

    pairs_trained = 0
    step0 = step
    logged: list = []
    t_start = time.perf_counter()
    with full_f32_matmul():
        for epoch in range(start_epoch, config.epochs):
            c, x = skipgram_pairs(store, config.window, rng, subsample_t=config.subsample_t,
                                  counts=counts)
            perm = rng.permutation(len(c))
            n_groups = epoch_groups(len(c))
            if total_steps is None:
                total_steps = n_groups * G * config.epochs
            losses = []
            # centers and contexts of G steps as one [2, G*B] array: one copy
            loader = BatchLoader((c, x), G * B, order=perm, drop_remainder=False,
                                 transform=lambda a, b: (np.stack([a, b]),), device=dev)
            for i, (pairs,) in enumerate(loader):
                lrs = _lrs(config, step, G, total_steps)
                gc = pairs[0].view(G, B)
                gx = pairs[1].view(G, B)
                if use_hs:
                    pn, ps = hs_nodes[gx], hs_signs[gx]
                    step_losses = [hs_step(w_in, w_out, acc_in, acc_out, gc[g], pn[g], ps[g],
                                           float(lrs[g])) for g in range(G)]
                else:
                    negs = draw_negatives(cdf, negative_uniforms(gen, (G, B, config.negatives)))
                    step_losses = [sgns_step(w_in, w_out, acc_in, acc_out, gc[g], gx[g],
                                             negs[g], float(lrs[g])) for g in range(G)]
                step += G
                if (i + 1) % max(log_every // G, 1) == 0 or i == n_groups - 1:
                    losses.append((i, torch.stack(step_losses).mean()))
            ep = [(epoch + 1, i, float(v)) for i, v in losses]  # forced once an epoch
            logged += ep
            pairs_trained += len(c)
            log.info("sgns epoch %d/%d: %d pairs, loss %.4f", epoch + 1, config.epochs, len(c),
                     float(np.mean([v for *_, v in ep])) if ep else float("nan"))
            if mgr is not None:
                mgr.save(epoch + 1, {"w_in": w_in, "w_out": w_out, "acc_in": acc_in,
                                     "acc_out": acc_out, "generator": gen.get_state()})
            if stop_after_epochs is not None and epoch + 1 - start_epoch >= stop_after_epochs:
                log.info("sgns: stopping after %d epochs this run", stop_after_epochs)
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t_start
    if mgr is not None:
        mgr.close()
    if pairs_out is not None:
        pairs_out.update({"pairs_trained": int(pairs_trained), "steps": int(step - step0),
                          "train_s": train_s, "pairs_per_s": pairs_trained / max(train_s, 1e-9),
                          "losses": logged})
    return SGNSModel(w_in, w_out, torch.as_tensor(counts.astype(np.float32), device=dev),
                     config)


def _accept_pairs(aid_k: torch.Tensor, sidx_k: torch.Tensor, m: int, e, d, sign, b):
    """Draws of (event ``e``, offset ``d``, direction ``sign``, reduced
    window ``b``) over the kept stream's ``m`` events, kept where the
    context lies in the same session within ``b`` positions: the marginal
    pair distribution of :func:`skipgram_pairs`.  Rejected draws (out of
    the stream, past ``b``, across sessions, or center == context) point at
    row 0 with weight 0, so they scatter exact zeros.  Returns (centers,
    contexts, weight)."""
    ctx_e = e + sign * d
    in_range = (ctx_e >= 0) & (ctx_e < m)
    ctx_e = ctx_e.clamp(0, m - 1)
    centers = aid_k[e]
    contexts = aid_k[ctx_e]
    ok = in_range & (b >= d) & (sidx_k[e] == sidx_k[ctx_e]) & (centers != contexts)
    zero = torch.zeros((), dtype=centers.dtype, device=centers.device)
    return (torch.where(ok, centers, zero), torch.where(ok, contexts, zero),
            ok.to(torch.float32))


def _device_pairs(gen: torch.Generator, aid_k: torch.Tensor, sidx_k: torch.Tensor, m: int,
                  batch: int, window: int):
    """``batch`` i.i.d. draws from ``gen`` through :func:`_accept_pairs`."""
    dev = aid_k.device
    e = torch.randint(0, m, (batch,), generator=gen, device=dev)
    d = torch.randint(1, window + 1, (batch,), generator=gen, device=dev)
    sign = torch.where(torch.rand(batch, generator=gen, device=dev) < 0.5, 1, -1)
    b = torch.randint(1, window + 1, (batch,), generator=gen, device=dev)
    return _accept_pairs(aid_k, sidx_k, m, e, d, sign, b)


def train_sgns_device(
    store: EventStore,
    n_aids: int,
    config: SGNSConfig = SGNSConfig(),
    steps_per_dispatch: int = 512,
    pairs_out: dict | None = None,
    shared_negatives: int | None = None,
    max_steps_per_epoch: int = 0,
    progress_every: int = 0,
    *,
    device: str | torch.device,
) -> "SGNSModel":
    """SGNS with every pair sampled on ``device``: the subsampled event
    stream goes up once an epoch and each step draws its pairs there
    (:func:`_device_pairs`).

    An epoch runs ``2 * m * window`` draws (m kept events), the host
    generator's expected pair count over its acceptance rate, rounded up to
    whole batches and then to whole ``steps_per_dispatch`` groups; the step
    count is fixed by the first epoch.  ``shared_negatives`` switches the
    loss to the shared-negative form (:func:`sgns_shared_neg_step`); ``None``
    means ``max(batch // 8, negatives)`` when ``negatives >= 16`` and per-pair
    negatives otherwise.  ``max_steps_per_epoch`` caps an epoch at whole
    groups (the uncapped count is logged); ``progress_every`` logs the loss
    every that many groups.  ``pairs_out`` receives ``pairs_trained``,
    ``train_s``, ``pairs_per_s``, ``shared_negatives`` and ``epoch_log``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)

    counts = np.bincount(store.aid, minlength=n_aids).astype(np.float64)
    cdf = negative_cdf(counts, config.ns_exponent, device=dev)
    w_in, w_out, acc_in, acc_out = _init_tables(rng, n_aids, n_aids, config.dim, dev)

    B = config.batch_centers
    if shared_negatives is None:
        shared_negatives = max(B // 8, config.negatives) if config.negatives >= 16 else 0
    n = store.n_events
    freq = counts[store.aid] / max(counts.sum(), 1)
    t0_all = time.perf_counter()
    total_pairs = 0
    n_steps_total = None
    step = 0
    epoch_log: list[dict] = []
    with full_f32_matmul():
        for epoch in range(config.epochs):
            t_h = time.perf_counter()
            if config.subsample_t > 0:
                p_keep = (np.sqrt(config.subsample_t / np.maximum(freq, 1e-12))
                          + config.subsample_t / np.maximum(freq, 1e-12))
                keep = rng.random(n) < np.minimum(p_keep, 1.0)
            else:
                keep = np.ones(n, bool)
            aid_k = torch.as_tensor(store.aid[keep].astype(np.int64), device=dev)
            sidx_k = torch.as_tensor(store.session_idx[keep].astype(np.int64), device=dev)
            m = int(keep.sum())
            host_s = time.perf_counter() - t_h
            if n_steps_total is None:
                n_steps_epoch = max(-(-2 * m * config.window // B), 1)
                n_steps_epoch = -(-n_steps_epoch // steps_per_dispatch) * steps_per_dispatch
                n_steps_epoch_full = n_steps_epoch
                if max_steps_per_epoch:
                    n_steps_epoch = min(n_steps_epoch, max(
                        -(-max_steps_per_epoch // steps_per_dispatch), 1) * steps_per_dispatch)
                n_steps_total = n_steps_epoch * config.epochs
            losses = []
            kept = torch.zeros((), dtype=torch.float32, device=dev)
            t_ep = time.perf_counter()
            for s0 in range(0, n_steps_epoch if m else 0, steps_per_dispatch):
                lrs = _lrs(config, step, steps_per_dispatch, n_steps_total)
                step_losses = []
                for g in range(steps_per_dispatch):
                    centers, contexts, w = _device_pairs(gen, aid_k, sidx_k, m, B,
                                                         config.window)
                    if shared_negatives:
                        negs = draw_negatives(cdf, torch.rand(shared_negatives, generator=gen,
                                                              device=dev))
                        step_losses.append(sgns_shared_neg_step(
                            w_in, w_out, acc_in, acc_out, centers, contexts, w, negs,
                            float(lrs[g]), config.negatives))
                    else:
                        negs = draw_negatives(cdf, torch.rand((B, config.negatives),
                                                              generator=gen, device=dev))
                        step_losses.append(sgns_step(w_in, w_out, acc_in, acc_out, centers,
                                                     contexts, negs, float(lrs[g]), weight=w))
                    kept += w.sum()
                losses.append(torch.stack(step_losses).mean())
                step += steps_per_dispatch
                if progress_every and (s0 // steps_per_dispatch + 1) % progress_every == 0:
                    el = time.perf_counter() - t_ep
                    log.info("sgns-device epoch %d: %d/%d steps, %.0fk draws/s, loss %.4f",
                             epoch + 1, s0 + steps_per_dispatch, n_steps_epoch,
                             (s0 + steps_per_dispatch) * B / max(el, 1e-9) / 1e3,
                             float(losses[-1]))
            ep_kept = int(kept)
            ep_loss = float(losses[-1]) if losses else float("nan")
            total_pairs += ep_kept
            epoch_log.append({"host_prep_s": host_s, "kept_events": m, "pairs": ep_kept,
                              "loss": ep_loss, "steps_run": int(n_steps_epoch),
                              "steps_full_epoch": int(n_steps_epoch_full),
                              "step_s": time.perf_counter() - t_ep})
            log.info("sgns-device epoch %d/%d: %d pairs (%d steps, accept %.2f), loss %.4f",
                     epoch + 1, config.epochs, ep_kept, n_steps_epoch,
                     ep_kept / max(n_steps_epoch * B, 1), ep_loss)
    train_s = time.perf_counter() - t0_all
    if pairs_out is not None:
        pairs_out.update({"pairs_trained": int(total_pairs), "train_s": train_s,
                          "pairs_per_s": total_pairs / max(train_s, 1e-9),
                          "shared_negatives": int(shared_negatives), "epoch_log": epoch_log})
    log.info("sgns-device: %d pairs in %.1fs", total_pairs, train_s)
    return SGNSModel(w_in, w_out, torch.as_tensor(counts.astype(np.float32), device=dev),
                     config)


@dataclass
class SGNSModel:
    """Trained SGNS tables on one device (the trainers return one)."""

    w_in: torch.Tensor  # [n_aids, d] float32 — the "word vectors"
    w_out: torch.Tensor
    counts: torch.Tensor
    config: SGNSConfig

    @property
    def embeddings(self) -> torch.Tensor:
        return self.w_in

    @property
    def device(self) -> torch.device:
        return self.w_in.device

    def neighbor_table(self, k: int, metric: str = "euclidean", **kw) -> np.ndarray:
        return build_neighbor_table(self.w_in, k=k, metric=metric, device=self.device, **kw)

    @classmethod
    def from_jax_arrays(cls, w_in, w_out, counts, config: SGNSConfig = SGNSConfig(), *,
                        device: str | torch.device) -> "SGNSModel":
        """From the numpy arrays of an ``otto_tpu`` ``SGNSModel``."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        return cls(t(w_in), t(w_out), t(counts), config)

    def save(self, path) -> None:
        """The ``.npz`` of ``otto_tpu``'s ``SGNSModel.save`` (the same keys;
        stored, not deflated: a trained float32 table hardly compresses,
        and deflating 1,855,603 x 32 x 2 floats takes seconds)."""
        np.savez(path, w_in=self.w_in.cpu().numpy(), w_out=self.w_out.cpu().numpy(),
                 counts=self.counts.cpu().numpy())

    @classmethod
    def load(cls, path, config: SGNSConfig = SGNSConfig(), *,
             device: str | torch.device) -> "SGNSModel":
        """Read an ``.npz`` written by either package's ``save``."""
        with np.load(path) as z:
            return cls.from_jax_arrays(z["w_in"], z["w_out"], z["counts"], config,
                                       device=device)


def recursive_neighbors(table: np.ndarray, start_aid: int, n: int,
                        exclude: set[int]) -> list[int]:
    """Greedy neighbor-graph walk: repeatedly append the nearest unseen
    neighbor of the current aid (gensim_fasttext/inference.py:124-141)."""
    out: list[int] = []
    current = start_aid
    seen = set(exclude)
    seen.add(start_aid)  # the query aid itself is never a neighbor
    for _ in range(n):
        advanced = False
        for cand in table[current]:
            cand = int(cand)
            if cand < 0 or cand in seen or cand in out:
                continue
            out.append(cand)
            seen.add(cand)
            current = cand
            advanced = True
            break
        if not advanced:
            break
    return out


def embedding_knn_predictions(
    store: EventStore,
    neighbor_table: np.ndarray,
    k: int = TOP_K,
    recursive: bool = False,
    *,
    device: str | torch.device,
) -> dict[str, np.ndarray]:
    """Full serving path of the embedding model over an EventStore; the
    recency route runs on ``device``, the kNN route on the host."""
    from otto_tpu_torch.models.covisitation import sessions_with_distinct_at_least
    from otto_tpu_torch.ops.sessions import recency_weighted_top_aids

    dev = resolve_device(device)
    recency = sessions_with_distinct_at_least(store, 20)
    S = store.n_sessions
    preds = np.full((S, k), -1, np.int32)

    rec_idx = np.flatnonzero(recency)
    knn_idx = np.flatnonzero(~recency)

    if len(rec_idx):
        sub = store.select_sessions(rec_idx)
        packed = sub.pack(max_len=256, keep="last")

        def t(a):
            return torch.as_tensor(a, device=dev)

        top, _ = recency_weighted_top_aids(
            t(packed.aids), t(packed.types), t(packed.mask), t(packed.lengths),
            torch.tensor([1.0, 6.0, 3.0], dtype=torch.float32, device=dev),
            k=k, lo=0.1, hi=1.0,
        )
        preds[rec_idx] = top.cpu().numpy()

    if len(knn_idx):
        last = store.last_aid()
        for s in knn_idx:
            lo, hi = store.offsets[s], store.offsets[s + 1]
            uniq = np.unique(store.aid[lo:hi]).tolist()  # ascending, reference :86
            if recursive:
                nns = recursive_neighbors(
                    neighbor_table, int(last[s]), k - len(uniq), set(uniq)
                )
            else:
                # no dedup against the session aids here — parity with the
                # reference, whose non-recursive branch concatenates raw kNN
                # rows (gensim_fasttext/inference.py:143-155:
                # `predictions = session_unique_aids + nearest_neighbors`);
                # only the recursive walk excludes them (:127-140)
                nns = [int(a) for a in neighbor_table[int(last[s])] if a >= 0]
            row = (uniq + nns)[:k]
            preds[s, : len(row)] = row
    return {etype: preds for etype in EVENT_TYPES}


# ---------------------------------------------------------------------------
# Doc2Vec analog: session vectors pooled from the trained item table (the
# reference trains gensim Doc2Vec session embeddings, src/gensim_fasttext/
# trainer.py:41-59).  Session vectors are recency-weighted sums of SGNS item
# vectors, normalized; similar sessions come from the exact dot-product scan.
# ---------------------------------------------------------------------------


def session_embeddings(store: EventStore, item_emb, weighting: str = "recency", *,
                       device: str | torch.device) -> torch.Tensor:
    """L2-normalized pooled session vectors, float32 [S, d] on ``device``.

    ``weighting='recency'`` uses the reference's logspace(0.1, 1, base 2) - 1
    recency profile per session (weights in float64 on the host, as the
    reference computes them); 'mean' is uniform.  The per-session sum is an
    ``index_add_``: on the card its order, and so its last bits, vary.
    """
    dev = resolve_device(device)
    items = torch.as_tensor(item_emb, dtype=torch.float32, device=dev)
    lengths = store.lengths.astype(np.float64)
    pos = store.position_in_session.astype(np.float64)
    if weighting == "recency":
        n = lengths[store.session_idx]
        lo, hi = 0.1, 1.0
        expo = np.where(n > 1, lo + (hi - lo) * pos / np.maximum(n - 1, 1), hi)
        w = (np.power(2.0, expo) - 1.0).astype(np.float32)
    elif weighting == "mean":
        w = np.ones(store.n_events, np.float32)
    else:
        raise ValueError(weighting)
    aid = torch.as_tensor(store.aid.astype(np.int64), device=dev)
    sidx = torch.as_tensor(store.session_idx.astype(np.int64), device=dev)
    vec = torch.zeros((store.n_sessions, items.shape[1]), dtype=torch.float32, device=dev)
    vec.index_add_(0, sidx, items[aid] * torch.as_tensor(w, device=dev)[:, None])
    norms = torch.linalg.vector_norm(vec, dim=1, keepdim=True)
    return vec / norms.clamp(min=1e-9)


@dataclass
class SessionEmbeddingModel:
    """Similar-session recommender over pooled session vectors (Doc2Vec
    analog; retrieval mirrors src/tfidf/inference.py:83-96's similar-session
    aid gathering).  Vectors and item table live on one device."""

    vectors: torch.Tensor  # [S_corpus, d] normalized
    corpus: EventStore
    item_emb: torch.Tensor
    weighting: str = "recency"

    @classmethod
    def fit(cls, corpus: EventStore, item_emb, weighting: str = "recency", *,
            device: str | torch.device) -> "SessionEmbeddingModel":
        dev = resolve_device(device)
        items = torch.as_tensor(item_emb, dtype=torch.float32, device=dev)
        return cls(session_embeddings(corpus, items, weighting, device=dev), corpus, items,
                   weighting)

    def similar_session_predictions(self, queries: EventStore, n_similar: int = 5,
                                    k: int = TOP_K, query_batch: int = 4096
                                    ) -> dict[str, np.ndarray]:
        from otto_tpu_torch.models.tfidf import retrieve_similar_session_aids

        dev = self.vectors.device
        qv = session_embeddings(queries, self.item_emb, self.weighting, device=dev)
        preds = retrieve_similar_session_aids(qv, self.vectors, self.corpus,
                                              n_similar=n_similar, k=k,
                                              query_batch=query_batch, device=dev)
        return {etype: preds for etype in EVENT_TYPES}
