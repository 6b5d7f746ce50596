"""The SGNS steps and ``train_sgns`` on the card against the CPU.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sgns.py

Tolerances: a step's tables and accumulators within tol * (|cpu| + 0.01),
its loss within 1e-5 relative.  Float ``index_add_`` on the card adds with
atomics, in another order: on these inputs the CPU's float32 step differs
from float64 by at most 1e-5 * (|x| + 0.01) (hs: 4e-5, every pair updates
the Huffman root), so tol is 1e-4 (hs 4e-4), the card being as far from
the exact sums again.  Training runs are compared by what they learn (the
cluster structure of ``tests/test_embeddings.py``), since the card's sums
are not bit-reproducible.
"""

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import SGNSConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.models import embeddings as temb


def _state(V, D, n_out, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(V, D)) * 0.3).astype(np.float32),
            (rng.normal(size=(n_out, D)) * 0.3).astype(np.float32),
            rng.uniform(0, 0.5, (V, D)).astype(np.float32),
            rng.uniform(0, 0.5, (n_out, D)).astype(np.float32))


def _cluster_store(seed=0, S=2000, L=10, n_clusters=4, per=10):
    rng = np.random.default_rng(seed)
    clus = rng.integers(0, n_clusters, S)
    aid = (np.repeat(clus, L) * per + rng.integers(0, per, S * L)).astype(np.int64)
    return EventStore.from_flat(np.repeat(np.arange(S), L), aid, np.tile(np.arange(L), S),
                                np.zeros(S * L, np.int8))


def _cluster_ratio(emb, per):
    emb = np.asarray(emb)
    d = np.linalg.norm(emb[:, None] - emb[None], axis=-1)
    same = (np.arange(len(emb))[:, None] // per) == (np.arange(len(emb))[None] // per)
    off = ~np.eye(len(emb), dtype=bool)
    return d[same & off].mean() / d[~same].mean()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["ns", "weighted", "shared", "hs"])
def test_cuda_step_matches_cpu(cuda_device, step):
    """Each step on the card against the CPU on the same inputs, duplicates
    included; float atomics add in another order, hence the tolerance."""
    V, D, B, N = 5000, 32, 8192, 40
    rng = np.random.default_rng(9)
    state = _state(V, D, V - 1 if step == "hs" else V, seed=10)
    centers, contexts = rng.integers(0, 1000, B), rng.integers(0, 1000, B)
    weight = (rng.random(B) < 0.7).astype(np.float32)
    nodes, signs = temb.build_huffman_paths(rng.integers(1, 100, V).astype(np.float64))
    negs = rng.integers(0, V - 1, (1024,) if step == "shared" else (B, N))
    outs = []
    for dev in ("cpu", cuda_device):
        s = temb.sgns_state_from_jax(*state, device=dev)

        def t(a, dt=torch.int64):
            return torch.as_tensor(a, dtype=dt, device=dev)

        with temb.full_f32_matmul():
            if step == "hs":
                loss = temb.hs_step(*s, t(centers), t(nodes[contexts]),
                                    t(signs[contexts], torch.int8), 0.05)
            elif step == "shared":
                loss = temb.sgns_shared_neg_step(*s, t(centers), t(contexts),
                                                 t(weight, torch.float32), t(negs), 0.05, N)
            else:
                w = t(weight, torch.float32) if step == "weighted" else None
                loss = temb.sgns_step(*s, t(centers), t(contexts), t(negs), 0.05, weight=w)
        outs.append([float(loss)] + [a.cpu().numpy() for a in s])
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    for g, w in zip(outs[1][1:], outs[0][1:]):
        assert (np.abs(g - w) <= (4e-4 if step == "hs" else 1e-4) * (np.abs(w) + 0.01)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_cuda_train_sgns_learns_like_cpu(cuda_device, objective):
    ts = _cluster_store()
    cfg = SGNSConfig(dim=8, window=4, negatives=5, epochs=15, batch_centers=8192,
                     subsample_t=0, objective=objective)
    for dev in ("cpu", cuda_device):
        model = temb.train_sgns(ts, 40, cfg, device=dev)
        assert model.w_in.device.type == torch.device(dev).type
        assert _cluster_ratio(model.embeddings.cpu(), 10) < 0.7
