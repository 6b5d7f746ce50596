"""Matrix factorization and collaborative filtering on the card against
the CPU, and the NaN guard on card tensors.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mf.py

Tolerances: the tables and accumulators within 1e-4 * (|cpu| + 0.01) and
the loss within 1e-5 relative (float ``index_add_`` on the card adds
duplicate rows with atomics, in another order than the CPU's loop: the
SGNS steps' bar); a short training run's history within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import CFConfig, MFConfig
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.models import matrix_factorization as tmf
from otto_tpu_torch.utils.checkpoint import CheckpointManager
from otto_tpu_torch.utils.failure import TrainingGuard, nonfinite_count

RTOL, FLOOR, LOSS_RTOL = 1e-4, 1e-2, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _worst(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu().double(), b.cpu().double()
    return float(((a - b).abs() / (b.abs() + FLOOR)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mf", "cf"])
def test_cuda_sparse_step_matches_cpu(cuda_device, kind):
    """One step at B 65,536 with hot rows repeated many times a batch."""
    rng = np.random.default_rng(4)
    B, D, V, S = 65_536, 32, 50_000, 200_000
    aids = np.minimum(rng.zipf(1.3, 2 * B), V) - 1
    if kind == "mf":
        names, lookups = ["session_embeddings", "aid_embeddings"], \
            (("session_embeddings", 0), ("aid_embeddings", 1))
        shapes = [(S, D), (V, D)]
        batch = [rng.integers(0, S, B), aids[:B], rng.integers(0, 3, B).astype(np.float32)]
    else:
        names, lookups = ["embeddings"], (("embeddings", 0), ("embeddings", 1))
        shapes = [(V, D)]
        batch = [aids[:B], aids[B:], (rng.random(B) < 0.5).astype(np.float32)]
    tables = {n: (rng.normal(size=s) * 0.3).astype(np.float32) for n, s in zip(names, shapes)}
    accs = {n: rng.uniform(0, 0.5, s).astype(np.float32) for n, s in zip(names, shapes)}
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        t = {n: torch.tensor(v, device=dev) for n, v in tables.items()}
        a = {n: torch.tensor(v, device=dev) for n, v in accs.items()}
        b = [torch.tensor(x, device=dev) for x in batch]
        loss = float(tmf.sparse_step(t, a, lookups, "mse" if kind == "mf" else "bce", 0.05, *b))
        out[dev.type] = loss, t, a
    (l_cpu, t_cpu, a_cpu), (l_dev, t_dev, a_dev) = out["cpu"], out["cuda"]
    assert abs(l_dev - l_cpu) <= LOSS_RTOL * abs(l_cpu)
    for n in names:
        assert t_dev[n].is_cuda
        assert _worst(t_dev[n], t_cpu[n]) <= RTOL
        assert _worst(a_dev[n], a_cpu[n]) <= RTOL
        assert not torch.equal(t_dev[n].cpu(), torch.tensor(tables[n]))  # updated


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mf", "cf"])
def test_cuda_trainer_matches_cpu(cuda_device, kind):
    store = synthetic_events(n_sessions=3000, n_aids=2000, mean_length=8.0, seed=5)
    if kind == "mf":
        cfg = MFConfig(n_aids=2000, n_factors=32, epochs=3, batch_size=4096,
                       learning_rate=0.05)
        runs = [tmf.train_mf(store, 2000, cfg, device=d) for d in ("cpu", cuda_device)]
        pairs = [(r.session_embeddings, r.aid_embeddings) for r in runs]
    else:
        cfg = CFConfig(n_aids=2000, n_factors=32, epochs=3, batch_size=4096,
                       learning_rate=0.05)
        runs = [tmf.train_cf(store, 2000, cfg, device=d) for d in ("cpu", cuda_device)]
        pairs = [(r.embeddings,) for r in runs]
    (cpu, card) = runs
    assert [h["epoch"] for h in card.history] == [h["epoch"] for h in cpu.history]
    for hc, hd in zip(cpu.history, card.history):
        for key in ("train_loss", "val_loss"):
            assert hd[key] == pytest.approx(hc[key], rel=LOSS_RTOL)
    for a, b in zip(*pairs[::-1]):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert _worst(torch.tensor(a), torch.tensor(b)) <= RTOL


@pytest.mark.cuda
def test_cuda_guard_rolls_back_card_tensors(cuda_device, tmp_path):
    rng = np.random.default_rng(2)
    state = {"tables": {"session_embeddings": torch.randn(500, 8, device=cuda_device) * 0.05,
                        "aid_embeddings": torch.randn(300, 8, device=cuda_device) * 0.05},
             "accs": {"session_embeddings": torch.zeros(500, 8, device=cuda_device),
                      "aid_embeddings": torch.zeros(300, 8, device=cuda_device)}}
    lookups = (("session_embeddings", 0), ("aid_embeddings", 1))
    mgr = CheckpointManager(tmp_path / "ck")
    guard = TrainingGuard(mgr, save_every=2)
    step, rolled = 0, False
    while step < 6:
        step += 1
        b = [torch.tensor(rng.integers(0, 500, 256), device=cuda_device),
             torch.tensor(rng.integers(0, 300, 256), device=cuda_device),
             torch.tensor(rng.integers(0, 3, 256).astype(np.float32), device=cuda_device)]
        if step == 5 and not rolled:
            state["tables"]["aid_embeddings"][b[1][0]] = float("nan")
            assert int(nonfinite_count(state)) == 8
        loss = tmf.sparse_step(state["tables"], state["accs"], lookups, "mse", 0.05, *b)
        state, step, ok = guard.observe(step, state, loss)
        if not ok:
            rolled = True
            assert step == 4
            saved = mgr.restore(4)
            for part in ("tables", "accs"):
                for name, t in state[part].items():
                    assert t.is_cuda and torch.equal(t.cpu(), saved[part][name])
    assert rolled and guard.rollbacks == 1 and guard.failures[0]["step"] == 5
    assert int(nonfinite_count(state)) == 0
