"""The listwise tower on the card against the CPU.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ranker.py

Tolerances (those of ``chip_smoke.py`` phase 13a): scores, 99% within
1e-5 * (|s| + 1e-3) and every one within 4e-3 * max |s| (cuBLAS sums the
float32 products in another order, and where a hidden unit's two sums differ
in their last bit its bfloat16 rounding can differ by an ulp of bfloat16);
one step's loss within 1e-5 relative in float32 compute and 1e-4 in
bfloat16, the updated parameters within 2 * lr (Adam's first step moves a
tiny gradient by about +-lr).
"""

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.models import ranker as trk

F = 55
WIDTHS = (256, 256, 128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _within_limits(got, want):
    d = np.abs(got - want)
    assert (d <= 1e-5 * (np.abs(want) + 1e-3)).mean() >= 0.99
    assert d.max() <= 4e-3 * np.abs(want).max()


def _params(seed):
    params = trk.tower_params_to_numpy(trk.Tower(trk.init_tower(
        F, WIDTHS, torch.Generator().manual_seed(seed))))
    rng = np.random.default_rng(seed)
    for k in params:
        if k.startswith("b"):
            params[k] = (rng.normal(size=params[k].shape) * 0.1).astype(np.float32)
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_cuda_forward_matches_cpu(cuda_device, compute):
    rng = np.random.default_rng(1)
    params = _params(1)
    x = (rng.normal(size=(512, 184, F)) * 3).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        tower = trk.tower_params_from_numpy(params, device=dev)
        with torch.no_grad(), trk.full_f32_matmul():
            out.append(tower(torch.as_tensor(x, device=dev),
                             compute_dtype=getattr(torch, compute)).cpu().numpy())
    _within_limits(out[1], out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["lambdarank", "listwise_softmax", "bce"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_cuda_step_matches_cpu(cuda_device, loss, compute):
    rng = np.random.default_rng(2)
    params = _params(2)
    x = rng.normal(size=(512, 184, F)).astype(np.float32)
    y = (rng.random((512, 184)) < 0.1).astype(np.int8)
    m = rng.random((512, 184)) < 0.9
    cfg = RankerConfig()
    out = []
    for dev in ("cpu", cuda_device):
        tower = trk.tower_params_from_numpy(params, device=dev)
        value = trk.train_step(tower, trk.make_optimizer(tower, cfg),
                               *(torch.as_tensor(a, device=dev) for a in (x, y, m)),
                               trk.learning_rate(cfg, 0), loss=loss,
                               compute_dtype=getattr(torch, compute))
        out.append((float(value), trk.tower_params_to_numpy(tower)))
    (cpu_loss, cpu), (card_loss, card) = out
    assert card_loss == pytest.approx(cpu_loss, rel=1e-5 if compute == "float32" else 1e-4)
    for k in cpu:
        assert np.abs(card[k] - cpu[k]).max() <= 2 * cfg.learning_rate, k


@pytest.mark.cuda
def test_cuda_predict_rows_matches_cpu(cuda_device):
    """Two folds' fold average over rows of heavy-tailed features (the
    normalizer on the device), card against CPU; ``predict`` gives the same
    bits as ``predict_rows`` on each device."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(600, 184, F)).astype(np.float32)
    feats[..., :10] = rng.lognormal(0.0, 3.0, (600, 184, 10))
    mask = rng.random((600, 184)) < 0.95
    model = trk.RankerModel([_params(4), _params(5)],
                            trk.FeatureNormalizer.fit(feats, mask), RankerConfig())
    out = []
    for dev in ("cpu", cuda_device):
        rows = model.predict_rows(torch.as_tensor(feats.reshape(-1, F), device=dev))
        assert rows.device.type == torch.device(dev).type
        scores = model.predict(feats, mask, device=dev)
        np.testing.assert_array_equal(scores[mask], rows.cpu().numpy().reshape(mask.shape)[mask])
        out.append(scores[mask])
    _within_limits(out[1], out[0])


@pytest.mark.cuda
def test_cuda_train_ranker_learns(cuda_device):
    """``train_ranker`` on the card: labels that follow feature 0 are
    ranked far above chance (the OOF scores' AUC above 0.7; chance is 0.5,
    the CPU gives 0.78 on these inputs), and the loss falls in every
    fold."""
    rng = np.random.default_rng(6)
    S, C = 600, 32
    feats = rng.normal(size=(S, C, F)).astype(np.float32)
    labels = (rng.random((S, C)) < 1 / (1 + np.exp(-2.0 * feats[:, :, 0] + 2.0))).astype(np.int8)
    mask = np.ones((S, C), bool)
    data = trk.RankerData(feats, labels, mask, np.arange(S), np.zeros((S, C), np.int32))
    cfg = RankerConfig(hidden_dims=(32, 16), n_folds=3, epochs=6, batch_sessions=64,
                       learning_rate=1e-2)
    for dev in ("cpu", cuda_device):
        model, oof = trk.train_ranker(data, cfg, device=dev)
        assert all(e[-1] < e[0] for e in model.epoch_losses)
        pos, neg = oof[labels == 1], oof[labels == 0]
        assert (pos[:, None] > neg[None, :1000]).mean() > 0.7
