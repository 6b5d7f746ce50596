"""Profile the PyTorch port's sequence-model training step on a card.

    python3 tools/profile_sequence_step.py [gru stamp moe ...]

For each named published config (``configs/sequence_<name>.yaml``; default
gru, stamp and moe) over the full 1,855,603-aid catalog: one seeded batch
of a synthetic store's training examples and negatives on the card, three
warm-up steps, the wall ms of ten steps (synchronised), then five steps
under ``torch.profiler``: the card's busy time a step and the operators by
device time.  Prints the card's name and power limit first.  Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPO = Path(__file__).resolve().parent.parent
N_AIDS = 1_855_603  # chip_smoke.py's catalog
TOP = 14  # operators listed


def main(names) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from otto_tpu_torch.config import SequenceModelConfig
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.models import sequence as sq

    if not torch.cuda.is_available():
        print("profile_sequence_step: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    store = synthetic_events_v2(n_sessions=20_000, n_aids=N_AIDS, seed=20260101)
    for name in names:
        cfg = SequenceModelConfig.from_yaml(REPO / "configs" / f"sequence_{name}.yaml").replace(
            n_aids=N_AIDS)
        seqs, masks, targets = sq._training_examples(store, cfg.max_len, N_AIDS)
        rng = np.random.default_rng(0)
        sel = rng.permutation(len(targets))[:cfg.batch_size]
        negs = rng.integers(0, N_AIDS, (cfg.batch_size, cfg.n_negatives)).astype(np.int32)
        batch = tuple(torch.as_tensor(a, device=dev)
                      for a in (seqs[sel], masks[sel], targets[sel], negs))
        params = sq._tree_map(lambda t: t.to(dev).requires_grad_(True),
                              sq._config_params(cfg, torch.Generator().manual_seed(1)))
        opt = sq.make_optimizer(params, cfg)

        def step():
            sq.train_step(params, opt, *batch, loss=cfg.loss, bpr_reg=cfg.bpr_reg)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA  # kernels and copies, one stream
        busy = sum(e.self_device_time_total for e in events if e.device_type == cuda) / 5 / 1e3
        print(f"{name}: {wall:.3f} ms a step (wall, 10 steps); the card busy {busy:.3f} ms a "
              f"step under the profiler", flush=True)
        print(events.table(sort_by="self_cuda_time_total", row_limit=TOP,
                           max_name_column_width=60), flush=True)
        del params, opt, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["gru", "stamp", "moe"]))
