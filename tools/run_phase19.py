"""Run ``chip_smoke.py``'s phase 19 (the oracle-parity tool and examples
03, 06 and 07 on the card) alone.

    python3 tools/run_phase19.py

With ``chip_smoke.py``'s own functions and checks: 19a, the port's
heuristic (both recency routes) and candidate generator against the oracle
at 100,000 sessions over 100,000 aids; 19b, the three examples through
their ``main`` with each path's kernel launches.  Prints the card's name and
power limit first and ``phase 19 ok`` last; needs a CUDA card and imports
nothing of JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from otto_tpu_torch.utils.runtime import device_line  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("run_phase19: needs a CUDA card", file=sys.stderr)
        return 2
    print(device_line("cuda"), flush=True)
    print(f"torch {torch.__version__}", flush=True)
    from otto_tpu_torch.ops import _kernels

    _kernels.lib()
    zero, read = cs.kernel_counters()
    with cs.phase("19 the oracle-parity tool and the examples on the card"):
        cs.phase19(torch, torch.device("cuda", 0), zero, read)
    print("phase 19 ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
