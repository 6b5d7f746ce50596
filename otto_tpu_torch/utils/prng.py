"""Global seeding (reference: src/matrix_factorization/torch_utils.py:7-30).

Port of ``otto_tpu/utils/prng.py``: seeds the host-side generators (python,
numpy) that data preparation uses and torch's default generators, and
returns a ``torch.Generator`` seeded the same, the counterpart of the JAX
package's root key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def host_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)
