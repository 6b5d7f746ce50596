"""The import check: top-level names compared whole."""

import pytest

from benchkit.guard import forbidden_modules


@pytest.mark.parametrize("names,found", [
    (["otto_tpu_torch", "otto_tpu_torch.models.sequence", "numpy", "torch"], []),
    (["otto_tpu", "numpy"], ["otto_tpu"]),
    (["otto_tpu.models"], ["otto_tpu.models"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client", "flax.linen", "jaxtyping"], ["flax.linen", "jaxlib.xla_client"]),
])
def test_forbidden_modules(names, found):
    assert forbidden_modules(names) == found

