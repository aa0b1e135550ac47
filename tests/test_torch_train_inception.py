"""The mini-Inception trajectory of tests/test_torch_train.py: three
training steps of the port against the JAX package (kernels 7 and 8 in
interpret mode there), float32 within 1e-4 and bfloat16 compute within
2e-2.  In a file of its own so that xdist runs it beside the AlexNet one.
"""

import pytest
from test_torch_train import check_three_steps, pallas_on  # noqa: F401


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(machine1, pallas_on, dtype):  # noqa: F811
    check_three_steps(machine1, "mini_inception", dtype)
