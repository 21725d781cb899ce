"""Gradient parity with the JAX package for granite-moe's moe and the
recurrent and cross-attending families (ssm, hybrid, vlm): through the
SSD chunked scan, the hybrid's shared block and the vlm's cross blocks.  As
``test_torch_train_grads.py``; tolerances in ``train_parity``."""
import pytest

from lm_parity import one_torch_thread  # noqa: F401
from train_parity import check_pair, run_pair


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-2.7b",
                                  "zamba2-2.7b", "llama-3.2-vision-90b"])
def test_gradients_match_jax(arch):
    check_pair(run_pair(arch))
