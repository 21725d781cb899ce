"""Gradient parity with the JAX package for the attention families
(dense, audio, and olmoe's moe): loss and every gradient leaf of
next-token cross-entropy (explicit labels for the audio stub) plus the
MoE's aux loss, through its sort and inverse-sort combine, and one
``train_step``'s metrics.  The other families are in
``test_torch_train_grads_families.py``; tolerances in ``train_parity``."""
import pytest

from lm_parity import one_torch_thread  # noqa: F401
from train_parity import check_pair, run_pair


@pytest.mark.parametrize("arch", ["yi-34b", "llama3-8b", "internlm2-1.8b",
                                  "granite-3-8b", "musicgen-large",
                                  "olmoe-1b-7b"])
def test_gradients_match_jax(arch):
    check_pair(run_pair(arch))
