"""The LM models of the port against the JAX package, on the same weights
and inputs: the MoE, SSM, vision-language and hybrid families (the
router, the SSD scan, the grouped vlm / hybrid stacks, zamba2's shared
block and the cross-attention cache).  ``forward`` (logits and the MoE
aux), ``prefill`` (last logits and every cache entry) and three
``decode_step``s.  Tolerances and their measured sources are in
``lm_parity``."""
import numpy as np
import pytest

from lm_parity import (F32, N_DECODE, check_stage,  # noqa: F401
                        one_torch_thread, run_pair)

ARCHS = ["granite-moe-3b-a800m", "olmoe-1b-7b", "mamba2-2.7b",
         "llama-3.2-vision-90b", "zamba2-2.7b"]
STAGES = ["forward", "prefill"] + [f"decode{i}" for i in range(N_DECODE)]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return run_pair(request.param)


@pytest.mark.parametrize("stage", STAGES)
def test_matches_jax(pair, stage):
    check_stage(pair, stage, F32)


def test_carried_jax_cache_decodes_the_same(pair):
    np.testing.assert_allclose(pair["port"]["carried"],
                               pair["jax"]["carried"], **F32["logits"])
