"""The LM models of the port against the JAX package, on the same weights
and inputs: the attention families without routing (dense, audio) and a
bf16 variant of the llama3-8b smoke config.  ``forward``, ``prefill``
(last logits and every cache entry) and three ``decode_step``s; the
other families are in ``test_torch_lm_model_families.py``.  Tolerances
and their measured sources are in ``lm_parity``."""
import numpy as np
import pytest

from lm_parity import (BF16, F32, N_DECODE, check_stage,  # noqa: F401
                        one_torch_thread, run_pair)

CASES = [("yi-34b", None), ("llama3-8b", None), ("internlm2-1.8b", None),
         ("granite-3-8b", None), ("musicgen-large", None),
         ("llama3-8b", "bfloat16")]
STAGES = ["forward", "prefill"] + [f"decode{i}" for i in range(N_DECODE)]


@pytest.fixture(scope="module", params=CASES,
                ids=[a + ("-bf16" if d else "") for a, d in CASES])
def pair(request):
    arch, dtype = request.param
    return run_pair(arch, dtype), (BF16 if dtype else F32)


@pytest.mark.parametrize("stage", STAGES)
def test_matches_jax(pair, stage):
    res, tol = pair
    check_stage(res, stage, tol)


def test_carried_jax_cache_decodes_the_same(pair):
    res, tol = pair
    np.testing.assert_allclose(res["port"]["carried"], res["jax"]["carried"],
                               **tol["logits"])
