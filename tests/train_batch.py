"""The training parity tests' batch: ``make_batch``'s inputs (by default
at B=2, S=16), drawn from numpy seed 0, so that every run compares the
same batch.  ``make_batch`` seeds its rows with ``hash(name)``, which Python
randomises per process, and the MoE smoke configs' float32 gradients
are sensitive to the batch: on olmoe a 1-ulp perturbation of the port's
own weights moves a gradient leaf by up to 7.3e-4 of its largest value
and the gradient norm by up to 2.6e-4 (no token routed differently),
and over 25 of ``make_batch``'s streams the port and the JAX package
differed by up to 8.8e-4 and 7.1e-4 (on this batch: 3.5e-5 and
1.2e-5).  Imports no JAX (the card's tests use it too)."""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import batch_shapes

SHAPE = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")


def batch(cfg, shape: ShapeConfig = SHAPE) -> dict:
    """numpy inputs of the shapes make_batch gives, from seed 0."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (dims, dtype) in batch_shapes(cfg, shape).items():
        out[name] = (rng.integers(0, cfg.vocab_size, dims, dtype=np.int32)
                     if dtype == torch.int32 else
                     rng.standard_normal(dims).astype(np.float32))
    return out
