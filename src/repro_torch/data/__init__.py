"""Synthetic data for the LM training path (``repro.data``'s counterpart)."""
from repro_torch.data.pipeline import (DataIterator, batch_shapes,
                                       input_specs, make_batch)

__all__ = ["DataIterator", "batch_shapes", "input_specs", "make_batch"]
