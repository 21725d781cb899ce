"""Deterministic synthetic data pipeline + the input-spec registry, the
port's counterpart of ``repro.data.pipeline``.

1. ``make_batch`` / ``DataIterator`` — host-sharded, deterministically
   seeded synthetic batches for every family (tokens; frame embeddings for
   the audio stub; patch embeddings for the vlm stub), made with numpy as
   the JAX package makes them and placed on a device (the card unless the
   caller asks for the CPU).  The iterator state is one integer (``step``)
   and lives inside checkpoints, so restarts resume the stream.

2. ``input_specs`` — ``device="meta"`` tensors for every (arch x shape)
   cell (never allocated).

The seed of a row mixes in ``hash(name) % 997``, as the reference does.
Python randomises ``str`` hashes per process, so the stream is the JAX
package's only within one process, and a run resumed in a new process
reads another stream (in both packages).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device

__all__ = ["batch_shapes", "input_specs", "make_batch", "DataIterator"]


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical input shapes for a cell (decode excludes the cache)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.embed_input:
            return {"tokens": ((B, 1), torch.int32)}
        return {"embeds": ((B, 1, cfg.d_model), torch.bfloat16)}
    out: dict = {}
    if cfg.embed_input:
        out["tokens"] = ((B, S), torch.int32)
    else:
        out["embeds"] = ((B, S, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            out["labels"] = ((B, S), torch.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = ((B, cfg.n_vision_tokens, cfg.vision_dim),
                                torch.bfloat16)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str) -> dict:
    """Meta tensors of a cell's inputs (zero allocation)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in batch_shapes(cfg, shape).items()}


def make_batch(cfg: ModelConfig, shape: ShapeConfig | str, step: int,
               host_id: int = 0, n_hosts: int = 1,
               device: str | torch.device | None = None) -> dict:
    """Concrete synthetic batch for this host's slice of the global batch.
    Content depends only on (step, global example index) — any host count
    yields the same global batch.  Integer inputs are int32, the others
    float32 (as the JAX package makes them, whatever the spec's dtype)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    dev = resolve_device(device)
    B = shape.global_batch
    if B % n_hosts:
        raise ValueError(f"a global batch of {B} does not split over "
                         f"{n_hosts} hosts")
    b = B // n_hosts
    lo = host_id * b
    out = {}
    for name, (gshape, dtype) in batch_shapes(cfg, shape).items():
        lshape = (b,) + tuple(gshape[1:])
        rows = []
        for i in range(b):
            rng = np.random.default_rng(
                (step * B + lo + i) * 1000003 + hash(name) % 997)
            if dtype == torch.int32:
                rows.append(rng.integers(0, cfg.vocab_size, size=gshape[1:],
                                         dtype=np.int32))
            else:
                rows.append(rng.normal(size=gshape[1:]).astype(np.float32))
        arr = np.stack(rows) if b else np.zeros(lshape)
        arr = arr.astype(np.int32 if dtype == torch.int32 else np.float32)
        out[name] = torch.from_numpy(arr).to(dev)
    return out


@dataclasses.dataclass
class DataIterator:
    """Checkpointable iterator: ``state`` is just the step counter."""

    cfg: ModelConfig
    shape: ShapeConfig
    host_id: int = 0
    n_hosts: int = 1
    step: int = 0
    device: str | torch.device | None = None

    def __next__(self):
        batch = make_batch(self.cfg, self.shape, self.step, self.host_id,
                           self.n_hosts, device=self.device)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
