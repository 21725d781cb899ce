"""Batched serving example on the PyTorch port: continuous batching over a
small GQA model.

The port's counterpart of `serve_lm.py`: the same model (4 layers,
d_model 256, 8 heads over 4 kv heads, vocab 4096), the same ten requests
from the same numpy seed (greedy and T = 0.8 in turns) on 4 slots.  The
weights are drawn on the device from seed 0 (not the JAX package's
draws), so the tokens are the port's own.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
      (the card by default)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine


def lm_small() -> ModelConfig:
    return ModelConfig(
        name="lm-serve", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=768, vocab_size=4096, head_dim=32,
        dtype="float32", remat_policy="none", rope_theta=10_000.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")

    cfg = lm_small()
    params = M.init_params(cfg, 0, device=dev)
    engine = ServeEngine(cfg, params, max_len=256)

    rng = np.random.default_rng(7)
    requests = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=rng.integers(4, 24),
                                    dtype=np.int32),
                max_new_tokens=int(rng.integers(8, 32)),
                temperature=0.0 if i % 2 == 0 else 0.8)
        for i in range(10)
    ]
    print(f"serving {len(requests)} requests on 4 slots "
          f"(continuous batching)...")
    t0 = time.perf_counter()
    engine.serve(requests, n_slots=4)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in requests)
    print(f"done: {tokens} tokens in {dt:.1f}s ({tokens / dt:.1f} tok/s, "
          f"{where}, eager)")
    for r in requests[:4]:
        mode = "greedy" if r.temperature == 0 else f"T={r.temperature}"
        print(f"  req {r.uid} [{mode}] len(prompt)={len(r.prompt)} -> "
              f"{len(r.output)} tokens: {r.output[:8]}...")
    assert all(r.done for r in requests)
    assert all(len(r.output) == r.max_new_tokens for r in requests)
    assert all(0 <= t < cfg.vocab_size for r in requests for t in r.output)
    print("serve_lm: OK")


if __name__ == "__main__":
    main()
