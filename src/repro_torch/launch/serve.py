"""Serving launcher: batched token-request serving on the smoke configs
or the full published widths.  The port's counterpart of
``repro.launch.serve``, with the same flags and printed lines, plus
``--device``.

Usage (on the card; ``--device cpu`` runs on the CPU):
    python -m repro_torch.launch.serve --arch llama3-8b --smoke --requests 6
    python -m repro_torch.launch.serve --arch llama3-8b      # 8B, bf16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.registry import default_registry
from repro_torch.serve import Request, ServeEngine


def run(argv=None, model: M.LanguageModel | None = None):
    """Serve the launcher's requests; returns them, served.  ``model``,
    when given, is a model of the chosen config already built (on the
    chosen device); otherwise one is drawn from seed 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    if model is None:
        model = M.init_params(cfg, 0, device=dev)
    elif model.cfg != cfg or model.device.type != dev.type:
        raise ValueError(f"the model given is {model.cfg.name} on "
                         f"{model.device}, the flags ask for {cfg.name} on "
                         f"{dev}")
    engine = ServeEngine(cfg, model, max_len=args.max_len)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=5 + i % 4,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    engine.serve(reqs, n_slots=args.slots)
    # every token was read back on the host, so the device is done
    dt = time.perf_counter() - t0
    default_registry().histogram("launch.serve_batch_ms").observe(dt * 1e3)
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt={r.prompt.tolist()} -> {r.output}")
    return reqs


if __name__ == "__main__":
    run()
