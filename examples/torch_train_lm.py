"""End-to-end training run on the PyTorch port, with checkpointing and
a mid-run crash + resume drill.

The port's counterpart of `train_lm.py`: the same CPU-sized config (~5M
parameters) and, with ``--large``, the same ~100M-parameter llama3-style
config; the same cyclic set of 4 batches (the synthetic stream is uniform
random tokens, so next-token loss on fresh data cannot beat ln(V);
memorising a finite set shows the optimizer working end to end); a
checkpoint halfway, the state dropped and restored from it; and the same
final check, loss < ln(V) - 1.  The weights are drawn on the device from
seed 0 (not the JAX package's draws), so the losses are the port's own.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 80]
      [--large] [--device cpu]      (the card by default)
"""
from __future__ import annotations

import argparse
import math
import shutil
import tempfile
import time


from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataIterator, make_batch
from repro_torch.kernels.common import resolve_device
from repro_torch.train import (OptimizerConfig, checkpoint as ckpt,
                               make_train_state, train_step)


def lm_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2304, vocab_size=16384, head_dim=64,
        dtype="float32", remat_policy="none", rope_theta=10_000.0)


def lm_cpu() -> ModelConfig:
    return ModelConfig(
        name="lm-cpu", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=768, vocab_size=4096, head_dim=32,
        dtype="float32", remat_policy="none", rope_theta=10_000.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--large", action="store_true",
                    help="~100M-param config (real-hardware scale)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_100m() if args.large else lm_cpu()
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    ocfg = OptimizerConfig(learning_rate=3e-4,
                           warmup_steps=args.steps // 10,
                           total_steps=args.steps)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    params, opt_state = make_train_state(cfg, 0, compression="none",
                                         device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {n_params / 1e6:.1f}M params | "
          f"{args.steps} steps | batch {args.batch} x seq {args.seq}")

    data = DataIterator(cfg, shape, device=dev)
    n_cycle = 4
    t0 = time.time()
    crash_at = args.steps // 2
    try:
        for step in range(args.steps):
            next(data)                  # keep the iterator state authentic
            batch = make_batch(cfg, shape, step=data.step % n_cycle,
                               device=dev)
            params, opt_state, m = train_step(params, opt_state, batch, cfg,
                                              ocfg)
            if (step + 1) % 25 == 0:
                tok_s = (step + 1) * args.batch * args.seq / (
                    time.time() - t0)
                print(f"  step {step + 1:4d}  loss={float(m['loss']):.4f}  "
                      f"lr={float(m['lr']):.2e}  {tok_s:,.0f} tok/s")
            if step + 1 == crash_at:
                ckpt.save(ckpt_dir, step + 1,
                          {"params": params, "opt": opt_state},
                          extra={"data": data.state()})
                print(f"  == checkpoint @ {step + 1}; simulating "
                      "crash+resume ==")
                like = dict(zip(("params", "opt"), make_train_state(
                    cfg, 0, compression="none", device=dev)))
                del params, opt_state
                tree, s0, extra = ckpt.restore(ckpt_dir, like, device=dev)
                params, opt_state = tree["params"], tree["opt"]
                data.restore(extra["data"])
                assert s0 == crash_at
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    loss = float(m["loss"])
    print(f"final loss: {loss:.4f} "
          f"(uniform = ln(V) = {math.log(cfg.vocab_size):.2f})")
    assert loss < math.log(cfg.vocab_size) - 1.0, \
        "loss should fall well below uniform"
    print("train_lm: OK")


if __name__ == "__main__":
    main()
