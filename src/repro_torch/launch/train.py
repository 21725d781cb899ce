"""Training launcher: mesh-aware train loop with checkpoint/resume,
preemption handling and (optional) injected failures for fault drills.
The port's counterpart of ``repro.launch.train``, with the same flags and
printed lines, plus ``--device``.  As the JAX launcher builds
``make_host_mesh()`` over every device it sees, this one builds it over
``devices`` (by default every card, or the one CPU device of
``--device cpu``) and runs under it when it has more than one position:
the MoE layers then take the expert-parallel path (``models/moe_ep.py``),
whose batch must split over the data axis.

Usage (on the card; ``--device cpu`` runs on the CPU):
    python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
        --steps 50 --ckpt-dir RUN_DIR --ckpt-every 10 [--resume]
    # fault drill: crash at step 7, then rerun with --resume
    python -m repro_torch.launch.train ... --fail-at 7
    # full width (1.89B parameters, bf16 activations over float32
    # master weights, full remat): one card of 80 GB
    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 5 \\
        --batch 2 --seq 4096 --accum 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataIterator
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.sharding import partition as P_
from repro_torch.train import (OptimizerConfig, checkpoint as ckpt,
                               init_opt_state, make_train_state, train_step)
from repro_torch.train.fault import PreemptionGuard


def run(argv=None, model: M.LanguageModel | None = None,
        devices=None) -> dict:
    """Train as the flags say; returns ``{"final_loss": ...}``.
    ``model``, when given, holds the starting weights: trainable float32
    leaves of the chosen config on the chosen device, updated in place;
    otherwise they are drawn from seed 0.  ``devices`` are the host
    mesh's positions (repeats allowed), the counterpart of the device
    count JAX reads from ``XLA_FLAGS``: by default every visible card on
    CUDA and the one device otherwise; the parameters live on the first."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a crash after this step (fault drill)")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if devices is None:
        dev = resolve_device(args.device)
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    else:
        dev = resolve_device(devices[0])
        if (args.device is not None
                and resolve_device(args.device).type != dev.type):
            raise ValueError(f"--device {args.device}, but the mesh's first "
                             f"device is {dev}")
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    ocfg = OptimizerConfig(learning_rate=args.lr,
                           warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps,
                           compression=args.compression)
    mesh = make_host_mesh(devices)
    guard = PreemptionGuard()
    with P_.use_mesh(mesh if mesh.size > 1 else None):
        return _train(args, cfg, dev, shape, ocfg, guard, model)


def _train(args, cfg, dev, shape, ocfg, guard, model) -> dict:
    if model is None:
        params, opt_state = make_train_state(cfg, 0, device=dev)
    elif model.cfg != cfg or model.device.type != dev.type or not all(
            p.dtype == torch.float32 and p.requires_grad
            for p in model.parameters()):
        raise ValueError(f"the model given is {model.cfg.name} on "
                         f"{model.device}; the flags ask for trainable "
                         f"float32 {cfg.name} on {dev}")
    else:
        # the error-feedback buffer as make_train_state allocates it
        params, opt_state = model, init_opt_state(model, "int8_ef")
    data = DataIterator(cfg, shape, device=dev)
    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, start_step, extra = ckpt.restore(
            args.ckpt_dir, {"params": params, "opt": opt_state}, device=dev)
        params, opt_state = tree["params"], tree["opt"]
        data.restore(extra["data"])
        print(f"resumed from step {start_step}")

    metrics = {}
    t0 = time.time()
    for step in range(start_step, args.steps):
        if guard.should_stop:
            print("preempted -> checkpoint + clean exit")
            break
        batch = next(data)
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                cfg, ocfg, args.accum)
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / (step - start_step + 1):.2f}"
                  f"s/step)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state},
                      extra={"data": data.state(), "arch": args.arch})
            ckpt.garbage_collect(args.ckpt_dir, keep_last=3)
        if args.fail_at == step + 1:
            raise RuntimeError(f"injected failure at step {step + 1}")

    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": params, "opt": opt_state},
                  extra={"data": data.state(), "arch": args.arch})
    return {"final_loss": float(metrics.get("loss", np.nan))}


if __name__ == "__main__":
    run()
