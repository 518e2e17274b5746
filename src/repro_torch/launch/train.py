"""Training launcher.

Wires the training substrate: the train step (autograd, accumulation,
optional bf16 gradient compression, AdamW), the deterministic data
pipeline, async checkpoints with resume, and the straggler detector fed
each step's synchronized time.  ``--reduced`` runs the CPU-test-sized
config of the same family; without it the published config, on the
card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
        --device cpu

``--device`` defaults to ``cuda`` and the launcher raises without a
card.  ``--mesh auto`` is the one device; ``--mesh production`` names
the (16, 16) / (2, 16, 16) mesh of ``launch/mesh.py``, which needs 256 /
512 ranks and raises on fewer.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get, get_reduced
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh, require_ranks
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, as_tensors, make_batch
from repro_torch.train.elastic import StragglerDetector
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_state import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="auto", choices=("auto", "production"),
                    help="'auto' = the one device; 'production' = (16,16) "
                         "/ (2,16,16), which needs that many ranks")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    if args.mesh == "production":
        require_ranks(make_production_mesh(multi_pod=args.multi_pod), 1)
    cfg = get_reduced(args.arch) if args.reduced else get(args.arch)
    model = Model(cfg)
    cell = ShapeCell("train", args.seq, args.batch, "train")

    params = model.init(0, device=device)
    opt_state = init_opt_state(params)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum,
                              compress_grads=args.compress_grads)
    dc = DataConfig(seed=0, vocab=min(cfg.vocab, 4096))
    detector = StragglerDetector()

    start = 0
    if args.ckpt_dir:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            restored = checkpoint.restore(args.ckpt_dir, last,
                                          {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start = last + 1
            print(f"[elastic] resumed from step {last} onto 1 devices")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    err_state = None
    writes = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = as_tensors(make_batch(dc, cfg, cell, step), device)
        if args.compress_grads:
            params, opt_state, err_state, metrics = step_fn(
                params, opt_state, batch, err_state)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        sync()
        dt = time.perf_counter() - t0
        detector.observe({"host0": dt})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms")
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            writes.append(checkpoint.save(
                args.ckpt_dir, step, {"params": params, "opt": opt_state}))
    for w in writes:
        w.result()
    print("training complete")


if __name__ == "__main__":
    main()
