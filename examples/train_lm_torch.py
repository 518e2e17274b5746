"""Train a ~100M-class LM for a few hundred steps on the synthetic
pipeline, through the PyTorch port — exercises the full training
substrate (AdamW, schedule, grad accumulation, checkpointing + resume,
deterministic data).

The default is a width-reduced config of ``--arch``'s family (~13M
params for qwen; pass --width 768 --layers 12 for the true ~100M).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200  # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs import get
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, as_tensors, make_batch
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_state import make_train_step
from repro_torch.train.tree import leaves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the params and the batches")
    args = ap.parse_args()
    device = resolve_device(args.device)

    base = get(args.arch)
    cfg = dataclasses.replace(
        base, n_layers=args.layers * len(base.group_pattern),
        d_model=args.width, n_heads=max(4, args.width // 64),
        n_kv=max(2, min(base.n_kv, args.width // 128)),
        d_ff=args.width * 3, vocab=8192, head_dim=None, remat=False)
    # keep n_kv dividing n_heads
    while cfg.n_heads % cfg.n_kv:
        cfg = dataclasses.replace(cfg, n_kv=cfg.n_kv - 1)
    model = Model(cfg)
    cell = ShapeCell("train", args.seq, args.batch, "train")

    params = model.init(0, device=device)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"{cfg.name} (reduced): {n_params/1e6:.1f}M params, "
          f"batch {args.batch}x{args.seq}")

    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum)
    opt_state = init_opt_state(params)
    dc = DataConfig(seed=0, vocab=min(cfg.vocab, 4096))

    start = 0
    last = checkpoint.latest_step(args.ckpt_dir)
    if last is not None:
        restored = checkpoint.restore(args.ckpt_dir, last,
                                      {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start = last + 1
        print(f"resumed from checkpoint step {last}")

    writes = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = as_tensors(make_batch(dc, cfg, cell, step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tput = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"lr {float(metrics['lr']):.2e}  {tput:,.0f} tok/s")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            writes.append(checkpoint.save(
                args.ckpt_dir, step, {"params": params, "opt": opt_state}))
    for w in writes:
        w.result()
    print("done.")


if __name__ == "__main__":
    main()
