"""How far a config's float32 gradient moves on its own: the card
against the CPU, beside the CPU against itself with its params nudged
by a float32 rounding's size, at one or more SSD chunk sizes.

    python3 tools/grad_conditioning.py [--arch mamba2-370m]
        [--chunks 256,16] [--seq 256]

Initializes ``--arch`` at full width on the card in float32 (random
weights from seed 0), takes ``loss_and_grads`` over one batch of the
data pipeline (B = 1, ``--seq`` tokens) on the card with TF32 off and on
the CPU, then on the CPU again from params each multiplied by (1 +
1e-7 · a normal draw), and prints, per chunk, ‖g_card − g_cpu‖ /
‖g_cpu‖, ‖g_nudged − g_cpu‖ / ‖g_cpu‖ and the five leaves that
move most.  ``chip_smoke.py`` phase 11 holds a config past its 1e-4
bound to a multiple of the second.  Prints the card's name and power
limit and one JSON line.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--chunks", default="256,16")
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_conditioning: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as smoke
    from repro_torch.configs import get
    from repro_torch.models.api import Model
    from repro_torch.train.train_state import loss_and_grads
    from repro_torch.train.tree import flatten_with_paths, leaves

    cfg = dataclasses.replace(get(args.arch), dtype="float32")
    params = Model(cfg).init(0, device="cuda")
    batch = smoke.train_batch(cfg, 1, args.seq, 2)
    cpu_params = smoke.tree_map(lambda x: x.cpu(), params)
    cpu_batch = smoke.tree_map(lambda x: x.cpu(), batch)
    gen = torch.Generator().manual_seed(5)
    nudged = smoke.tree_map(
        lambda x: x * (1 + smoke.TRAIN_PERTURB * torch.randn(
            x.shape, generator=gen)), cpu_params)

    def most_moved(got, want):
        moved = [(float(torch.linalg.vector_norm(a - b)), k)
                 for (k, a), b in zip(flatten_with_paths(got), leaves(want))]
        return [k for _, k in sorted(moved, reverse=True)[:5]]

    out = {"arch": args.arch, "seq": args.seq, "chunks": {}}
    for chunk in (int(c) for c in args.chunks.split(",")):
        m = Model(dataclasses.replace(cfg, ssm_chunk=chunk))
        with smoke.no_tf32():
            _, card = loss_and_grads(m, params, batch)
        card = smoke.tree_map(lambda x: x.cpu(), card)
        _, cpu = loss_and_grads(m, cpu_params, cpu_batch)
        _, moved = loss_and_grads(m, nudged, cpu_batch)
        row = {"card_vs_cpu": smoke.norm_ratio(leaves(card), leaves(cpu)),
               "cpu_nudged_vs_cpu": smoke.norm_ratio(leaves(moved),
                                                     leaves(cpu)),
               "most_moved": most_moved(moved, cpu)}
        out["chunks"][chunk] = row
        print(f"{args.arch} chunk {chunk}: card vs CPU "
              f"{row['card_vs_cpu']:.4e}, CPU nudged vs CPU "
              f"{row['cpu_nudged_vs_cpu']:.4e}", flush=True)
    print(smoke.gpu_identity())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
