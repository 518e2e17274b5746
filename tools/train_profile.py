"""Where an LM's training step goes on one NVIDIA GPU, and what the group
loop's backward costs: ``chip_smoke.py`` phase 11a's timed step, in
turns of two forms of the loop over the stacked group leaves.

    python3 tools/train_profile.py [--arch granite-moe-1b-a400m]
        [--turns index,unbind,unbind,index] [--remat off|on] [--trace]

Initializes ``--arch`` at full width on the card (random weights from
seed 0, the config's own dtypes) and, for each turn, times
``chip_smoke.timed_steps`` (2 warm steps, then the median of 5 on CUDA
events, split into forward + backward and the optimizer, with the peak
device memory) at ``LM_BATCH`` × ``LM_PREFILL_SEQ`` tokens.  The forms:
``unbind`` is the port's forward (each stacked leaf unbound once, whose
backward is one ``stack``); ``index`` takes each group's slice of each
stacked leaf in turn, as the forward did before the training path was
ported (each slice's backward writes a zero tensor of the whole stacked
leaf).  ``--remat`` sets the config's activation checkpointing (off by
default, as the earlier forward had none; ``on`` is the published
configs' selective policy).  ``--trace`` then traces one step of the
port's form with ``torch.profiler`` (``tools/lm_profile.py::trace``:
wall, device busy and idle share, launches, top kernels and host
operators).  Prints the card's name and power limit and one JSON line.
Imports neither JAX nor the JAX package.
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
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--turns", default="index,unbind,unbind,index")
    ap.add_argument("--remat", choices=("off", "on"), default="off")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import chip_smoke as smoke
    from lm_profile import trace
    from repro_torch.configs import get
    from repro_torch.models import encdec, transformer
    from repro_torch.models.api import Model
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_state import loss_and_grads

    unbind = transformer._unbind

    def index(tree, n):
        return [transformer._index(tree, i) for i in range(n)]

    forms = {"unbind": unbind, "index": index}
    cfg = dataclasses.replace(get(args.arch), remat=args.remat == "on")
    m = Model(cfg)
    params = m.init(0, device="cuda")
    state = init_opt_state(params)
    turns = []
    for form in args.turns.split(","):
        transformer._unbind = encdec._unbind = forms[form]
        turns.append(dict(smoke.timed_steps(m, params, state, 0),
                          form=form))
        print(f"{args.arch} {form}: step {turns[-1]['step_ms']:.4f} ms "
              f"(forward + backward {turns[-1]['fwd_bwd_ms']:.4f}, "
              f"optimizer {turns[-1]['opt_ms']:.4f}), peak "
              f"{turns[-1]['peak_gib']:.3f} GiB", flush=True)
    transformer._unbind = encdec._unbind = unbind
    out = {"arch": args.arch, "remat": cfg.remat, "batch": smoke.LM_BATCH,
           "seq": smoke.LM_PREFILL_SEQ, "turns": turns}
    if args.trace:
        batch = smoke.train_batch(cfg, smoke.LM_BATCH, smoke.LM_PREFILL_SEQ,
                                  4)
        opt = OptConfig(lr=1e-3, warmup_steps=2)

        def one_step():
            _, grads = loss_and_grads(m, params, batch)
            adamw_update(opt, grads, state, params)

        one_step()
        out["trace"] = trace(one_step)
        print(json.dumps(out["trace"]), flush=True)
    print(smoke.gpu_identity())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
