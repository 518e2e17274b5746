"""AdamW with global-norm clipping, decoupled weight decay and a
linear-warmup cosine schedule, as a functional update over the leaves
of a parameter tree; optional bf16 gradient compression with error
feedback lives in ``compression.py``.

The arithmetic is the JAX package's, step for step: fp32 moments; the
global norm of the gradients clips them before the update; weight decay
only on leaves with ``ndim >= 2``; ``lr``, the bias corrections ``c1``
and ``c2`` and the clip scale are 0-d float32 tensors on the params'
device, so a step reads nothing back to the host.  ``torch.optim.AdamW``
is not used: it decays every leaf unless given groups, and orders its
bias correction differently.

The update writes params and moments in place under ``torch.no_grad()``
(no full-width copy of either) and still returns ``(params, state,
metrics)``.  Optimizer state is a tree congruent with the parameters;
its sharding rules are ``models/sharding.py::opt_state_specs``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.train.tree import leaves, map_tree

__all__ = ["AdamWState", "OptConfig", "adamw_update", "global_norm",
           "init_opt_state"]

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Params               # first moment (fp32)
    nu: Params               # second moment (fp32)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_opt_state(params: Params) -> AdamWState:
    zeros = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu=map_tree(torch.clone, zeros))


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Params, state: AdamWState,
                 params: Params) -> Tuple[Params, AdamWState,
                                          Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))                # b1·m + (1-b1)·g
        gg = g * (1 - b2)
        v.mul_(b2).add_(gg.mul_(g))                  # b2·v + (1-b2)·g·g
        delta = m / c1
        delta.div_(torch.sqrt(v / c2).add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (standard practice)
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics
