"""Train step assembly: value and gradients by autograd, microbatch
gradient accumulation, the gradient compression hook and AdamW.

``make_train_step(model, opt_cfg, ...)`` returns ``train_step(params,
opt_state, batch, err_state=None)`` with the JAX package's return
tuples: ``(params, opt_state, metrics)``, or ``(params, opt_state,
err_state, metrics)`` with ``compress_grads``.  The update writes params
and optimizer state in place (``optimizer.adamw_update``); ``metrics``
(``grad_norm``, ``lr``, ``loss``) stay 0-d tensors on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.api import Model
from repro_torch.train.compression import compress_decompress
from repro_torch.train.optimizer import AdamWState, OptConfig, adamw_update
from repro_torch.train.tree import leaves, unflatten_like

__all__ = ["loss_and_grads", "make_train_step"]

Params = Any


def loss_and_grads(model: Model, params: Params,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Params]:
    """``Model.loss`` and its gradient with respect to every leaf of
    ``params`` (a tree of the same structure; zeros for a leaf the loss
    does not reach), the counterpart of ``jax.value_and_grad``.  The
    caller's tensors are left as they are: autograd runs on detached
    aliases of them."""
    flat = leaves(params)
    alias = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = model.loss(unflatten_like(params, alias), batch)
        grads = torch.autograd.grad(loss, alias, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(model: Model, opt_cfg: OptConfig,
                    accum_steps: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Build the train-step function.

    accum_steps > 1 splits the global batch into microbatches along dim 0
    (microbatch i holds rows i·b/accum_steps … (i+1)·b/accum_steps − 1,
    as the JAX package's reshape splits them) and accumulates fp32
    gradients one microbatch at a time — memory constant in the number
    of microbatches.  compress_grads applies bf16 compression with error
    feedback between grad computation and the optimizer (see
    compression.py).
    """

    def grads_of(params, batch):
        if accum_steps == 1:
            return loss_and_grads(model, params, batch)
        micro = {k: x.reshape((accum_steps, -1) + tuple(x.shape[1:]))
                 if x.ndim else x for k, x in batch.items()}
        loss = acc = None
        for i in range(accum_steps):
            mb = {k: x[i] if batch[k].ndim else x for k, x in micro.items()}
            l, g = loss_and_grads(model, params, mb)
            g = [x.float() for x in leaves(g)]
            if acc is None:
                loss, acc = l.float(), g
            else:
                loss = loss + l
                for a, x in zip(acc, g):
                    a.add_(x)
        for a in acc:
            a.div_(accum_steps)
        return loss / accum_steps, unflatten_like(params, acc)

    def train_step(params: Params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor],
                   err_state: Optional[Params] = None):
        loss, grads = grads_of(params, batch)
        if compress_grads:
            grads, err_state = compress_decompress(grads, err_state)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        if compress_grads:
            return params, opt_state, err_state, metrics
        return params, opt_state, metrics

    return train_step
