"""The LM substrate's training side: the synthetic data pipeline
(:mod:`.data`), AdamW (:mod:`.optimizer`), bf16 gradient compression
with error feedback (:mod:`.compression`), the train step with
gradient accumulation (:mod:`.train_state`), checkpoints in the JAX
package's format (:mod:`.checkpoint`), and the elastic policies
(:mod:`.elastic`).

Plain PyTorch on trees of tensors (:mod:`.tree`): the gradients come
from autograd, and the update is elementwise torch operators — the JAX
package computes all of it with XLA outside any Pallas kernel, so no
hand-written kernel lies on this path."""
