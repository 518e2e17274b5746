"""The LM substrate's models: configs (:mod:`.config`), layers,
attention, MoE, SSD, the decoder-only stack, the encoder-decoder, the
:class:`~repro_torch.models.api.Model` facade, and
:func:`~repro_torch.models.convert.params_from_arrays`.

Plain functions on dicts of tensors, in eager PyTorch; the products are
``torch.matmul`` / ``torch.einsum`` (the JAX package computes these
outside any Pallas kernel, so no hand-written kernel lies on this
path)."""
