"""Hand-written CUDA kernels (``csrc/``), their build, their wrappers
(:mod:`.ops`) and their plain PyTorch versions (:mod:`.ref`)."""
