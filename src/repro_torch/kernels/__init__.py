"""Kernel layer: hand-written CUDA kernels (``csrc/``, built at first use
by :mod:`repro_torch.kernels._build`), their wrappers, and their plain
PyTorch versions (:mod:`repro_torch.kernels.ref`)."""
