"""PyTorch/CUDA port of giga_tpu: batched GIGA grasp serving on an NVIDIA H100.

Importing the package has no side effects: kernels are built on first use
(``giga_tpu_torch.ops.kernels._build``), never at import.
"""
