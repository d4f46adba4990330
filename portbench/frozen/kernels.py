"""Frozen names of the port's kernels, as a profiler trace names them.

Source: chip_smoke.py (``k2_kernel``, and the K1 name ``stem_pool_kernelIfE``
that its phase 3 reads) at commit 8d606019c5dd88c01735d48ffa24d97b29762a1c.
chip_smoke.py matches the mangled start of a kernel's name in nvcc's
ptxas log; a torch.profiler trace gives the demangled name. Each kernel
here is matched by either form, as a substring of the trace's name.

  * K1 float32: ``stem_pool_kernel<float>`` (csrc/stem_pool.cu), the
    batched planner's fused stem and triplane pooling;
  * K2 float32: ``dense_decode_kernel<false, false>`` (csrc/dense_decode.cu,
    not point-major, no fold), the batched planner's lattice decode.
"""

from __future__ import annotations

K1_F32 = ("stem_pool_kernel<float>", "stem_pool_kernelIfE")
K2_F32 = ("dense_decode_kernel<false, false>", "dense_decode_kernelILb0ELb0E")


def matches(name: str, kernel: tuple) -> bool:
    """Whether a trace's kernel ``name`` is ``kernel`` (either of its forms)."""
    return any(form in name for form in kernel)
