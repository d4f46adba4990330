"""TF32 off for cuDNN convolutions and CUDA matmuls while a float32
computation runs: the counterpart of the JAX package's
``default_matmul_precision("highest")`` pin. The planning programs and
GIGANet's entry points run under ``full_precision()``.
"""

from __future__ import annotations

import contextlib
import threading

import torch


class _FullPrecision:
    """TF32 off for cuDNN convolutions and CUDA matmuls while any plan runs.

    The two flags are process-wide, and plans may run in several threads at
    once (a PlannerService worker beside a direct ``plan_batch``), so the
    first entrant saves and clears them and the last one out restores them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._users = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._users == 0:
                self._saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32) = self._saved


full_precision = _FullPrecision()
