"""TF32 for cuDNN convolutions and CUDA matmuls, set for the span of a
computation and restored after it.

``full_precision()`` turns TF32 off: the counterpart of the JAX package's
``default_matmul_precision("highest")`` pin. The GIGA planning programs,
GIGANet's entry points and the VGN planner's ``highest`` precision run
under it. ``tf32_precision()`` turns it on: the VGN planner's ``default``
precision, the card's counterpart of the TPU's default matmul pass (bf16
products, float32 sums), which the JAX package's VGN planner runs at. The
flags touch CUDA work only; on the CPU both scopes compute in float32.
"""

from __future__ import annotations

import contextlib
import threading

import torch


class _MatmulPrecision:
    """TF32 on or off for cuDNN convolutions and CUDA matmuls while any
    scope of that setting runs.

    The two flags are process-wide, and plans may run in several threads at
    once (a PlannerService worker beside a direct ``plan_batch``, a VGN plan
    beside a GIGA one), so the first entrant saves the flags and sets them,
    an entrant that asks for the other setting waits until every scope of
    the first has ended, and the last one out restores them. A scope of one
    setting opened inside a scope of the other, in one thread, raises: it
    would wait for itself.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._users = 0
        self._tf32 = None
        self._saved = None
        self._held = threading.local()

    @contextlib.contextmanager
    def __call__(self, tf32: bool):
        held = getattr(self._held, "tf32", [])
        if held and held[-1] != tf32:
            raise RuntimeError("a TF32 scope of the other setting is open in this thread")
        with self._cond:
            while self._users and self._tf32 != tf32:
                self._cond.wait()
            if self._users == 0:
                self._saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                self._tf32 = tf32
            self._users += 1
        self._held.tf32 = held + [tf32]
        try:
            yield
        finally:
            self._held.tf32 = held
            with self._cond:
                self._users -= 1
                if self._users == 0:
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32) = self._saved
                    self._tf32 = None
                    self._cond.notify_all()


_scope = _MatmulPrecision()


def full_precision():
    """TF32 off while the ``with`` block runs."""
    return _scope(False)


def tf32_precision():
    """TF32 on while the ``with`` block runs."""
    return _scope(True)
