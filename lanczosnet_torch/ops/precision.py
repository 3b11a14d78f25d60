"""Float32 matrix products whatever the TF32 flags say."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmul():
    """Inside this block ``torch.matmul`` on float32 CUDA tensors runs in
    full float32: the TF32 flag is switched off and restored on exit.

    The counterpart of ``jax.default_matmul_precision("float32")`` around
    the Lanczos recursion and its adjoint, which live on orthogonality
    that TF32's ten mantissa bits lose."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
