"""Matrix products at the precision the JAX package pins, whatever the
process-wide flags say."""

from __future__ import annotations

import contextlib
import threading

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


class _Bf16Accumulation:
    """``allow_bf16_reduced_precision_reduction`` off while any thread is
    inside the block: the flag is the process's, so the blocks are
    counted and the first one in saves it, the last one out restores it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = self._saved


#: Inside this block a bfloat16 GEMM on the card accumulates in float32
#: throughout, as the TPU's matrix unit does: cuBLAS may otherwise reduce
#: split-K partial sums in bfloat16 (PyTorch's default allows it). The
#: train and eval steps and the serving program run in it; it changes
#: nothing for float32 products or on the CPU.
bf16_f32_accumulation = _Bf16Accumulation()
