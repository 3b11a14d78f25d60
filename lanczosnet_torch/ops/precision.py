"""Matrix products at the precision the JAX package pins, whatever the
process-wide flags say."""

from __future__ import annotations

import contextlib
import threading

import torch


class _FlagOff:
    """A ``torch.backends.cuda.matmul`` flag off while any thread is
    inside the block: the flag is the process's, so the blocks are
    counted and the first one in saves it, the last one out restores it
    (a plain save and restore would let one thread's exit switch the flag
    back on under another thread still inside)."""

    def __init__(self, flag: str):
        self._flag = flag
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        matmul = torch.backends.cuda.matmul
        with self._lock:
            if self._depth == 0:
                self._saved = getattr(matmul, self._flag)
                setattr(matmul, self._flag, False)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    setattr(matmul, self._flag, self._saved)


#: Inside this block ``torch.matmul`` on float32 CUDA tensors runs in full
#: float32: TF32 is off. The counterpart of
#: ``jax.default_matmul_precision("float32")`` around the Lanczos
#: recursion and its adjoint, which live on orthogonality that TF32's ten
#: mantissa bits lose; an exported request program runs in it too.
f32_matmul = _FlagOff("allow_tf32")

#: Inside this block a bfloat16 GEMM on the card accumulates in float32
#: throughout, as the TPU's matrix unit does: cuBLAS may otherwise reduce
#: split-K partial sums in bfloat16 (PyTorch's default allows it). The
#: train and eval steps and the serving program run in it; it changes
#: nothing for float32 products or on the CPU.
bf16_f32_accumulation = _FlagOff("allow_bf16_reduced_precision_reduction")
