"""What the reference models share: precision, the sparse product, dense
layers and dropout."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

EDGE_CHUNK = 1 << 23  # edges a gather at a time: bounds the [E, F] temporaries


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 and back (gradients pass straight)."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even
    (gradients pass straight)."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


@dataclasses.dataclass(frozen=True)
class Precision:
    """``act``: applied where the program rounds to its 16-bit activation
    dtype; ``f32``: applied to the operands of the products that the
    program runs in float32 with TF32 off; ``store``: applied to float32
    data the program stores (the operator's weights)."""

    act: Callable[[torch.Tensor], torch.Tensor] = _identity
    f32: Callable[[torch.Tensor], torch.Tensor] = _identity
    store: Callable[[torch.Tensor], torch.Tensor] = _identity


EXACT = Precision()
CONTROL = Precision(act=round_fp8, f32=round_tf32,
                    store=lambda x: x.to(torch.bfloat16).to(x.dtype))


@contextlib.contextmanager
def full_float32():
    """TF32 off for every product inside (the reference's precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def spmv(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, n: int, x: torch.Tensor,
         prec: Precision = EXACT) -> torch.Tensor:
    """``S @ x`` of the COO operator ``(row, col, val)``: ``y_i = Σ_e
    val_e x_{col_e}`` over the edges into i, summed in ``x``'s dtype;
    under ``prec`` the weight, each product and the sum round as the
    program's 16-bit messages do."""
    out = x.new_zeros((n,) + x.shape[1:])
    for s in range(0, row.shape[0], EDGE_CHUNK):
        r, c = row[s: s + EDGE_CHUNK], col[s: s + EDGE_CHUNK]
        w = prec.act(val[s: s + EDGE_CHUNK].to(x.dtype))
        w = w.reshape(w.shape + (1,) * (x.ndim - 1))
        out = out.index_add(0, r, prec.act(w * x.index_select(0, c)))
    return prec.act(out)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          prec: Precision = EXACT) -> torch.Tensor:
    """``x Wᵀ + b``; under ``prec`` the weight and the output round as the
    program's 16-bit layers do."""
    return prec.act(x @ prec.act(weight).T + prec.act(bias))


def dropout_masks(generator: torch.Generator, shape, p: float, dtype) -> torch.Tensor:
    """The keep mask of the port's dropout, drawn from its stream: a
    ``Bernoulli(1 − p)`` draw of a tensor of ``shape`` in the activation
    dtype on the generator's device, scaled by ``1 / (1 − p)``."""
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=dtype, device=generator.device)
    return mask.bernoulli_(keep, generator=generator).to(torch.float32) / keep
