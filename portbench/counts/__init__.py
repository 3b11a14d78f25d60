"""Operations and bytes that the benchmark's work needs, from shapes.

``counts/<family>.py`` counts one training epoch (``epoch``: the step's
forward and backward, then the validation pass's forward) and one
scoring pass (``infer_pass``) of a model family. Only products count:
each sparse product ``S x``, each dense one and each spectral one, at
2 operations a multiply-add; elementwise work, the loss and Adam are
left out, and so is what an implementation repeats (remat's replay,
``Vᵀh`` taken once a long scale). Bytes are those no implementation of
the same mathematics can avoid: each operand of a product read once,
each result written once, at the configuration's dtypes (activations
in the compute dtype, parameters, Ritz vectors and edge weights in
float32, edge indices in int32); the ``[E, F]`` rows that an
implementation gathers are not counted.

Beside the work, two fingerprints by which a metric knows that what it
times carries every sparse product and nothing else; neither is a cost
the benchmark charges:

- ``sparse_launches``: the launches of the port's CSR product kernels
  (``spmm_csr_kernel``, ``spmm_sddmm_kernel``) a unit, one for each
  forward product (remat's replay and the validation forward included),
  one for each backward product (the kernel over the transposed view)
  and one for each edge-weight gradient; ``sparse_ops_roofline_pct``
  reads it.
- ``sparse_calls``: calls of the ATen ops that ran the products before
  the kernels (``SPARSE_OPS``), and still run them on the CPU: a forward
  product one ``index_select`` and one ``index_add``; a backward one
  (``Sᵀ g``) one ``index_select`` of the cotangent at the rows and, per
  chunk of its sorted scatter, two ``index_select`` and one
  ``index_add_``. Only its ``aten::index_add`` entry, one a forward
  product, serves a metric: the count of ``sparse.spmv`` spans that
  ``sparse_span_roofline_pct`` expects.
"""

from __future__ import annotations

import dataclasses
import math

DTYPE_BYTES = {"bfloat16": 2, "bf16": 2, "float32": 4, "f32": 4, None: 4, "": 4}
F32 = 4
EDGE_BYTES = 12  # an edge's row and col (int32) and weight (float32)
SPARSE_OPS = ("aten::index_select", "aten::index_add", "aten::index_add_")
# the port's sorted backward scatter runs in chunks of about CHUNK_TARGET
# bytes of float32 cotangent once the whole would pass CHUNK_ENGAGE
CHUNK_ENGAGE = 2 * 1024**3
CHUNK_TARGET = 1 * 1024**3


def scatter_chunks(e: int, f: int) -> int:
    """Chunks of the sorted scatter of an ``[e, f]`` cotangent."""
    op_bytes = e * f * F32
    if op_bytes <= CHUNK_ENGAGE:
        return 1
    size = math.ceil(e / math.ceil(op_bytes / CHUNK_TARGET))
    return math.ceil(e / size)


@dataclasses.dataclass
class Tally:
    flops: float = 0.0
    bytes: float = 0.0
    sparse_bytes: float = 0.0
    sparse_launches: int = 0
    sparse_calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(SPARSE_OPS, 0))

    def product(self, m: int, k: int, n: int, a: int, b: int, out: int) -> None:
        """``C [m, n] = A [m, k] B [k, n]``, A's elements ``a`` bytes wide,
        B's ``b``, C's ``out``."""
        self.flops += 2.0 * m * k * n
        self.bytes += float(m * k * a + k * n * b + m * n * out)

    def sparse(self, n: int, e: int, f: int, s: int, backward: bool = False) -> None:
        """``S x`` for ``x [n, f]`` of ``s``-byte elements, S with e edges
        (``backward``: ``Sᵀ g`` in a backward)."""
        self.flops += 2.0 * e * f
        moved = float(2 * n * f * s + EDGE_BYTES * e)
        self.bytes += moved
        self.sparse_bytes += moved
        self.replayed_sparse(e, f, backward)

    def replayed_sparse(self, e: int, f: int, backward: bool = False) -> None:
        """The launches and calls of a sparse product; alone, of one that
        remat runs again, whose work is not counted."""
        self.sparse_launches += 1
        calls = self.sparse_calls
        if backward:
            c = scatter_chunks(e, f)
            calls["aten::index_select"] += 1 + 2 * c
            calls["aten::index_add_"] += c
        else:
            calls["aten::index_select"] += 1
            calls["aten::index_add"] += 1

    def edge_weight_grad(self) -> None:
        """The gradient of a product's edge weights in a backward: one
        launch of ``spmm_sddmm_kernel``, whose work is not counted."""
        self.sparse_launches += 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def act_bytes(model: dict) -> int:
    return DTYPE_BYTES[model.get("dtype")]
