"""Counts of GAT (``reference/gat.py``) on a whole graph.

Per layer, ``f`` wide in, H heads of D (the last: H heads of the class
count, averaged), n nodes and e edges (the self-loops are no
edges): the projection (n × f × HD); the scores ``a·hp`` of both ends
(n·H × D × 2); the edge softmax (e·H logits and denominator terms; the
edges, the scores in, one float32 weight an edge and head out); H
weighted sums, one a head (2·e·D operations; ``x`` in and out, 12 bytes
an edge); the skip (n × f × out). The backward: the skip's and the
projection's weight gradients and, past layer 0, their inputs'; the
scores' gradients; per head the sum over the transposed view and the
weights' gradient (SDDMM: g's and x's rows once, the edges, one float32
out an edge); the softmax's (the weights and their gradients in, the
scores' gradients out).

Beside ``counts.Tally``'s fields:

- ``sparse_bytes`` and ``sparse_launches``: the weighted sums, their
  transposed sums and SDDMMs, one launch each a head (``spmm_csr_kernel``,
  ``spmm_sddmm_kernel``);
- ``attention_bytes``: what the span ``model.attention`` carries, the
  softmax and the weighted sums with their backward;
- ``attention_spans``: the spans ``model.attention`` a unit, one a layer
  and forward (the validation forward's included);
- ``sparse_calls``: the CPU's calls of ``counts.SPARSE_OPS`` a unit (the
  plain path of the softmax's gathers, max and sums and of the weighted
  sums, chunked as ``counts.scatter_chunks`` says); the card launches
  kernels in their place.
"""

from __future__ import annotations

import dataclasses

from portbench.counts import F32, Tally, act_bytes, scatter_chunks

EDGE_BYTES = 12  # a weighted sum's edge: its destination, source (int32) and weight (float32)
INDEX_BYTES = 8  # an edge's two ends, int32


def _layers(model: dict, in_dim: int, num_class: int):
    """``(f, H, D, out)`` of each layer."""
    heads = int(model["num_head"])
    dims = [(heads, -(-int(d) // heads)) for d in model["hidden_dim"]]
    dims.append((heads, num_class))
    out, f = [], in_dim
    for li, (h, d) in enumerate(dims):
        out.append((f, h, d, d if li == len(dims) - 1 else h * d))
        f = h * d
    return out


@dataclasses.dataclass
class _Count(Tally):
    attention_bytes: float = 0.0
    attention_spans: int = 0

    def attention(self, moved: float, flops: float, sparse: bool) -> None:
        self.flops += flops
        self.bytes += moved
        self.attention_bytes += moved
        if sparse:
            self.sparse_bytes += moved
            self.sparse_launches += 1

    def calls(self, op: str, k: int) -> None:
        self.sparse_calls[op] += k


def _forward(t: _Count, model: dict, n: int, e: int, in_dim: int, num_class: int) -> None:
    s = act_bytes(model)
    for f, h, d, out in _layers(model, in_dim, num_class):
        t.product(n, f, h * d, s, F32, s)
        t.product(n * h, d, 2, s, F32, s)
        t.attention(INDEX_BYTES * e + 2 * n * h * s + F32 * e * h, 2.0 * e * h, False)
        for _ in range(h):
            t.attention(2 * n * d * s + EDGE_BYTES * e, 2.0 * e * d, True)
        t.product(n, f, out, s, F32, s)
        t.attention_spans += 1
        # the two gathers of the scores, the max's gather, the weighted sum's
        # gather; the denominator's and the weighted sum's segment sums
        t.calls("aten::index_select", 4)
        t.calls("aten::index_add", 2)


def _backward(t: _Count, model: dict, n: int, e: int, in_dim: int, num_class: int) -> None:
    s = act_bytes(model)
    for li, (f, h, d, out) in enumerate(_layers(model, in_dim, num_class)):
        t.product(out, n, f, s, s, F32)
        t.product(h * d, n, f, s, s, F32)
        if li:
            t.product(n, out, f, s, F32, s)
            t.product(n, h * d, f, s, F32, s)
        t.product(n * h, 2, d, s, F32, s)
        t.product(2, n * h, d, s, s, F32)
        for _ in range(h):
            t.attention(2 * n * d * s + EDGE_BYTES * e, 2.0 * e * d, True)
            t.attention(2 * n * d * s + INDEX_BYTES * e + F32 * e, 2.0 * e * d, True)
        t.attention(INDEX_BYTES * e + 2 * F32 * e * h + 2 * n * h * s, 2.0 * e * h, False)
        # the segment sums' backward gathers (2); the weighted sum's and the
        # source scores' sorted scatters (two gathers and a scatter a chunk);
        # the destination scores' scatter
        wide, narrow = scatter_chunks(e, h * d), scatter_chunks(e, h)
        t.calls("aten::index_select", 2 + 2 * wide + 2 * narrow)
        t.calls("aten::index_add_", wide + narrow + 1)


def epoch(model: dict, n: int, e: int, in_dim: int, num_class: int, remat: bool = False) -> dict:
    """One training step (forward and backward) and one validation pass;
    ``SparseGAT`` has no per-layer remat, so ``remat`` is refused."""
    if remat:
        raise ValueError("SparseGAT has no per-layer remat to count")
    t = _Count()
    _forward(t, model, n, e, in_dim, num_class)
    _backward(t, model, n, e, in_dim, num_class)
    _forward(t, model, n, e, in_dim, num_class)
    return t.as_dict()


def infer_pass(model: dict, n: int, e: int, in_dim: int, num_class: int) -> dict:
    """One forward of every node."""
    t = _Count()
    _forward(t, model, n, e, in_dim, num_class)
    return t.as_dict()
