"""Counts of GCN (``reference/gcn.py``) on a whole graph: per layer of width
f → d one sparse product and the dense layer (N × 2f × d); the backward
needs each dense layer's weight gradient, past layer 0 its inputs'
gradient and ``Sᵀ`` of the sparse product."""

from __future__ import annotations

from portbench.counts import F32, Tally, act_bytes


def _layers(model: dict, in_dim: int):
    hidden = [int(d) for d in model["hidden_dim"]]
    return list(zip([in_dim, *hidden[:-1]], hidden)), hidden[-1]


def _forward(t: Tally, model: dict, n: int, e: int, in_dim: int, num_class: int) -> None:
    s = act_bytes(model)
    layers, width = _layers(model, in_dim)
    for f, d in layers:
        t.sparse(n, e, f, s)
        t.product(n, 2 * f, d, s, F32, s)
    t.product(n, width, num_class, s, F32, s)


def _backward(t: Tally, model: dict, n: int, e: int, in_dim: int, num_class: int) -> None:
    s = act_bytes(model)
    layers, width = _layers(model, in_dim)
    t.product(n, num_class, width, s, F32, s)
    t.product(width, n, num_class, s, s, F32)
    for li in reversed(range(len(layers))):
        f, d = layers[li]
        t.product(2 * f, n, d, s, s, F32)
        if li:
            t.product(n, d, 2 * f, s, F32, s)
            t.sparse(n, e, f, s, backward=True)


def epoch(model: dict, n: int, e: int, in_dim: int, num_class: int, remat: bool = False) -> dict:
    """One training step (forward and backward; ``remat``: each layer's
    forward run again in the backward) and one validation pass."""
    t = Tally()
    _forward(t, model, n, e, in_dim, num_class)
    if remat:
        for f, _ in _layers(model, in_dim)[0]:
            t.replayed_sparse(e, f)
    _backward(t, model, n, e, in_dim, num_class)
    _forward(t, model, n, e, in_dim, num_class)
    return t.as_dict()


def infer_pass(model: dict, n: int, e: int, in_dim: int, num_class: int) -> dict:
    """One forward of every node."""
    t = Tally()
    _forward(t, model, n, e, in_dim, num_class)
    return t.as_dict()
