"""Counts of LanczosNet (``reference/lanczos_net.py``) on a whole graph.

Per layer of width f → d, with P = 1 + |short| + |long| parts: max(short)
sparse products; ``Vᵀh`` (K × N × f) once; the filter MLPs on the K Ritz
values; one reconstruction ``V [φ_b ⊙ Vᵀh]_b`` (N × K × |long|·f); the
dense layer (N × P·f × d). The backward needs, per layer, the dense
layer's weight gradient and its parts' gradients (of layer 0 only the
long parts', which reach the filters), ``Vᵀ g`` of the long parts, and
past layer 0 ``V ∂(Vᵀh)`` and ``Sᵀ`` of each sparse product.
"""

from __future__ import annotations

from portbench.counts import F32, Tally, act_bytes


def _dims(model: dict, in_dim: int):
    hidden = [int(d) for d in model["hidden_dim"]]
    return list(zip([in_dim, *hidden[:-1]], hidden)), hidden[-1]


def _forward(t: Tally, model: dict, n: int, e: int, in_dim: int, num_class: int, k: int) -> None:
    s = act_bytes(model)
    short, long_ = model["short_diffusion_dist"], model["long_diffusion_dist"]
    hops, nl = max(short, default=0), len(long_)
    fh = int(model["filter_hidden_dim"])
    parts = 1 + len(short) + nl
    layers, width = _dims(model, in_dim)
    for f, d in layers:
        for _ in range(hops):
            t.sparse(n, e, f, s)
        if nl:
            t.product(k, n, f, F32, s, F32)
            for _ in range(nl):
                t.product(k, 2, fh, F32, F32, F32)
                t.product(k, fh, 1, F32, F32, F32)
            t.product(n, k, nl * f, F32, F32, s)
        t.product(n, parts * f, d, s, F32, s)
    t.product(n, width, num_class, s, F32, s)


def _backward(t: Tally, model: dict, n: int, e: int, in_dim: int, num_class: int, k: int) -> None:
    s = act_bytes(model)
    short, long_ = model["short_diffusion_dist"], model["long_diffusion_dist"]
    hops, nl = max(short, default=0), len(long_)
    fh = int(model["filter_hidden_dim"])
    parts = 1 + len(short) + nl
    layers, width = _dims(model, in_dim)
    t.product(n, num_class, width, s, F32, s)
    t.product(width, n, num_class, s, s, F32)
    for li in reversed(range(len(layers))):
        f, d = layers[li]
        t.product(parts * f, n, d, s, s, F32)
        t.product(n, d, (parts if li else nl) * f, s, F32, s)
        if nl:
            t.product(k, n, nl * f, F32, s, F32)
            for _ in range(nl):
                t.product(k, 1, fh, F32, F32, F32)
                t.product(fh, k, 1, F32, F32, F32)
                t.product(2, k, fh, F32, F32, F32)
        if li:
            if nl:
                t.product(n, k, f, F32, F32, s)
            for _ in range(hops):
                t.sparse(n, e, f, s, backward=True)


def epoch(model: dict, n: int, e: int, in_dim: int, num_class: int, remat: bool = False) -> dict:
    """One training step (forward and backward; ``remat``: each layer's
    forward run again in the backward) and one validation pass."""
    k = int(model["num_eig_vec"])
    t = Tally()
    _forward(t, model, n, e, in_dim, num_class, k)
    if remat:
        for f, _ in _dims(model, in_dim)[0]:
            for _ in range(max(model["short_diffusion_dist"], default=0)):
                t.replayed_sparse(e, f)
    _backward(t, model, n, e, in_dim, num_class, k)
    _forward(t, model, n, e, in_dim, num_class, k)
    return t.as_dict()


def infer_pass(model: dict, n: int, e: int, in_dim: int, num_class: int) -> dict:
    """One forward of every node."""
    t = Tally()
    _forward(t, model, n, e, in_dim, num_class, int(model["num_eig_vec"]))
    return t.as_dict()
