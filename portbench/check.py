"""The comparison that decides ``correct``: numbers that set what the
program produced beside what the reference works out, each held to its
limit in ``limits/<workload>.json``.

Each number is a gap that is 0 when the two agree exactly:

- ``op_index_mismatch``: edges of the program's operator whose (row,
  col) differ from the reference's once both are sorted by (row, col),
  plus rows out of order and a ``col_perm`` that is no permutation
  sorting ``col``; exact, limit 0.
- ``op_val_gap``: the widest gap of an edge weight, over the largest.
- ``ritz_val_gap``: the widest gap of a Ritz value (both ascending).
- ``ritz_proj_gap``: ``‖V diag(λ) Vᵀ Z‖`` of the program's pairs against
  the reference's, ``Z`` four probe vectors drawn from the seed; signs
  and the basis of a repeated value do not enter.
- ``loss_gap``: the widest relative gap of the first steps' losses.
- ``grad_norm_gap``: per parameter tensor (leaf), the gap of the norms of
  the first step's gradient as Adam takes it (the program's read from
  its first moment after one step), over the reference's norm of that
  leaf or of the median leaf, whichever is larger; the worst leaf.
- ``change_norm_gap``: the same of the parameters' change over the first
  steps, leaves whose reference gradient is under a thousandth of the
  median leaf's left out (they move by round-off alone).
- ``change_median_gap``: that gap of the median leaf, steady from seed to
  seed where the worst leaf's is the noise of one small leaf; a cell
  whose worst leaf is that noisy holds both, the worst leaf's at a
  limit under what a leaf left unmoved reads.
- ``logits_gap``: ``‖L − L_ref‖ / ‖L_ref‖`` over every node.
- ``logits_max_gap``: the widest logit gap, over the reference's RMS logit.
- ``pred_margin_gap``: over every node, how far the reference's logit of
  the predicted class lies below its best, over its RMS logit.
"""

from __future__ import annotations

import math

import torch

TINY_GRAD = 1e-3  # a leaf under this share of the median leaf's gradient is left out of the change


def operator_numbers(prog: dict, ref: tuple) -> dict:
    """``prog``: the program's ``row``, ``col``, ``val``, ``col_perm``
    and ``n``; ``ref``: the reference's ``(row, col, val)``."""
    n = int(prog["n"])
    row, col, val = prog["row"].long(), prog["col"].long(), prog["val"].to(torch.float64)
    rr, cr, vr = ref
    bad = int((row[1:] < row[:-1]).sum())
    perm = prog["col_perm"]
    if perm is None or perm.shape[0] != col.shape[0]:
        bad += col.shape[0]
    else:
        perm = perm.long()
        bad += int((torch.bincount(perm, minlength=col.shape[0]) != 1).sum())
        sorted_col = col[perm]
        bad += int((sorted_col[1:] < sorted_col[:-1]).sum())
    if row.shape[0] != rr.shape[0]:
        return {"op_index_mismatch": bad + abs(row.shape[0] - rr.shape[0]),
                "op_val_gap": math.inf}
    order = torch.argsort(row * n + col)
    bad += int(((row[order] != rr) | (col[order] != cr)).sum())
    gap = float((val[order] - vr).abs().max() / vr.abs().max().clamp_min(1e-300))
    return {"op_index_mismatch": bad, "op_val_gap": gap}


def _weighted_projection(vals: torch.Tensor, vecs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    v = vecs.to(torch.float64)
    return v @ (vals.to(torch.float64)[:, None] * (v.T @ z))


def ritz_numbers(prog: tuple, ref: tuple, seed: int) -> dict:
    """``prog`` and ``ref``: ``(vals [K], vecs [N, K])``."""
    pv, pw = prog
    rv, rw = ref
    if pv.shape != rv.shape or pw.shape != rw.shape:
        return {"ritz_val_gap": math.inf, "ritz_proj_gap": math.inf}
    gen = torch.Generator(rw.device).manual_seed(int(seed) % 2**63)
    z = torch.randn((rw.shape[0], 4), generator=gen, device=rw.device, dtype=torch.float64)
    wp, wr = _weighted_projection(pv, pw, z), _weighted_projection(rv, rw, z)
    return {
        "ritz_val_gap": float((torch.sort(pv.to(torch.float64)).values
                               - torch.sort(rv.to(torch.float64)).values).abs().max()),
        "ritz_proj_gap": float(torch.linalg.norm(wp - wr)
                               / torch.linalg.norm(wr).clamp_min(1e-300)),
    }


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.norm(v.to(torch.float64))) for k, v in leaves.items()}


def _leaf_gaps(prog: dict, ref: dict, keys) -> list[float]:
    """Per leaf, ``|‖p‖ − ‖r‖| / max(‖r‖, the median leaf's ‖r‖)``."""
    keys = list(keys)
    if not keys:
        return [0.0]
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = float(torch.tensor([rn[k] for k in keys]).median())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in keys]


def _median(xs: list[float]) -> float:
    return float(torch.tensor(xs, dtype=torch.float64).median())


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``: ``losses``, ``grad_opt`` and ``change`` of the program's
    first steps; ``ref``: those of ``reference/train.py:first_steps``."""
    if set(prog["grad_opt"]) != set(ref["grad_opt"]) or len(prog["losses"]) != len(ref["losses"]):
        return {k: math.inf for k in ("loss_gap", "grad_norm_gap", "change_norm_gap",
                                      "change_median_gap")}
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(p) for p in prog["losses"]):
        loss_gap = math.inf
    gn = _norms(ref["grad"])
    med = float(torch.tensor(list(gn.values())).median())
    moved = [k for k, v in gn.items() if v >= TINY_GRAD * med]
    grad = _leaf_gaps(prog["grad_opt"], ref["grad_opt"], ref["grad_opt"])
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": max(grad), "change_norm_gap": max(change),
            "change_median_gap": _median(change)}


def infer_numbers(logits: torch.Tensor, preds: torch.Tensor, ref_logits: torch.Tensor) -> dict:
    """The program's logits ``[N, C]`` and predicted classes ``[N]``
    beside the reference's logits."""
    if logits.shape != ref_logits.shape or preds.shape[0] != ref_logits.shape[0]:
        return {"logits_gap": math.inf, "logits_max_gap": math.inf, "pred_margin_gap": math.inf}
    lp, lr = logits.to(torch.float32), ref_logits.to(torch.float32)
    rms = float(torch.sqrt((lr.to(torch.float64) ** 2).mean()).clamp_min(1e-30))
    diff = lp - lr
    preds = preds.to(lr.device).long()
    if bool(((preds < 0) | (preds >= lr.shape[1])).any()):
        return {"logits_gap": math.inf, "logits_max_gap": math.inf, "pred_margin_gap": math.inf}
    margin = lr.max(1).values - lr.gather(1, preds[:, None])[:, 0]
    return {
        "logits_gap": float(torch.linalg.norm(diff.to(torch.float64))
                            / torch.linalg.norm(lr.to(torch.float64)).clamp_min(1e-300)),
        "logits_max_gap": float(diff.abs().max()) / rms,
        "pred_margin_gap": float(margin.max()) / rms,
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number that has a
    limit finite and at or under it; a limit whose number is missing
    fails."""
    table = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in sorted(limits)}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
