"""The reference's training steps and scoring pass.

A step is full-graph: the mean cross-entropy over the training nodes
(float32), its gradient, then Adam with L2 weight decay added to the
gradient before the moments (``torch.optim.Adam``'s coupled form:
betas 0.9 and 0.999, eps 1e-8, at the configuration's ``lr`` and
``wd``). Dropout draws its masks from the port's stream: a generator on
the device seeded as the run seeds the program's, one mask a layer and
a step, in layer order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import EXACT, Precision, dropout_masks

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def act_dtype(model: dict) -> torch.dtype:
    return torch.bfloat16 if str(model.get("dtype")) in ("bfloat16", "bf16") else torch.float32


def score(family, model: dict, params: dict, inputs: dict, prec: Precision = EXACT
          ) -> torch.Tensor:
    """Eval-mode logits ``[N, C]`` float32 (no dropout)."""
    with torch.no_grad():
        return family.logits(model, params, inputs["x"], inputs["op"], inputs["extras"], prec)


def first_steps(family, model: dict, train: dict, params0: dict, inputs: dict, steps: int,
                dropout_seed: int, prec: Precision = EXACT, half_batch: bool = False) -> dict:
    """``steps`` training steps from ``params0`` → ``{"losses": [...],
    "grad": {name: the first step's loss gradient}, "grad_opt": {name:
    that gradient plus weight decay, as Adam takes it}, "change": {name:
    parameters after the steps minus params0}}``. ``half_batch`` is a
    fault: the loss leaves out the second half of the training nodes and
    takes its mean over the rest."""
    x, labels, mask = inputs["x"], inputs["labels"], inputs["train_mask"].to(torch.float32)
    if half_batch:
        idx = torch.nonzero(mask).flatten()
        mask = mask.clone()
        mask[idx[len(idx) // 2:]] = 0.0
    count = mask.sum().clamp_min(1.0)
    lr, wd = float(train["lr"]), float(train.get("wd", 0.0))
    p_drop = float(model.get("dropout", 0.0))
    gen = torch.Generator(x.device).manual_seed(int(dropout_seed))
    dt = act_dtype(model)

    def drop(layer, h):
        return h * dropout_masks(gen, h.shape, p_drop, dt) if p_drop > 0 else h

    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params0.items()}
    out = {"losses": []}
    for t in range(1, steps + 1):
        lg = family.logits(model, params, x, inputs["op"], inputs["extras"], prec, drop)
        ce = F.cross_entropy(lg.to(torch.float32), labels, reduction="none")
        loss = (ce * mask).sum() / count
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                out["grad"] = {k: g.clone() for k, g in grads.items()}
                out["grad_opt"] = {k: g + wd * params[k] for k, g in grads.items()}
            c1, c2 = 1.0 - BETAS[0] ** t, 1.0 - BETAS[1] ** t
            for k, p in params.items():
                g = grads[k] + wd * p
                m[k].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = v2[k].sqrt() / c2 ** 0.5 + ADAM_EPS
                p.sub_(lr / c1 * m[k] / denom)
        del lg, ce, loss, grads
    out["change"] = {k: (p.detach() - params0[k]) for k, p in params.items()}
    return out
