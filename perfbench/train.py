"""The check of the training window (windows/train.py): once the window
has closed, the reference (float32, its own model and solver on the same
weights; the family's ``reference_steps``) takes the same first steps on
the same buildings and draws, and each of the program's first steps is
held against it (:func:`numbers`).
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch


def draws(shapes: Dict[str, int], gen, device) -> Dict[str, torch.Tensor]:
    """One step's sampler draws, in the order the forward takes them."""
    return {k: torch.rand((n,), generator=gen, device=device)
            for k, n in shapes.items()}


def leaf_gaps(got: Dict, want: Dict, start: Dict[str, torch.Tensor]):
    """({leaf: grad gap}, {leaf: change gap}) of the program's record
    ``got`` against the reference's ``want`` (:func:`numbers` says what a
    gap is and which leaves count)."""
    gnorm = {n: float(g.double().norm()) for n, g in want["grad"].items()}
    med_g = float(np.median(list(gnorm.values())))
    keep = [n for n in gnorm if gnorm[n] >= 1e-3 * med_g]

    def gaps(a: Dict, b: Dict, base: Dict) -> Dict[str, float]:
        def norm(x, n):
            return float((x[n] - base[n]).double().norm() if base
                         else x[n].double().norm())
        na = {n: norm(a, n) for n in keep}
        nb = {n: norm(b, n) for n in keep}
        med = float(np.median(list(nb.values())))
        return {n: abs(na[n] - nb[n]) / max(nb[n], med) for n in keep}

    return gaps(got["first"], want["first"], {}), \
        gaps(got["after"], want["after"], start)


def numbers(got: Dict, want: Dict, start: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """The training check's numbers, ``got`` the program's record of its
    first steps, ``want`` the reference's, ``start`` the weights both
    began from:

      loss    the largest relative gap of a step's total loss;
      grad    the median, over the leaves, of the gap between the norms
              of the two first updates' buffers (the gradient as the
              optimizer takes it, weight decay added), over the
              reference's norm of that leaf or of the median leaf,
              whichever is larger;
      change  the same for the parameters' change over the steps;
      change_q90  the 90th percentile of the leaves' change gaps, which
              a fault that moves a tenth of the leaves wrongly raises;

    and, compared by no limit (PERF.md says why), ``grad_worst`` and
    ``change_worst``, the same gaps of the worst leaf. Leaves whose
    reference gradient is under a thousandth of the median leaf's
    (rounding alone moves them) are left out of the gaps."""
    loss = max(abs(g - w) / abs(w)
               for g, w in zip(got["totals"], want["totals"]))
    g, c = leaf_gaps(got, want, start)
    for name, leaf in (("grad", g), ("change", c)):
        top = sorted(leaf, key=leaf.get, reverse=True)[:3]
        print(f"training check: worst {name} leaves " + ", ".join(
            f"{n} {leaf[n]:.4g}" for n in top), file=sys.stderr)
    return {"loss": loss, "grad": float(np.median(list(g.values()))),
            "change": float(np.median(list(c.values()))),
            "change_q90": float(np.quantile(list(c.values()), 0.9)),
            "grad_worst": max(g.values()), "change_worst": max(c.values())}
