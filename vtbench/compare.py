"""The numbers that decide ``correct``, each against its limit.

Training (the first three steps of the object the window drives, against
the reference following them from the same weights, inputs and draws):

- ``loss``: the largest relative gap of the three steps' losses;
- ``grad``: the first gradient as the optimizer got it (its first moment
  after one step over 1 - beta1), per leaf: the gap between the program's
  norm and the reference's, over the reference's norm of that leaf or of
  the median leaf, whichever is larger; the worst leaf;
- ``change``: the same of each leaf's change over the three steps, over
  the elements whose reference first gradient is at least a thousandth of
  the median leaf's root mean square: an element whose gradient is nought
  to rounding in the reference (a key's bias under softmax) moves under
  Adam by round-off alone. Leaves left with no such element are left out.

Serving: ``logits``, the largest gap between a served request's logits
and the reference's, over the largest magnitude of the reference's, the
worst of the sampled requests; a request never answered fails ``correct``
by itself (``failed``).

A cell's limits are the data file ``vtbench/limits/<cell>.json``, and
``PERF.md`` gives the readings each was set from.
"""

import json
import os
import statistics

import torch


def limits(root, cell):
    path = os.path.join(root, "vtbench", "limits", f"{cell}.json")
    with open(path) as f:
        return json.load(f)


def leaf_norms(tensors):
    """{name: float L2 norm}, in one pass over the device."""
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm(
        [tensors[n].float() for n in names])).tolist()
    return dict(zip(names, norms))


def worst_leaf_gap(prog, ref):
    """(gap, leaf): the largest over the leaves of |prog - ref| / max(ref,
    the median leaf of ref)."""
    med = statistics.median(ref.values())
    best = (0.0, None)
    for n in ref:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > best[0]:
            best = (gap, n)
    return best


def change_norms(prog_delta, ref_delta, ref_g1, floor=1e-3):
    """Each leaf's change norm, the program's and the reference's, over the
    elements whose reference first gradient reaches ``floor`` times the
    median leaf's root mean square (module doc)."""
    rms = statistics.median(float(g.float().pow(2).mean().sqrt())
                            for g in ref_g1.values())
    prog, ref = {}, {}
    for n, g in ref_g1.items():
        keep = g.abs() >= floor * rms
        if not bool(keep.any()):
            continue
        d = prog_delta[n].to(g.device)
        prog[n] = float(d[keep].float().norm())
        ref[n] = float(ref_delta[n][keep].float().norm())
    return prog, ref


def training_numbers(prog, ref):
    """``prog``: {"losses": [3 floats], "grad": {leaf: norm}, "delta":
    {leaf: change}}; ``ref`` the same and "g1" {leaf: first gradient} ->
    {number: (value, detail)}."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    grad, gleaf = worst_leaf_gap(prog["grad"], ref["grad"])
    pc, rc = change_norms(prog["delta"], ref["delta"], ref["g1"])
    change, cleaf = worst_leaf_gap(pc, rc)
    return {"loss": (loss, None), "grad": (grad, gleaf),
            "change": (change, cleaf)}


def logit_gap(served, ref):
    """served, ref: (n, classes) -> the worst request's max |served - ref|
    over its max |ref|."""
    gap = (served.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp(min=1e-30)
    return float((gap / scale).max())


def judge(numbers, lims):
    """[{"name", "value", "limit", "ok"}] of the numbers the cell's limits
    name, and whether all are within. A number without a limit is not
    compared (PERF.md names each, with its readings)."""
    rows = []
    for name, (value, detail) in numbers.items():
        if name not in lims:
            continue
        limit = lims[name]
        rows.append({"name": name, "value": value, "limit": limit,
                     "ok": value <= limit, "detail": detail})
    return rows, all(r["ok"] for r in rows)
