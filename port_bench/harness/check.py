"""The comparisons that decide ``correct``: each number, worked out from
the program's readings and the plain reference's, against its limit in
``<dir>/limits/<workload>.json``.

Training (the first three steps, which set-up drives through the window's
own call): ``loss1_gap``, ``loss2_gap``, ``loss3_gap``, the relative gap
of each step's loss, and ``kl1_gap`` of the first step's mean KL term;
``grad_gap`` and ``grad_median_gap``, the worst and the median leaf's gap
between the norms of the first gradient as the optimizer takes it (the
program's worked out from its Adam state after one step);
``change_gap`` and ``change_median_gap``, the same of the parameters'
change over the three steps, leaving out leaves whose reference gradient
is under a thousandth of the median leaf's (a conv bias ahead of
BatchNorm: it moves by round-off alone). Each leaf's gap is measured
against the reference's norm of that leaf or of the median leaf,
whichever is larger. A cell's limits file names the numbers it compares.

Serving: ``recon_gap``, the largest absolute difference of a served
image's pixel from the reference's reconstruct of the same request.
"""
import math

import numpy as np
import torch

SMALL_GRAD = 1e-3


def _norms(tensors, names):
    return {k: float(torch.linalg.vector_norm(tensors[k].double()))
            for k in names}


def leaf_gaps(program, reference, names):
    """|‖program‖ - ‖reference‖| / max(‖reference‖, median leaf's
    ‖reference‖), a leaf of ``names`` each."""
    ref = _norms(reference, names)
    got = _norms(program, names)
    med = float(np.median(list(ref.values())))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in names}


def train_numbers(program, reference):
    """``program`` and ``reference``: ``losses`` (floats, a step each),
    ``kl1`` (the first step's mean KL), ``grads`` (the first step's, a
    dict by leaf), ``change`` (after the last step, a dict by leaf)."""
    out = {}
    for k, r in enumerate(reference["losses"], start=1):
        p = (program["losses"][k - 1] if k <= len(program["losses"])
             else math.nan)
        out[f"loss{k}_gap"] = abs(p - r) / abs(r)
    out["kl1_gap"] = abs(program["kl1"] - reference["kl1"]) \
        / abs(reference["kl1"])
    for name, key, names in (("grad", "grads", sorted(reference["grads"])),
                             ("change", "change", _moved(reference))):
        gaps = list(leaf_gaps(program[key], reference[key], names).values())
        out[f"{name}_gap"] = max(gaps)
        out[f"{name}_median_gap"] = float(np.median(gaps))
    return out


def _moved(reference):
    names = sorted(reference["grads"])
    ref = _norms(reference["grads"], names)
    med = float(np.median(list(ref.values())))
    return [k for k in names if ref[k] >= SMALL_GRAD * med]


def worst_leaves(program, reference):
    """The leaf of the largest gap of the first gradient's norm and of the
    change's, with the gap and the leaf's reference norm over the median
    leaf's: for the look behind a reading."""
    out = {}
    for key, names in (("grads", sorted(reference["grads"])),
                       ("change", _moved(reference))):
        gaps = leaf_gaps(program[key], reference[key], names)
        worst = max(gaps, key=gaps.get)
        out[key] = [worst, gaps[worst]]
    return out


def serve_numbers(outputs, references):
    """The largest |served - reference| over the sampled requests."""
    return {"recon_gap": max(float(np.max(np.abs(o - r)))
                             for o, r in zip(outputs, references))}


def judge(numbers, limits):
    """(correct, checks): every number at or under its limit (a NaN is
    not), and {name: {"value", "limit"}} in the limits' order."""
    checks = {k: {"value": float(numbers.get(k, math.nan)),
                  "limit": float(v)} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
