"""The comparison that decides `correct`, and the device helpers it needs.

A cell's numbers are worst-case gaps between what the timed path produced
and what the plain reference (`benchmark/reference/`) works out from the
same inputs in float32 with TF32 off. Each number has its own limit in
`benchmark/limits/<workload>.json`, set from the readings that file
records; a run is correct when every number is finite and within its
limit.

Serving: for each of the seven outputs, over every answer the run
received, max |program - reference| over the answer's rows, divided by
the largest |reference| of that output in that answer.

Training: over the steps the reference follows,
- `loss`: max over the steps of |L_program - L_reference| / |L_reference|;
- `grad`: the first step's gradients as the optimizer got them (the
  program's from Adam's first moment after one step, m / (1 - beta1));
  per leaf the gap between the program's norm and the reference's, over
  the larger of the reference's norm of that leaf and of the median leaf;
  the worst leaf;
- `grad.median`: the median leaf's gap of the same, steady from seed to
  seed where the worst leaf's swings with the rounding of a few small
  BatchNorm leaves;
- `change`: the same of each leaf's change after the checked steps, over
  the leaves whose reference gradient is at least 1e-3 of the median
  leaf's (a bias under train-mode BatchNorm gets a gradient that is zero
  to rounding, and Adam moves it by about lr on the sign of that
  rounding).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.serve import OUTPUT_KEYS

SMALL_GRAD = 1e-3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


@contextlib.contextmanager
def tf32_off():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def load_limits(root: str, workload: str) -> Dict[str, float]:
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def _gap(a, r) -> float:
    a = np.asarray(a, np.float64)
    r = np.asarray(r, np.float64)
    if a.shape != r.shape or not np.isfinite(a).all():
        return math.inf
    return float(np.abs(a - r).max() / max(np.abs(r).max(), 1e-12))


def serve_numbers(answers: Iterable[Tuple[int, Optional[dict]]],
                  reference: Mapping[int, dict]) -> Dict[str, float]:
    """The worst gap of each output over the answers."""
    worst = dict.fromkeys(OUTPUT_KEYS, 0.0)
    for p, out in answers:
        for key in OUTPUT_KEYS:
            gap = math.inf if out is None or key not in out else \
                _gap(out[key], reference[p][key])
            worst[key] = max(worst[key], gap)
    return worst


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].detach().double())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              leaves: Iterable[str]) -> np.ndarray:
    """Each leaf's |‖program‖ - ‖reference‖| / max(‖reference‖, median
    leaf's ‖reference‖)."""
    leaves = list(leaves)
    med = float(np.median([reference[k] for k in leaves]))
    return np.array([abs(program.get(k, math.nan) - reference[k])
                     / max(reference[k], med, 1e-30) for k in leaves])


def _worst(gaps: np.ndarray) -> float:
    return float(gaps.max()) if np.isfinite(gaps).all() else math.inf


def train_numbers(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """program / reference: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    losses = list(program["losses"])
    if len(losses) != len(reference["losses"]) or \
            not all(math.isfinite(x) for x in losses):
        loss = math.inf
    else:
        loss = max(abs(a - r) / max(abs(r), 1e-12)
                   for a, r in zip(losses, reference["losses"]))
    g = reference["grad"]
    med = float(np.median(list(g.values())))
    kept = [k for k, v in g.items() if v >= SMALL_GRAD * med]
    grad = leaf_gaps(program["grad"], g, g)
    change = leaf_gaps(program["change"], reference["change"], kept)
    first = abs(losses[0] - reference["losses"][0]) / \
        max(abs(reference["losses"][0]), 1e-12) if losses else math.inf
    return {"loss": loss, "grad": _worst(grad),
            "grad.median": float(np.median(grad)), "change": _worst(change),
            # read by the calibration, not judged
            "loss.first": first, "change.median": float(np.median(change)),
            "leaves.left_out": float(len(g) - len(kept))}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit must be finite and within it, and every limit needs its number."""
    checks = {k: dict(value=float(numbers.get(k, math.nan)),
                      limit=float(limits[k])) for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
