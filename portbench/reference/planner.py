"""Plain reference of the planner's answer for a training job.

What the planner derives from its readings is worked out again here with
numpy and plain arithmetic, from the configuration file's sizes: the depth
ladder, the least-squares line through the readings, the requirement at full
depth, and the cheapest catalog entry that holds it. The readings themselves
are the card's (peaks of one step at each depth); they are held against what
a float32 AdamW step must keep for each layer it adds: the weight, its
gradient and the two moments, 16 bytes a parameter. A layer may cost more
(activations held at the peak), never less. This module imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

GiB = 1024 ** 3
R2_GATE = 0.99
LEEWAY = 0.05
# one NVIDIA H100 80GB HBM3 as the catalog states it: the bytes that
# torch.cuda.mem_get_info reports as total, less the per-card overhead
H100_BYTES = 85_017_493_504
OVERHEAD_GIB = 1.75
SCALE_OUTS = (1, 2, 4, 8, 16, 32, 64)
STATE_BYTES = {"float32": 16}


def layer_params(cfg: dict) -> int:
    """Parameters of one layer of a dense decoder (two norms, attention,
    SwiGLU MLP)."""
    d, H, K = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg.get("d_head") or d // H
    if cfg["family"] != "dense":
        raise ValueError(f"no count for family {cfg['family']!r}")
    return 2 * d + d * H * D + 2 * d * K * D + H * D * d + 3 * d * cfg["d_ff"]


def ladder(n_layers: int) -> List[int]:
    """The planner's five depths: anchor max(2, min(n / 4, 12)), five equally
    spaced integer depths from 2 up to it."""
    anchor = max(2, min(n_layers // 4, 12))
    lo = 2
    if anchor <= lo:
        return [anchor]
    step = (anchor - lo) / 4
    return sorted({int(round(lo + i * step)) for i in range(5)})


def fit(x, y, dtype=np.float64) -> Dict[str, float]:
    """Least squares y = slope x + intercept, with R^2."""
    x, y = np.asarray(x, dtype=dtype), np.asarray(y, dtype=dtype)
    xm, ym = x.mean(), y.mean()
    slope = ((x - xm) * (y - ym)).sum() / ((x - xm) ** 2).sum()
    intercept = ym - slope * xm
    res = ((y - (slope * x + intercept)) ** 2).sum()
    tot = ((y - ym) ** 2).sum()
    return {"slope": float(slope), "intercept": float(intercept),
            "r2": float(1.0 - res / tot) if tot > 0 else
            (1.0 if res == 0 else -math.inf)}


def requirement_gib(line: Dict[str, float], n_layers: int) -> float:
    if not line["r2"] > R2_GATE:
        return 0.0
    return max(0.0, line["slope"] * n_layers + line["intercept"]) * \
        (1.0 + LEEWAY) / GiB


def gpus(req_gib: float) -> int:
    """The fewest cards that hold the requirement, split evenly, each less
    its overhead; the largest entry where none does."""
    per = H100_BYTES / GiB - OVERHEAD_GIB
    for n in SCALE_OUTS:
        if req_gib <= per * n:
            return n
    return SCALE_OUTS[-1]


def numbers(cfg: dict, answer: Dict, dtype=np.float64) -> Dict[str, float]:
    """The numbers compared for one answer: `answer` holds the job's
    ``job`` and ``expected_job``, the ``ladder``, the ``readings`` (bytes),
    the planner's ``slope``, ``intercept``, ``r2``, ``requirement_gib`` and
    the ``gpus`` it selected."""
    line = fit(answer["ladder"], answer["readings"], dtype)
    req = requirement_gib(line, cfg["n_layers"])
    state = STATE_BYTES[answer["param_dtype"]] * layer_params(cfg)

    def gap(mine, theirs):
        return abs(mine - theirs) / max(abs(theirs), 1e-300)

    fit_rel = max(gap(answer["slope"], line["slope"]),
                  gap(answer["intercept"], line["intercept"]),
                  abs(answer["r2"] - line["r2"]),
                  gap(answer["requirement_gib"], req))
    wrong_job = answer["job"] != answer["expected_job"] or \
        list(answer["ladder"]) != ladder(cfg["n_layers"])
    return {"slope_below_state": max(0.0, (state - line["slope"]) / state),
            "fit_rel": fit_rel,
            "gpus_wrong": float(answer["gpus"] != gpus(req)),
            "job_wrong": float(wrong_job)}
