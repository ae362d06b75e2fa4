"""Allocation answers in a closed loop: the general generator of the "plan"
traffic mixes and the entry the window drives.

A mix file gives ``mode`` (the job's step, "train"), ``cycle``, a list of
job shapes (batch, sequence), and ``run``, the job's RunConfig. Every cycle
asks once for each shape, in an order drawn from the seed. The window drives
``HBMPlanner().plan(cfg, shape, run=...)`` with no registry and no store, so
every answer profiles its ladder afresh, as for a job the system has not
seen; it closes when the plan in flight at --seconds finishes, and counts
whole plans only.

The check (``portbench.reference.planner``) takes every answer of the
window: its ladder and job against the reference's, the planner's fit and
requirement against the reference's fit of the same readings, its selection
against the reference's, and the readings' cost per layer, which may not
fall below the 16 bytes a parameter that a float32 AdamW step keeps.

It also takes the arithmetic of the step that the planner times, at one
ladder point of each answer, drawn from the seed: there the program's own
build (``launch.dryrun.prepare_step``, which ``build_step`` runs) gets the
benchmark's weights, drawn from the seed into its parameters, and the
benchmark's tokens and labels, before the step runs as the planner runs it.
After the step the loss, the gradient as AdamW took it (from the first
moment, and again from the second) and each parameter's change are read,
leaf by leaf, and after the window the float32 reference
(``portbench.reference.train``) takes the same step from the same draws.
"""
from __future__ import annotations

import inspect
import math
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import weights as W
from portbench.harness import port_config
from portbench.reference import planner as ref
from portbench.reference import train as T


def schedule(traffic: dict, seed: int, n: int) -> List[tuple]:
    """The job shapes (B, S) of answers 0 .. n-1."""
    base = [tuple(s) for s in traffic["cycle"]]
    out: List[tuple] = []
    c = 0
    while len(out) < n:
        rng = np.random.default_rng(W.mix(seed, 5, c))
        out += [base[j] for j in rng.permutation(len(base))]
        c += 1
    return out[:n]


def checked_depth(seed: int, i: int, ladder: List[int]) -> int:
    """The ladder point of answer i whose step the check follows."""
    rng = np.random.default_rng(W.mix(seed, 6, i))
    return int(ladder[int(rng.integers(len(ladder)))])


def step_inputs(cfg: dict, seed: int, i: int, B: int, S: int, device):
    """The tokens and labels (B, S) of answer i's checked step."""
    g = torch.Generator(device=device)
    g.manual_seed(W.mix(seed, 8, i))
    return tuple(torch.randint(0, cfg["vocab_size"], (B, S), generator=g,
                               device=device, dtype=torch.int32)
                 for _ in range(2))


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors by its paths joined with dots."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def total(t: torch.Tensor) -> float:
    """The sum of every entry in float64, a chunk at a time."""
    return float(sum(torch.sum(c.double())
                     for c in t.detach().reshape(-1).split(T.CHUNK)))


def shape_name(mode: str, B: int, S: int) -> str:
    return f"{mode}_b{B}_s{S}"


def answer(report, cfg: dict, traffic: dict, B: int, S: int) -> Dict:
    """What the check reads of a PlanReport, as plain numbers."""
    sel = report.selection
    return {"B": B, "S": S, "job": report.job,
            "expected_job": f"{cfg['name']}:{shape_name(traffic['mode'], B, S)}",
            "ladder": [int(x) for x in report.ladder],
            "readings": [float(x) for x in report.per_dev_bytes],
            "slope": report.model.slope, "intercept": report.model.intercept,
            "r2": report.model.r2, "requirement_gib": report.requirement_gib,
            "gpus": sel.config.scale_out if sel is not None else 0,
            "param_dtype": traffic["run"]["param_dtype"]}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.answers: List[Dict] = []
        self.steps: List[Dict] = []
        self.planner = None

    def prepare(self) -> None:
        """The planner, with no registry and no store."""
        from repro_torch.configs.base import RunConfig
        from repro_torch.core.hbm_planner import HBMPlanner
        self.cfg = port_config(self.config)
        self.run = RunConfig(**self.traffic["run"])
        self.planner = HBMPlanner()

    def setup(self) -> None:
        """A whole answer for the first shape, then one profiled step of
        each other shape at the ladder's least depth: a step's products
        take the same shapes at every depth (B x S tokens by the layer's
        widths), so that warms every shape the window runs."""
        from repro_torch.core.hbm_planner import _reduced_depth
        self.prepare()
        (B, S), *rest = self.traffic["cycle"]
        self.plan(B, S)
        least = _reduced_depth(self.cfg, self.planner.depth_ladder(self.cfg)[0])
        for B, S in rest:
            self.planner.profile_memory(least, self.shape(B, S), self.run,
                                        self.device)

    def shape(self, B: int, S: int):
        from repro_torch.configs.base import ShapeConfig
        return ShapeConfig(shape_name(self.traffic["mode"], B, S), S, B,
                           self.traffic["mode"])

    def plan(self, B: int, S: int, i: Optional[int] = None) -> Dict:
        """One answer; with `i`, answer i of the seed, whose checked step
        is read."""
        with self.following(None if i is None else dict(
                i=i, B=B, S=S, depth=checked_depth(self.seed, i, ref.ladder(
                    self.config["n_layers"])))):
            report = self.planner.plan(self.cfg, self.shape(B, S),
                                       device=self.device, run=self.run)
        return answer(report, self.config, self.traffic, B, S)

    @contextmanager
    def following(self, due):
        """While the planner answers, its step at depth due["depth"] runs on
        the benchmark's weights and batch and is read (``read_step``)."""
        import repro_torch.core.hbm_planner as HP
        from repro_torch.launch.dryrun import prepare_step
        real = HP.build_step

        def build_step(cfg, shape, run=None, device=None, seed=0, mesh=None):
            if due is None or due.get("done") or mesh is not None or \
                    cfg.n_layers != due["depth"]:
                return real(cfg, shape, run, device, seed, mesh)
            due["done"] = True
            prepare = prepare_step(cfg, shape, run, device, seed, mesh)

            def step():
                built = prepare()
                state, batch = self.feed(built, due)
                if built.model.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(built.model.device)
                metrics = built.run()
                self.steps.append(self.read_step(due, state, metrics))
            return step

        HP.build_step = build_step
        try:
            yield
        finally:
            HP.build_step = real

    def feed(self, built, due):
        """The benchmark's weights and batch written into the step's own
        parameters and inputs -> (state, batch)."""
        names = inspect.getclosurevars(built.run).nonlocals
        state, batch = names["state"], names["batch"]
        cfg = dict(self.config, n_layers=due["depth"])
        W.fill(flat(state.params), cfg, W.mix(self.seed, 7, due["i"]))
        mine = step_inputs(cfg, self.seed, due["i"], due["B"], due["S"],
                           built.model.device)
        for key, t in zip(("tokens", "labels"), mine):
            if batch[key].shape != t.shape or batch[key].dtype != t.dtype:
                raise ValueError(f"the step's {key} are {batch[key].shape} "
                                 f"{batch[key].dtype}, not {t.shape} "
                                 f"{t.dtype}")
            batch[key].copy_(t)
        return state, batch

    @torch.no_grad()
    def read_step(self, due, state, metrics) -> Dict:
        """The loss, the norm of each leaf's gradient as AdamW took it (from
        m / (1 - b1), and from sqrt(sum v / (1 - b2))), and of each leaf's
        change from the weights drawn for it."""
        opt = self.traffic["optimizer"]
        cfg = dict(self.config, n_layers=due["depth"])
        params = flat(state.params)
        m, v = flat(state.opt.m), flat(state.opt.v)
        change = {}
        first = next(iter(params.values()))
        for name, p0 in W.draw(cfg, W.mix(self.seed, 7, due["i"]),
                               first.device, first.dtype):
            change[name] = T.norm(params[name] - p0)
            del p0
        return {**due, "loss": float(metrics["loss"]),
                "grad_m": {n: T.norm(t) / (1 - opt["b1"])
                           for n, t in m.items()},
                "grad_v": {n: math.sqrt(max(total(t), 0.0) / (1 - opt["b2"]))
                           for n, t in v.items()},
                "change": change}

    def window(self, seconds: float, mark) -> Dict:
        reqs = []
        start = time.monotonic()
        order = schedule(self.traffic, self.seed, 64)
        while True:
            if len(reqs) == len(order):
                order = schedule(self.traffic, self.seed, 2 * len(order))
            B, S = order[len(reqs)]
            t1 = time.monotonic()
            with mark("portbench.plan"):
                a = self.plan(B, S, len(reqs))
            t2 = time.monotonic()
            self.answers.append(a)
            reqs.append({"B": B, "S": S, "ladder": a["ladder"],
                         "latency_s": t2 - t1, "done": t2})
            if t2 - start >= seconds:
                break
        return {"requests": reqs, "window_s": reqs[-1]["done"] - start,
                "attempted": len(reqs), "failed": 0}

    def release(self) -> None:
        self.planner = None

    def check(self) -> Dict[str, float]:
        rows = [ref.numbers(self.config, a) for a in self.answers]
        rows += [self.step_numbers(s) for s in self.steps]
        out = {k: max(r[k] for r in rows if k in r)
               for r0 in rows for k in r0} if rows else {}
        if rows:
            out["step_missing"] = float(len(self.answers) - len(self.steps))
        return out

    def step_numbers(self, s: Dict) -> Dict[str, float]:
        """A checked step against the float32 reference's: the loss's
        relative gap, the worst leaf's gap of gradient norms and of change
        norms (``reference.train.worst_leaf``). Leaves whose reference
        gradient is under a thousandth of the median leaf's are left out of
        the gradients' gap: they move by rounding alone."""
        cfg = dict(self.config, n_layers=s["depth"])
        w = dict(W.draw(cfg, W.mix(self.seed, 7, s["i"]), self.device,
                        torch.float32))
        toks, labels = step_inputs(cfg, self.seed, s["i"], s["B"], s["S"],
                                   self.device)
        r = T.first_step(w, cfg, toks, labels, self.traffic["optimizer"])
        del w
        grads = sorted(r["grad"].values())
        small = {n for n, g in r["grad"].items()
                 if g < 1e-3 * grads[len(grads) // 2]}
        return {"loss_rel": abs(s["loss"] - r["loss"]) / abs(r["loss"]),
                "grad_rel": max(T.worst_leaf(s["grad_m"], r["grad"], small),
                                T.worst_leaf(s["grad_v"], r["grad"], small)),
                "param_moved": T.worst_leaf(s["change"], r["change"])}

    @staticmethod
    def end_to_end(record: Dict) -> Dict[str, float]:
        return {"plan_s": record["window_s"] / len(record["requests"])}
