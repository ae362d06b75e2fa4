"""Prompt prefill in a closed loop: the general generator of the "prefill"
traffic mixes and the entry the window drives.

A mix file gives ``tokens_per_batch`` and ``cycle``, a list of (prompt
length S, batches of that length in each cycle). Every cycle holds the same
batches, in an order drawn from the seed, so every seed asks for the same
work. A batch of length S holds as many prompts of S tokens as fit in
tokens_per_batch (tokens_per_batch // S), drawn from the seed; one batch is
in flight at a time. The window drives
``Model.prefill(batch, max_len=S)`` and ends a batch when the last
position's logits are on the host; each prompt's latency is its batch's,
from dispatch to those logits.

The check: one batch of each length of the first cycle, drawn from the
seed, keeps its output (last-position logits on the host, every layer's KV
cache on the device). After the window the plain float32 reference
(``portbench.reference.transformer``) runs those prompts on weights it draws
again from the seed. The numbers read are relative errors (the L2 norm of
the difference over the reference's) of every layer's k and v and of the
logits, the gap by which the program's first token lies below the
reference's best logit, and the cache positions; past the first MoE layer
they leave out the tokens whose routing the reference finds tied within
rounding (``compare``). The cell's limits file names those compared.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import weights as W
from portbench.harness import port_config
from portbench.reference import transformer as ref

# router-logit gap under which the reference's top_k-th and next expert
# count as tied within rounding (``compare``); set from the readings
ROUTE_MARGIN = 0.005

def schedule(traffic: dict, seed: int, n: int) -> List[int]:
    """The prompt length of batches 0 .. n-1."""
    base = [S for S, count in traffic["cycle"] for _ in range(count)]
    out: List[int] = []
    c = 0
    while len(out) < n:
        rng = np.random.default_rng(W.mix(seed, 1, c))
        out += [base[j] for j in rng.permutation(len(base))]
        c += 1
    return out[:n]


def samples(traffic: dict, seed: int) -> List[int]:
    """The batches of the first cycle whose outputs are checked: one of each
    length, drawn from the seed."""
    first = schedule(traffic, seed, sum(c for _, c in traffic["cycle"]))
    rng = np.random.default_rng(W.mix(seed, 4))
    out = []
    for S, _ in traffic["cycle"]:
        where = [i for i, s in enumerate(first) if s == S]
        out.append(int(where[rng.integers(len(where))]))
    return sorted(out)


def tokens(cfg: dict, seed: int, stream: int, i: int, B: int, S: int,
           device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(W.mix(seed, stream, i))
    return torch.randint(0, cfg["vocab_size"], (B, S), generator=g,
                         device=device)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float32 (L2 over every entry); inf where the shapes
    differ or the result is not finite."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    a, b = a.to(b.device, torch.float32), b.float()
    out = float((a - b).norm() / b.norm().clamp(min=1e-30))
    return out if np.isfinite(out) else float("inf")


def reference_weights(cfg: dict, seed: int, dtype: torch.dtype, device
                      ) -> Dict[str, torch.Tensor]:
    """The seed's weights, drawn again as the program got them, in float32."""
    out = {}
    for name, t in W.draw(cfg, seed, device, dtype):
        out[name] = t.float()
        del t
    return out


def compare(cfg: dict, weights, toks: torch.Tensor, last: torch.Tensor,
            kv: Dict[str, torch.Tensor], margins=None) -> Dict[str, float]:
    """The numbers of one batch: the program's (or the control's) last
    logits (B, V) and caches {"k", "v": (L, B, S, K, D), "pos": (L, B)}
    against the float32 reference over `toks` (B, S).

    A token whose top_k-th and next expert the reference's router puts
    within `margin` (logit units) of each other, at some MoE layer, may take
    the other expert in the program by rounding alone, and its state moves
    by that expert's share: the k and v of the layers after that one, and
    the logits where it is a prompt's last token, are compared over the
    other tokens only (layer 0's over all). ``logits_rel.median`` is the
    median over the prompts of each one's relative error of its logits,
    over all of them: a prompt whose routing turned at a tie reads high
    alone, while a fault of the last layer, the final norm or the head
    moves them all. `margins` (default
    (ROUTE_MARGIN,)) gives the numbers for its first margin under their
    names, and for any further one under "<name>@<margin>"."""
    B, S = toks.shape
    margins = tuple(margins or (ROUTE_MARGIN,))
    clean = {t: torch.ones((B, S), dtype=torch.bool, device=toks.device)
             for t in margins}
    errs = {t: [] for t in margins}
    whole = []
    ok = tuple(kv["k"].shape[1:3]) == (B, S) and \
        tuple(kv["v"].shape[1:3]) == (B, S)

    def observe(layer, k, v):
        here = ok and layer < kv["k"].shape[0]
        whole.append(max(rel(kv["k"][layer], k), rel(kv["v"][layer], v))
                     if here else float("inf"))
        for t in margins:
            m = clean[t]
            errs[t].append(max(rel(kv["k"][layer][m], k[m]),
                               rel(kv["v"][layer][m], v[m]))
                           if here and bool(m.any()) else float("inf"))

    def route(layer, gap):
        for t in margins:
            clean[t] &= gap >= t

    best = ref.prefill(weights, cfg, toks, observe=observe, route=route).cpu()
    last = last.float().cpu()[..., :cfg["vocab_size"]]
    pos = kv.get("pos")
    pos_wrong = float("inf") if pos is None or \
        tuple(pos.shape) != (cfg["n_layers"], B) \
        else float((pos.long() != S).sum())
    out = {"pos_wrong": pos_wrong,
           "kv_rel.deep_all": max(whole[2:], default=whole[-1])}
    for n, t in enumerate(margins):
        rows = clean[t][:, -1].cpu()
        layer = errs[t]
        if tuple(last.shape) == tuple(best.shape) and bool(rows.any()):
            mine, ref_rows = last[rows], best[rows]
            gap = float((ref_rows.max(-1).values - ref_rows.gather(
                -1, mine.argmax(-1)[:, None])[:, 0]).max())
            lg = rel(mine, ref_rows)
        else:
            gap = lg = float("inf")
        if n == 0:
            out["logits_rel.median"] = float(np.median(
                [rel(last[b], best[b]) for b in range(B)])) \
                if tuple(last.shape) == tuple(best.shape) else float("inf")
        tag = "" if n == 0 else f"@{t:g}"
        out.update({
            f"kv_rel.layer0{tag}": layer[0],
            f"kv_rel.layer1{tag}": layer[min(1, len(layer) - 1)],
            f"kv_rel.deep{tag}": max(layer[2:], default=layer[-1]),
            f"logits_rel{tag}": lg, f"top_gap{tag}": gap,
            f"clean.tokens{tag}": float(clean[t].float().mean()),
            f"clean.logits{tag}": float(rows.float().mean())})
    return out


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of each number over the batches: the largest, and the
    least share of the tokens compared."""
    pick = {k: min if k.startswith("clean.") else max for k in rows[0]}
    return {k: pick[k](r[k] for r in rows) for k in rows[0]}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.tpb = traffic["tokens_per_batch"]
        self.lengths = [S for S, _ in traffic["cycle"]]
        self.samples = set(samples(traffic, seed))
        self.kept: Dict[int, tuple] = {}
        self.model = None

    def _kv(self, caches):
        return caches["moe"] if self.config["family"] == "moe" else caches

    def setup(self) -> None:
        from repro_torch.configs.base import RunConfig
        from repro_torch.models.model import Model
        run = RunConfig(**self.traffic["run"])
        self.model = Model(port_config(self.config), run, device=self.device)
        W.fill(dict(self.model.state_dict()), self.config, self.seed)
        for S in self.lengths:           # every shape the window runs
            toks = tokens(self.config, self.seed, 3, S, self.tpb // S, S,
                          self.device)
            logits, caches = self.model.prefill({"tokens": toks}, S)
            logits[:, -1].float().cpu()
            del logits, caches

    def batch(self, i: int, S: int, mark) -> Dict:
        """Batch i of length S through the program; its output is kept
        where batch i is a sample."""
        B = self.tpb // S
        with mark("portbench.tokens"):
            toks = tokens(self.config, self.seed, 2, i, B, S, self.device)
        t1 = time.monotonic()
        with mark("portbench.prefill"):
            logits, caches = self.model.prefill({"tokens": toks}, S)
        with mark("portbench.logits_to_host"):
            last = logits[:, -1].float().cpu()
        t2 = time.monotonic()
        if i in self.samples:
            self.kept[i] = (toks, last, self._kv(caches))
        return {"B": B, "S": S, "latency_s": t2 - t1, "done": t2}

    def window(self, seconds: float, mark) -> Dict:
        reqs = []
        start = time.monotonic()
        order = schedule(self.traffic, self.seed, 64)
        while True:
            if len(reqs) == len(order):
                order = schedule(self.traffic, self.seed, 2 * len(order))
            reqs.append(self.batch(len(reqs), order[len(reqs)], mark))
            # the window holds the samples, all in the first cycle
            if reqs[-1]["done"] - start >= seconds and \
                    len(reqs) > max(self.samples):
                break
        return {"requests": reqs, "window_s": reqs[-1]["done"] - start,
                "attempted": sum(r["B"] for r in reqs), "failed": 0}

    def reseed(self, seed: int) -> None:
        """The same program with the weights, prompts and samples of
        another seed (for readings over many seeds in one process)."""
        self.seed, self.kept = seed, {}
        self.samples = set(samples(self.traffic, seed))
        W.fill(dict(self.model.state_dict()), self.config, seed)

    def release(self) -> None:
        self.model = None
        gc.collect()

    def check(self) -> Dict[str, float]:
        rows = []
        if self.kept:
            w = reference_weights(self.config, self.seed, getattr(
                torch, self.traffic["run"]["param_dtype"]), self.device)
            for i in sorted(self.kept):
                toks, last, kv = self.kept[i]
                rows.append(compare(self.config, w, toks, last, kv))
            del w
        return worst(rows) if rows else {}

    @staticmethod
    def end_to_end(record: Dict) -> Dict[str, float]:
        lat = np.concatenate([np.full(r["B"], r["latency_s"])
                              for r in record["requests"]])
        toks = sum(r["B"] * r["S"] for r in record["requests"])
        return {"prefill_tokens_per_s": toks / record["window_s"],
                "prefill_p95_ms": float(np.percentile(lat, 95)) * 1e3}
