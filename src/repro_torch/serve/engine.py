"""Batched serving engine: continuous batching over a fixed-slot KV cache.

The engine keeps `slots` concurrent sequences. Each scheduler tick:
  1. admit queued requests into free slots (prompt tokens are injected
     through the decode path token by token — teacher-forced prefill — so
     one decode_step serves both phases);
  2. run one batched decode_step for ALL slots, idle ones included;
  3. retire sequences that hit max tokens or EOS.

Greedy or temperature sampling, on the host: every tick copies the
(slots, V) logits off the device, as the JAX engine does.

The engine runs where its model lives: a model built with ``device=None`` is
on the GPU. The caches are updated in place by ``Model.decode_step`` and by
``_reset_slot``.

As the reference's engine, it feeds the vlm family all-zero float32
``media`` and the audio family an all-zero float32 ``enc_out`` of `slots`
rows at every tick (``_extras``); here they are made once, on the model's
device and in its compute dtype, since they hold the same values every tick
(``Model._extra`` then casts nothing).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = field(default_factory=time.monotonic)
    finished_at: Optional[float] = None


class ServeEngine:
    def __init__(self, model: Model, slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        # sampling happens on the host, from an explicit generator
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(seed)
        self.caches = model.init_caches(slots, max_len)
        self.active: List[Optional[Request]] = [None] * slots
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self.ticks = 0
        self._feed: List[List[int]] = [[] for _ in range(slots)]
        self._last_token = np.zeros((slots,), np.int64)
        self._extras = _extras(model, slots)

    # -- public ------------------------------------------------------------
    def submit(self, req: Request):
        self.pending.append(req)

    def run(self, max_ticks: int = 10000) -> List[Request]:
        ticks = 0
        while (self.pending or any(self.active)) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished

    # -- internals ----------------------------------------------------------
    def tick(self):
        self._admit()
        if not any(self.active):
            return
        batch = {"tokens": torch.from_numpy(self._last_token)[:, None],
                 **self._extras}
        logits, self.caches = self.model.decode_step(batch, self.caches)
        logits = logits[:, 0].float().cpu()           # (slots, V), a sync
        self.ticks += 1
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if self._feed[i]:
                # still teacher-forcing the prompt
                self._last_token[i] = self._feed[i].pop(0)
                continue
            tok = self._sample(logits[i], req.temperature)
            req.out_tokens.append(tok)
            self._last_token[i] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id)):
                req.done = True
                req.finished_at = time.monotonic()
                self.finished.append(req)
                self.active[i] = None

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                req = self.pending.pop(0)
                self.active[i] = req
                self.caches = _reset_slot(self.caches, i)
                self._feed[i] = list(req.prompt[1:])
                self._last_token[i] = req.prompt[0]

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))


def _extras(model: Model, slots: int) -> Dict[str, torch.Tensor]:
    """The reference's stand-ins for a request's media or audio: zeros."""
    cfg = model.cfg
    if cfg.family == "vlm":
        rows = cfg.cross_attn.n_media_tokens
        name = "media"
    elif cfg.family == "audio":
        rows = cfg.encdec.enc_len
        name = "enc_out"
    else:
        return {}
    return {name: torch.zeros((slots, rows, cfg.d_model),
                              dtype=model.compute_dtype, device=model.device)}


# base rank of each cache leaf kind; batch axis = ndim - base_rank
_BATCH_RANK = {"k": 4, "v": 4, "ckv": 3, "kr": 3, "pos": 1,
               "h": 4, "conv": 3, "wkv": 4, "tm_last": 2, "cm_last": 2}


def _reset_slot(caches: Dict, slot: int) -> Dict:
    """Zero one slot's state across all (stacked, nested) cache leaves, IN
    PLACE: per-row `pos` goes to 0 so stale KV beyond it is never attended;
    recurrent states (wkv, h, conv, tm_last, cm_last) are cleared."""
    for name, leaf in caches.items():
        if isinstance(leaf, dict):
            _reset_slot(leaf, slot)
            continue
        rank = _BATCH_RANK.get(name)
        if rank is None or leaf.dim() < rank:
            continue
        leaf.select(leaf.dim() - rank, slot).zero_()
    return caches
