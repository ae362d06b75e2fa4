"""Mixture of experts: the top-k router and the single-device paths.

``moe_dense`` is the reference's dropless path written out: every expert
runs over every token and its output is weighted by the token's gate for it
(zero where the expert was not chosen). It is the plain version, for the
tests and small checks: E x T x d x ff products, 32x the useful work at
deepseek-v3's 256 experts top-8.

``moe`` computes the same function through the reference's sort-based
capacity dispatch (``_dispatch_local``'s) over all experts, group by group
of consecutive experts, each group's capacity its largest expert's count,
so that nothing drops: each expert runs over its own tokens only, gathered
into (n, C, d) buffers, as batched matrix products. Knowing the counts
costs one wait for the device a layer. The combine puts each choice's
expert output in its own row and sums a token's k rows in a fixed order,
with no atomics, so that two runs give the same bits. Rows move by
gathers; the scatters are of indices, to distinct places. Under autograd
the gathers' backward is an accumulating ``index_put`` over a token's own
k rows; on an H100 it gave the same bits on every backward pass
(``test_moe_loss_gradients_give_the_same_bits_twice``, and chip_smoke.py's
bit-exact resume of olmoe-1b-7b at full width), so the dispatch needs no
other form for training.

The expert-parallel paths of the reference (``moe_ep``, ``moe_ep_a2a``)
run over a mesh of devices and are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _expert_fan_in(cfg: ModelConfig) -> dict:
    """Fan-in of each expert leaf as the reference's ``dense_init`` takes
    it: the leading axis of the (E, d, ff) leaf for w_gate and w_up (the
    expert count), ff for w_down."""
    m = cfg.moe
    return {"w_gate": m.n_experts, "w_up": m.n_experts,
            "w_down": m.d_ff_expert}


def init_moe(generator, cfg: ModelConfig, *, dtype=torch.float32,
             device=None):
    """{"router" (d, E), "w_gate", "w_up" (E, d, ff), "w_down" (E, ff, d),
    "shared" (a swiglu MLP of n_shared x ff) when the config has shared
    experts}, drawn by `fill_moe` (nothing is drawn on the meta device)."""
    m, d = cfg.moe, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    p = {"router": torch.empty((d, m.n_experts), **kw),
         "w_gate": torch.empty((m.n_experts, d, m.d_ff_expert), **kw),
         "w_up": torch.empty((m.n_experts, d, m.d_ff_expert), **kw),
         "w_down": torch.empty((m.n_experts, m.d_ff_expert, d), **kw)}
    if m.n_shared_experts:
        ff = m.d_ff_expert * m.n_shared_experts
        p["shared"] = {"gate": torch.empty((d, ff), **kw),
                       "up": torch.empty((d, ff), **kw),
                       "down": torch.empty((ff, d), **kw)}
    if torch.device(device or "cpu").type != "meta":
        fill_moe(p, generator, cfg)
    return p


@torch.no_grad()
def fill_moe(p, generator, cfg: ModelConfig):
    """Draw a moe tree IN PLACE, one expert at a time: at deepseek-v3's
    width one layer's experts are 22.5 GB in bfloat16, and a float32 draw of
    a whole leaf would need 15 GB more beside the model."""
    m, d = cfg.moe, cfg.d_model
    kw = dict(dtype=p["router"].dtype, device=p["router"].device)
    p["router"].copy_(L.dense_init(generator, (d, m.n_experts), **kw))
    for name, fan_in in _expert_fan_in(cfg).items():
        leaf = p[name]
        for e in range(leaf.shape[0]):
            leaf[e].copy_(L.dense_init(generator, leaf.shape[1:],
                                       in_axis_size=fan_in, **kw))
    if "shared" in p:
        for name, value in L.init_mlp(
                generator, d, m.d_ff_expert * m.n_shared_experts, "swiglu",
                **kw).items():
            p["shared"][name].copy_(value)
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route(router_w, x, m: MoEConfig):
    """x: (T, d) -> gates (T, k) renormalised, in x's dtype; idx (T, k);
    aux, the switch-style load-balance loss E * sum(frac_e * mean_prob_e)
    over the first choice, float32. The softmax is taken in float32. As in
    the reference, aux's gradient flows through the mean probabilities
    only: frac is a count of first choices, off the graph."""
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    E = m.n_experts
    frac = torch.bincount(idx[:, 0], minlength=E).float() / x.shape[0]
    aux = E * torch.sum(frac * probs.mean(0))
    return gates.to(x.dtype), idx, aux


# ---------------------------------------------------------------------------
# dense (dropless) plain version
# ---------------------------------------------------------------------------


def moe_dense(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out, aux). Every expert processes every token; the
    gate-masked combine keeps the chosen ones."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gates, idx, aux = route(params["router"], xt, m)
    comb = torch.zeros((B * S, m.n_experts), dtype=x.dtype, device=x.device)
    comb.scatter_(1, idx, gates)             # the k choices of a row differ
    g = torch.einsum("td,edf->tef", xt, params["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xt, params["w_up"].to(x.dtype))
    y = torch.einsum("tef,efd->ted", F.silu(g) * u,
                     params["w_down"].to(x.dtype))
    out = torch.einsum("ted,te->td", y, comb).reshape(B, S, d)
    if m.n_shared_experts:
        out = out + L.mlp(params["shared"], x, "swiglu")
    return out, aux


# ---------------------------------------------------------------------------
# sort-based dispatch into capacity buffers
# ---------------------------------------------------------------------------


def _local_expert_ffn(w_gate, w_up, w_down, xb):
    """xb: (E_local, C, d) capacity buffers -> (E_local, C, d). Each weight
    is cast to xb's dtype where it is used, so that a float32 pass over
    bfloat16 experts holds one cast leaf at a time (15 GB of a deepseek-v3
    layer's 45)."""
    h = F.silu(torch.bmm(xb, w_gate.to(xb.dtype))) * \
        torch.bmm(xb, w_up.to(xb.dtype))
    return torch.bmm(h, w_down.to(xb.dtype))


# The capacity buffer of one group of experts (n experts x C slots x d), in
# bytes: what ``moe`` holds at once is bounded by it. At random init
# deepseek-v3's routing puts ~8x the mean count on one expert; its 256
# experts padded to that count took 7.4 GB a buffer, and the card ran out.
GROUP_BYTES = 1 << 30


def _sort_choices(keys, n_keys: int):
    """The T * k choices sorted by key (stable: in token order within a
    key): (order, the sorted keys, each sorted choice's rank among its key's,
    the count of each key below n_keys). Keys run from 0 to n_keys; n_keys
    is a sentinel that sorts last and is not counted."""
    order = torch.argsort(keys, stable=True)
    k_s = keys[order]
    counts = torch.bincount(keys, minlength=n_keys + 1)[:n_keys]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(keys.numel(), device=keys.device) - \
        starts[k_s.clamp(max=n_keys - 1)]
    return order, k_s, rank, counts


def _dispatch_local(xt, idx, gates, e_lo: int, E_local: int, C: int):
    """Gather the tokens assigned to experts [e_lo, e_lo + E_local) into
    capacity buffers of C slots. xt: (T, d); idx, gates: (T, k).

    Returns xb (E_l, C, d) token buffers, src (E_l, C) source-token index
    (-1 = empty slot), w (E_l, C) gate weights. The choices are sorted by
    local expert (experts outside the range sort last); a choice's rank is
    its place among its expert's, and a choice of rank C or more is
    dropped, as in the reference. Every scatter writes distinct places (the
    dropped choices go to a spare slot that is cut off), and xb is a
    gather."""
    T, k = idx.shape
    n = E_local * C
    le = idx.reshape(-1) - e_lo                     # local expert id
    is_local = (le >= 0) & (le < E_local)
    le_key = torch.where(is_local, le, torch.full_like(le, E_local))
    order, le_s, rank, _ = _sort_choices(le_key, E_local)
    valid = (le_s < E_local) & (rank < C)
    dest = torch.where(valid, le_s * C + rank, torch.full_like(rank, n))
    src = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    src[dest] = order // k                          # the choice's token
    src = src[:n].view(E_local, C)
    w = torch.zeros((n + 1,), dtype=gates.dtype, device=gates.device)
    w[dest] = gates.reshape(-1)[order]
    w = w[:n].view(E_local, C)
    xb = xt[src.clamp(min=0)].masked_fill((src < 0)[..., None], 0)
    return xb, src, w


def _expert_groups(counts, row_bytes: int):
    """Consecutive groups of experts (e0, n, C, s0, s1): experts e0 ..
    e0 + n - 1, padded to their largest count C, whose choices are s0:s1 of
    the sorted order. A group grows while its buffer of n * C rows of
    row_bytes stays within GROUP_BYTES (it holds one expert at least);
    groups with no choice are left out."""
    groups, e0, s0 = [], 0, 0
    while e0 < len(counts):
        n, C = 1, counts[e0]
        while e0 + n < len(counts) and \
                (n + 1) * max(C, counts[e0 + n]) * row_bytes <= GROUP_BYTES:
            C = max(C, counts[e0 + n])
            n += 1
        s1 = s0 + sum(counts[e0:e0 + n])
        if C:
            groups.append((e0, n, C, s0, s1))
        e0, s0 = e0 + n, s1
    return groups


class _GatherSlots(torch.autograd.Function):
    """The n_slots rows of a group's buffer: xt[tok] at the slots `local`,
    token 0 at the padded ones. The backward sums the gradients of the
    `local` slots into their tokens and drops the padded slots' (0, as
    their outputs are never read): autograd of the gather would sum those
    into token 0 as well, and tens of thousands of them on one token took a
    quarter of olmoe-1b-7b's train step."""

    @staticmethod
    def forward(ctx, xt, local, tok, n_slots):
        src = torch.zeros((n_slots,), dtype=torch.long, device=xt.device)
        src[local] = tok
        ctx.save_for_backward(local, tok)
        ctx.rows = xt.shape[0]
        return xt[src]

    @staticmethod
    def backward(ctx, g):
        local, tok = ctx.saved_tensors
        gx = g.new_zeros((ctx.rows, g.shape[-1]))
        gx.index_put_((tok,), g[local], accumulate=True)
        return gx, None, None, None


def moe(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out, aux): ``moe_dense``'s function, dropless.

    The capacity dispatch of ``_dispatch_local`` over all experts, taken
    group by group (``_expert_groups``): each group of consecutive experts
    is padded to its own largest count, so nothing drops and the buffers
    stay within GROUP_BYTES. At a decode step every expert fits one group,
    padded to the largest count. One sort of the choices serves every
    group; knowing the counts costs one wait for the device. Under a
    ``torch.utils.checkpoint`` remat the recompute routes the same inputs
    again, so it sees the same counts and the same buffer shapes. Rows move by
    gathers only: a padded slot reads token 0 (its output is never read;
    ``_GatherSlots``), a group's outputs land in sorted order as one
    contiguous slice, and one gather by the inverse of the sort puts them
    back in choice order. The k rows of a token are weighted by their
    gates and summed over k."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xt = x.reshape(T, d)
    gates, idx, aux = route(params["router"], xt, m)
    order, e_s, rank, counts = _sort_choices(idx.reshape(-1), E)
    tok = order // k                                # the choice's token
    y = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    for e0, n, C, s0, s1 in _expert_groups(counts.tolist(),
                                           d * x.element_size()):
        local = (e_s[s0:s1] - e0) * C + rank[s0:s1]
        xb = _GatherSlots.apply(xt, local, tok[s0:s1], n * C)
        ws = slice(e0, e0 + n)
        yb = _local_expert_ffn(params["w_gate"][ws], params["w_up"][ws],
                               params["w_down"][ws], xb.view(n, C, d))
        y[s0:s1] = yb.view(n * C, d)[local]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * k, device=x.device)
    y = y[inverse].view(T, k, d)
    out = (y * gates[..., None]).sum(dim=1).reshape(B, S, d)
    if m.n_shared_experts:
        out = out + L.mlp(params["shared"], x, "swiglu")
    return out, aux
