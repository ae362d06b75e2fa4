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

Over a mesh (``launch.mesh``), ``moe(params, x, cfg, run, mesh)``
dispatches as the reference's does: ``moe_ep`` (experts over 'model', a
local dispatch of the tokens every model rank holds, the combine
all-reduced over 'model') or ``moe_ep_a2a`` (experts over 'model' x
'data', the tokens sent to their expert's data rank and back by two
all-to-alls). Both keep the reference's static capacity, C from T, top_k
and ``capacity_factor``, where the single-device ``moe`` sizes each
group by its largest count: under the rank-alone transport a count would
be read from zeros, and static shapes make a rank's peak what it is among
its peers. Their combines, like ``moe``'s, put each choice's output in
its own row and sum a token's k rows. impl "dense" (the reference's
``moe_dense``, dropless) runs ``moe_local`` over the rank's block of the
experts, its groups sized by their counts as on one device (the routing
is the rank's own, so the rank-alone transport reads real counts), and
all-reduces the combine over 'model'. The aux loss is the whole batch's
(``route`` over the mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.telemetry.spans import traced


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


def route(router_w, x, m: MoEConfig, mesh=None):
    """x: (T, d) -> gates (T, k) renormalised, in x's dtype; idx (T, k);
    aux, the switch-style load-balance loss E * sum(frac_e * mean_prob_e)
    over the first choice, float32. The softmax is taken in float32. As in
    the reference, aux's gradient flows through the mean probabilities
    only: frac is a count of first choices, off the graph.

    Over a mesh whose batch axes split the tokens, the counts and the
    probabilities' sums are summed over those axes first, so that aux is
    the whole batch's, as on one device. (The reference's expert-parallel
    paths average each rank's aux instead, which differs from its own
    one-device loss.)"""
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    E = m.n_experts
    axes = () if mesh is None else mesh.normalise(("pod", "data"))
    if not axes:
        frac = torch.bincount(idx[:, 0], minlength=E).float() / x.shape[0]
        aux = E * torch.sum(frac * probs.mean(0))
        return gates.to(x.dtype), idx, aux
    n = x.shape[0] * mesh.size(axes)
    counts = C.reduce_(torch.bincount(idx[:, 0], minlength=E).float(), mesh,
                       axes)
    mprob = C.all_reduce(probs.sum(0), mesh, axes) / n
    return gates.to(x.dtype), idx, E * torch.sum(counts / n * mprob)


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


def moe(params, x, cfg: ModelConfig, run: RunConfig = None, mesh=None):
    """x: (B, S, d) -> (out, aux). With no mesh (or one without a 'model'
    axis) ``moe_local``; over a mesh with one, ``moe_ep_a2a`` or
    ``moe_ep`` as ``cfg.moe.impl`` names them (the reference's dispatch),
    and ``moe_local`` over the rank's experts for impl "dense" (the
    reference's ``moe_dense``)."""
    if mesh is not None and "model" in mesh.axis_names:
        if cfg.moe.impl == "ep_a2a":
            return moe_ep_a2a(params, x, cfg, run, mesh)
        if cfg.moe.impl == "ep_tp":
            return moe_ep(params, x, cfg, run, mesh)
    return moe_local(params, x, cfg, mesh)


def moe_local(params, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, d) -> (out, aux): ``moe_dense``'s function, dropless (over
    a mesh: on this rank's tokens, with the whole batch's aux; where
    'model' splits the experts, over this rank's block of them, every
    other choice's row 0, the combine all-reduced over 'model').

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
    T, k = B * S, m.top_k
    xt = x.reshape(T, d)
    gates, idx, aux = route(params["router"], xt, m, mesh)
    if mesh is None:
        wg, wu, wd, split = params["w_gate"], params["w_up"], \
            params["w_down"], False
    else:
        wg, wu, wd, split = _experts(params, m, mesh)
    E = wg.shape[0]
    keys = idx.reshape(-1)
    if split:
        xt = C.enter_split(xt, mesh, "model")
        gates = C.enter_split(gates, mesh, "model")
        keys = keys - C.axis_index(mesh, "model") * E
        keys = torch.where((keys >= 0) & (keys < E), keys,
                           torch.full_like(keys, E))   # sorted last, no row
    order, e_s, rank, counts = _sort_choices(keys, E)
    tok = order // k                                # the choice's token
    y = (torch.zeros if split else torch.empty)(
        (T * k, d), dtype=x.dtype, device=x.device)
    with traced("moe.count_wait"):
        on_host = counts.tolist()
    for e0, n, cap, s0, s1 in _expert_groups(on_host, d * x.element_size()):
        local = (e_s[s0:s1] - e0) * cap + rank[s0:s1]
        xb = _GatherSlots.apply(xt, local, tok[s0:s1], n * cap)
        ws = slice(e0, e0 + n)
        yb = _local_expert_ffn(wg[ws], wu[ws], wd[ws], xb.view(n, cap, d))
        y[s0:s1] = yb.view(n * cap, d)[local]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * k, device=x.device)
    y = y[inverse].view(T, k, d)
    out = (y * gates[..., None]).sum(dim=1)
    if split:
        out = C.all_reduce(out, mesh, "model")
    return out.reshape(B, S, d) + _shared(params, x, cfg, mesh), aux


# ---------------------------------------------------------------------------
# expert parallelism over a mesh (the reference's moe_ep, moe_ep_a2a)
# ---------------------------------------------------------------------------


def _experts(params, m: MoEConfig, mesh):
    """(w_gate, w_up, w_down, split): this rank's experts, their ff gathered
    over 'data' where ``fsdp_experts`` split it (backward: the gradient
    reduce-scattered back), and whether 'model' splits the experts."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if wg.shape[-1] != m.d_ff_expert:
        wg = C.all_gather(wg, mesh, "data", wg.dim() - 1)
        wu = C.all_gather(wu, mesh, "data", wu.dim() - 1)
        wd = C.all_gather(wd, mesh, "data", wd.dim() - 2)
    return wg, wu, wd, wg.shape[0] != m.n_experts


def _shared(params, x, cfg: ModelConfig, mesh):
    m = cfg.moe
    if not m.n_shared_experts:
        return 0.0
    return L.mlp(params["shared"], x, "swiglu", mesh,
                 d_ff=m.d_ff_expert * m.n_shared_experts)


def _combine(rows, choice, gates, T: int, k: int):
    """sum_j gates[t, j] * rows of choice t * k + j: each choice's row put
    in its own place (`choice` -1 for an empty slot), summed over k in a
    fixed order."""
    d = rows.shape[-1]
    y = rows.new_zeros((T * k + 1, d))
    y[torch.where(choice >= 0, choice, T * k)] = rows
    y = y[:-1].view(T, k, d)
    return (y * gates[..., None]).sum(dim=1)


def moe_ep(params, x, cfg: ModelConfig, run: RunConfig, mesh):
    """Expert parallelism over 'model' (the reference's ``moe_ep``): x
    (B_l, S, d), this rank's batch, replicated over 'model'; each model
    rank holds E / M experts and dispatches every token's choices of them
    into (E / M, C, d) capacity buffers, C = T * top_k * capacity_factor
    / E. The combine is all-reduced over 'model', where a dense MLP's
    output would be too."""
    m = cfg.moe
    B_l, S, d = x.shape
    T, k = B_l * S, m.top_k
    xt = x.reshape(T, d)
    gates, idx, aux = route(params["router"], xt, m, mesh)
    wg, wu, wd, split = _experts(params, m, mesh)
    E_local = wg.shape[0]
    e_lo = C.axis_index(mesh, "model") * E_local if split else 0
    if split:
        xt = C.enter_split(xt, mesh, "model")
        gates = C.enter_split(gates, mesh, "model")
    cap = max(1, int(T * k * m.capacity_factor / m.n_experts))
    n = E_local * cap
    le = idx.reshape(-1) - e_lo
    key = torch.where((le >= 0) & (le < E_local), le,
                      torch.full_like(le, E_local))
    order, k_s, rank, _ = _sort_choices(key, E_local)
    valid = (k_s < E_local) & (rank < cap)
    dest = torch.where(valid, k_s * cap + rank, torch.full_like(rank, n))
    choice = torch.full((n + 1,), -1, dtype=torch.long, device=x.device)
    choice[dest] = order
    choice = choice[:n]
    xb = xt[(choice // k).clamp(min=0)].masked_fill((choice < 0)[:, None], 0)
    yb = _local_expert_ffn(wg, wu, wd, xb.view(E_local, cap, d))
    out = _combine(yb.view(n, d), choice, gates, T, k)
    if split:
        out = C.all_reduce(out, mesh, "model")
    out = out.reshape(B_l, S, d) + _shared(params, x, cfg, mesh)
    return out, aux


def moe_ep_a2a(params, x, cfg: ModelConfig, run: RunConfig, mesh):
    """DeepSeek-style expert parallelism over 'model' x 'data' (the
    reference's ``moe_ep_a2a``): E / (M D) experts a rank, expert e on
    model rank e // (D E_l) and data rank (e // E_l) % D. This rank holds
    the rules' block of E / M experts (replicated over 'data') and runs its
    data rank's E_l of them. The choices of this model rank's experts go
    to their data rank in (D, C_send, d) buffers by an all-to-all over
    'data', their metadata as float32 beside them; the expert outputs come
    back by a second, and the combine is all-reduced over 'model'."""
    m = cfg.moe
    B_l, S, d = x.shape
    T, k = B_l * S, m.top_k
    xt = x.reshape(T, d)
    gates, idx, aux = route(params["router"], xt, m, mesh)
    wg, wu, wd, split = _experts(params, m, mesh)
    M, D = C.axis_size(mesh, "model"), C.axis_size(mesh, "data")
    if m.n_experts % (M * D):
        raise ValueError(f"{m.n_experts} experts over model x data "
                         f"({M} x {D})")
    E_local = m.n_experts // (M * D)
    m_idx, d_idx = C.axis_index(mesh, "model"), C.axis_index(mesh, "data")
    lo = (m_idx * D + d_idx) * E_local - (m_idx * D * E_local if split
                                          else 0)
    wg, wu, wd = (w[lo:lo + E_local] for w in (wg, wu, wd))
    if M > 1:
        xt = C.enter_split(xt, mesh, "model")
        gates = C.enter_split(gates, mesh, "model")
    per_m = D * E_local
    le = idx - m_idx * per_m
    mine = (le >= 0) & (le < per_m)
    owner = torch.where(mine, le // E_local, torch.full_like(le, D))
    slot = torch.where(mine, le % E_local, torch.zeros_like(le))
    c_send = max(1, int(T * k * m.capacity_factor / (D * M)))
    order, dst_s, rank, _ = _sort_choices(owner.reshape(-1), D)
    t_s = order // k
    valid = (dst_s < D) & (rank < c_send)
    n_send = D * c_send
    dest = torch.where(valid, dst_s * c_send + rank,
                       torch.full_like(rank, n_send))
    send_x = xt.new_zeros((n_send + 1, d))
    send_x[dest] = xt[t_s] * valid[:, None]
    meta = torch.stack([(t_s + 1).float(), slot.reshape(-1)[order].float()],
                       dim=-1) * valid[:, None]
    send_meta = meta.new_zeros((n_send + 1, 2))
    send_meta[dest] = meta
    recv_x = C.all_to_all(send_x[:-1].view(D, c_send, d), mesh, "data")
    with torch.no_grad():
        recv_meta = C.all_to_all(send_meta[:-1].view(D, c_send, 2), mesh,
                                 "data").reshape(n_send, 2)
    rx = recv_x.reshape(n_send, d)
    rsrc = recv_meta[:, 0].long() - 1
    rslot = recv_meta[:, 1].long()
    c_loc = min(max(1, n_send // max(E_local, 1)), n_send)
    n_loc = E_local * c_loc
    key = torch.where(rsrc >= 0, rslot, torch.full_like(rslot, E_local))
    order2, k_s, rank2, _ = _sort_choices(key, E_local)
    valid2 = (k_s < E_local) & (rank2 < c_loc)
    dest2 = torch.where(valid2, k_s * c_loc + rank2,
                        torch.full_like(rank2, n_loc))
    xb = rx.new_zeros((n_loc + 1, d))
    xb[dest2] = rx[order2] * valid2[:, None]
    yb = _local_expert_ffn(wg, wu, wd, xb[:-1].view(E_local, c_loc, d))
    # the expert outputs back in the received layout, then to their source
    rows = torch.cat([yb.reshape(n_loc, d), yb.new_zeros((1, d))])[dest2]
    y_flat = rows.new_zeros((n_send + 1, d))
    y_flat[torch.where(valid2, order2, torch.full_like(order2, n_send))] = \
        rows
    y_back = C.all_to_all(y_flat[:-1].view(D, c_send, d), mesh, "data")
    back = torch.cat([y_back.reshape(n_send, d), y_back.new_zeros((1, d))])
    choice = torch.where(valid, order, torch.full_like(order, -1))
    out = _combine(back[dest], choice, gates, T, k)
    if M > 1:
        out = C.all_reduce(out, mesh, "model")
    out = out.reshape(B_l, S, d) + _shared(params, x, cfg, mesh)
    return out, aux
