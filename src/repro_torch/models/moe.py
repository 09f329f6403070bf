"""Mixture-of-Experts MLP with capacity-bounded top-k dispatch (PyTorch).

Counterpart of the JAX package's ``models/moe.py``: the local path and the
sharded variants (``moe_apply_sharded``).  Dispatch, as in the reference:

  1. top-k gating over E experts, the router's dot in the activation dtype
     and only then upcast to f32;
  2. position within expert by a cumulative one-hot count over the
     token-major flattening [T*k]: a token's k choices in rank order, all
     before the next token's;
  3. capacity-bounded slot tables [E, C] (``C = capacity_for(cfg, T)``);
     an assignment at ``pos >= C`` is dropped, never overwritten (GShard);
  4. gather -> one batched product per expert weight -> weighted f32
     scatter-add back to token order.

The capacity depends on T, the number of tokens in the call, so a token's
output depends on what else shares its call: its chunk, its batch and the
batch's padding rows.  The reference behaves the same way, and the port
reproduces which tokens drop, not only the arithmetic.

``moe_apply_local`` takes one group [T, d].  ``moe_apply_grouped`` takes
[G, T, d] and gives each group its own dispatch and capacity, exactly as G
separate ``moe_apply_local`` calls would, while the expert products run
once over every group's slots: the paged decode step uses it with one
group per row, as the reference does on every backend but the TPU (its
``lax.map`` over rows).

``moe_apply_sharded`` runs the reference's ``shard_map`` bodies as
``local_map`` bodies over a ``DeviceMesh`` (strategies ``ep``, ``tp`` and
``a2a``; see its docstring).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import DEFAULT_DTYPE, dense_init, grad_placements


def _expert_stack(gen: torch.Generator, lead: Tuple[int, ...], n_experts: int, din: int,
                  dout: int) -> torch.Tensor:
    """N(0, 1/din) weights [*lead, E, din, dout] in bf16, drawn one
    [din, dout] matrix at a time: the f32 draw of a whole stack would not
    fit beside the weights at arctic-480b's width (35.7 GB for two layers)."""
    out = torch.empty((*lead, n_experts, din, dout), dtype=DEFAULT_DTYPE, device=gen.device)
    flat = out.view(-1, din, dout)
    scale = 1.0 / math.sqrt(din)
    for i in range(flat.shape[0]):
        w = torch.randn((din, dout), generator=gen, device=gen.device)
        flat[i].copy_(w.mul_(scale))
    return out


def moe_init(gen: torch.Generator, cfg, *, lead=()) -> Dict[str, Any]:
    """The reference's MoE parameters with a leading ``lead`` (the layer
    stack): ``router`` f32 [*lead, d, E]; ``w_gate``, ``w_up`` [*lead, E, d,
    ff]; ``w_down`` [*lead, E, ff, d]."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": dense_init(gen, d, E, lead=lead, dtype=torch.float32),
        "w_gate": _expert_stack(gen, tuple(lead), E, d, ff),
        "w_up": _expert_stack(gen, tuple(lead), E, d, ff),
        "w_down": _expert_stack(gen, tuple(lead), E, ff, d),
    }


# ---------------------------------------------------------------------------
# dispatch core
# ---------------------------------------------------------------------------


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, equal values in
    order of the lower index.  ``torch.topk`` does not promise that order
    (and the bf16 router logits tie often), so a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x, router, k: int, capacity: int):
    """Slot tables for capacity-bounded top-k dispatch.

    x: [..., T, d] (leading axes are independent groups) ->
    (slot_tokens [..., E, C] int64 in [0, T] (T = empty / dropped),
     slot_gates [..., E, C] f32, aux_loss [...] f32)
    """
    *lead, T, _ = x.shape
    E = router.shape[-1]
    logits = (x @ router.to(x.dtype)).float()  # [..., T, E]
    gates_full = torch.softmax(logits, dim=-1)
    top_logits, top_e = _top_k(logits, k)  # [..., T, k]
    top_w = torch.softmax(top_logits, dim=-1)  # renormalized over the chosen

    flat_e = top_e.reshape(*lead, T * k)  # token-major
    flat_w = top_w.reshape(*lead, T * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)  # [..., T*k, E]
    pos = torch.gather(torch.cumsum(onehot, dim=-2) - 1, -1, flat_e[..., None])[..., 0]
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k).expand_as(flat_e)

    # one extra column per expert takes every assignment at pos >= C: the
    # reference's mode="drop" (the column is cut off below)
    col = torch.clamp(pos, max=capacity).long()
    flat_slot = flat_e * (capacity + 1) + col  # into the flattened [E, C + 1]
    slot_tokens = torch.full((*lead, E * (capacity + 1)), T, dtype=torch.long, device=x.device)
    slot_gates = torch.zeros((*lead, E * (capacity + 1)), dtype=torch.float32, device=x.device)
    slot_tokens.scatter_(-1, flat_slot, token_idx)
    slot_gates.scatter_(-1, flat_slot, flat_w)
    slot_tokens = slot_tokens.reshape(*lead, E, capacity + 1)[..., :capacity]
    slot_gates = slot_gates.reshape(*lead, E, capacity + 1)[..., :capacity]

    # GShard aux loss: E * mean_e(frac_tokens_e * mean_gate_e)
    frac = onehot.float().reshape(*lead, T, k, E).sum(-2).mean(-2)
    mean_gate = gates_full.mean(-2)
    aux = E * (frac * mean_gate).sum(-1)
    return slot_tokens, slot_gates, aux


def _expert_ffn(xg, wg, wu, wd):
    """xg: [E, C, d]; w*: [E, d, ff] / [E, ff, d] -> [E, C, d]: one batched
    product per weight (the reference's einsums, outside any kernel)."""
    h = F.silu(torch.bmm(xg, wg)) * torch.bmm(xg, wu)
    return torch.bmm(h, wd)


def _combine(slot_tokens, slot_gates, y, T: int, d: int, dtype):
    """Weighted scatter-add of expert outputs [..., E, C, d] back to token
    order [..., T, d].  The sum runs in f32 into T + 1 rows (the last takes
    the empty slots).  A token receives at most k contributions from k
    distinct experts, and for k <= 2 an f32 sum onto zero is the same in any
    order, so ``index_add_``'s unordered atomics on the card give the
    reference's values."""
    *lead, E, C, _ = y.shape
    G = math.prod(lead)
    w = (y.float() * slot_gates[..., None]).reshape(G * E * C, d)
    rows = slot_tokens.reshape(G, E * C) + (T + 1) * torch.arange(G, device=y.device)[:, None]
    out = torch.zeros((G * (T + 1), d), dtype=torch.float32, device=y.device)
    out.index_add_(0, rows.reshape(-1), w)
    return out.reshape(*lead, T + 1, d)[..., :T, :].to(dtype)


def capacity_for(cfg, T: int) -> int:
    k, E, cf = cfg.moe.experts_per_token, cfg.moe.num_experts, cfg.moe.capacity_factor
    return max(1, int(T * k * cf / E))


def moe_apply_grouped(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over G independent groups.  x: [G, T, d] -> ([G, T, d], aux [G]).
    Each group is dispatched with its own capacity ``capacity_for(cfg, T)``,
    as G calls of ``moe_apply_local`` would; the expert products run once
    over the G * C slots of every expert."""
    G, T, d = x.shape
    C = capacity_for(cfg, T)
    slot_tokens, slot_gates, aux = _dispatch(x, p["router"], cfg.moe.experts_per_token, C)
    x_pad = torch.cat([x, x.new_zeros((G, 1, d))], dim=1)  # [G, T + 1, d]
    xg = torch.gather(x_pad, 1, slot_tokens.reshape(G, -1, 1).expand(-1, -1, d))  # [G, E*C, d]
    E = slot_tokens.shape[1]
    xg = xg.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    y = _expert_ffn(xg, p["w_gate"], p["w_up"], p["w_down"])
    y = y.reshape(E, G, C, d).transpose(0, 1)  # [G, E, C, d]
    return _combine(slot_tokens, slot_gates, y, T, d, x.dtype), aux


def moe_apply_local(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE over one group of tokens.  x: [T, d] ->
    ([T, d], aux scalar)."""
    out, aux = moe_apply_grouped(p, x[None], cfg)
    return out[0], aux[0]


# ---------------------------------------------------------------------------
# sharded variants
# ---------------------------------------------------------------------------


def moe_apply_sharded(p, x, cfg, mesh, *, dp_axes: Tuple[str, ...] = ("data",),
                      tp_axis: str = "model", fsdp_axis: str = "data", strategy: str = "auto"):
    """Distributed MoE.  x: [T_global, d] DTensor; ``mesh`` a DeviceMesh.
    Returns (out [T_global, d], aux) as DTensors.

    strategy: "auto" -> EP when E % model == 0 else TP-MoE; "a2a" -> EP with
    explicit all-to-all dispatch (E % model == 0 only).

      - **EP**: experts sharded over 'model'; tokens data-sharded and
        replicated over 'model'; each model rank dispatches with its local
        T's capacity, keeps its expert slice (by its rank on 'model') and
        combines.  The reference ``psum``s the partial outputs over
        'model' in the body; here the body returns them as a
        ``Partial(sum)`` placement on 'model', which DTensor reduces where
        the next layout needs it (a reduce-scatter into the
        sequence-sharded residual instead of an all-reduce; the same sum).
      - **TP-MoE**: every rank computes all experts on its 1/model slice of
        d_ff; the down-projection partials are ``Partial(sum)`` likewise.
      - **a2a**: tokens enter split over (data x model); two all-to-alls
        over 'model' carry each rank's slots to the experts' owners and
        back.

    Expert weights enter the body still FSDP-sharded over ``fsdp_axis`` and
    are all-gathered inside it, one layer at a time (autograd
    all-gathers: their backward is a reduce-scatter).  The aux loss is the
    reference's mean over the data axes (for a2a over every axis), a
    ``Partial(sum)`` over every axis of each rank's aux divided by the rank
    count (the model ranks of ep/tp hold equal values; gloo has no average
    reduction), so its grad reaches the router once, not once per model
    rank.  An input replicated over an axis gets a partial grad there, as
    ``shard_map``'s transpose gives (``layers.grad_placements``).
    """
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    size = {a: mesh.size(names.index(a)) for a in names}
    M = size[tp_axis]
    E = cfg.moe.num_experts
    k = cfg.moe.experts_per_token
    if strategy == "auto":
        strategy = "ep" if E % M == 0 else "tp"
    if strategy in ("ep", "a2a") and E % M != 0:
        raise ValueError(f"EP requires E % model == 0 (E={E}, model={M})")
    if strategy not in ("ep", "tp", "a2a"):
        raise ValueError(f"unknown MoE strategy {strategy!r}")

    d = x.shape[-1]
    fs = fsdp_axis if size.get(fsdp_axis, 1) > 1 else None
    n_dp = math.prod(size[a] for a in dp_axes)
    me = mesh.get_local_rank(tp_axis)

    def gather(w, axis):
        if fs is None:
            return w
        return funcol.all_gather_tensor_autograd(w, axis, mesh.get_group(fs))

    def pl(*by_axis):
        """Placements from {axis: placement}; Replicate elsewhere."""
        want = dict(by_axis)
        return tuple(want.get(a, Replicate()) for a in names)

    rep = pl()
    n_all = n_dp * M
    w_ep = (pl((tp_axis, Shard(0)), *([(fs, Shard(1))] if fs else [])),) * 2
    wd_ep = pl((tp_axis, Shard(0)), *([(fs, Shard(2))] if fs else []))
    aux_all = pl(*[(a, Partial()) for a in names])
    x_dp = pl(*[(a, Shard(0)) for a in dp_axes])

    def expert_slots(x_loc, router):
        T = x_loc.shape[0]
        st, sg, aux = _dispatch(x_loc, router, k, capacity_for(cfg, T))
        x_pad = torch.cat([x_loc, x_loc.new_zeros((1, d))], dim=0)
        return T, st, sg, aux, x_pad

    if strategy == "ep":
        def body(x_loc, router, wg, wu, wd):
            wg, wu, wd = gather(wg, 1), gather(wu, 1), gather(wd, 2)
            T, st, sg, aux, x_pad = expert_slots(x_loc, router)
            e0 = me * (E // M)
            st, sg = st[e0 : e0 + E // M], sg[e0 : e0 + E // M]
            y = _expert_ffn(x_pad[st], wg, wu, wd)
            return _combine(st, sg, y, T, d, x_loc.dtype), aux / n_all

        in_pl = (x_dp, rep) + w_ep + (wd_ep,)
        out_pl = (pl(*[(a, Shard(0)) for a in dp_axes], (tp_axis, Partial())), aux_all)
    elif strategy == "tp":
        w_tp = pl((tp_axis, Shard(2)), *([(fs, Shard(1))] if fs else []))
        wd_tp = pl((tp_axis, Shard(1)), *([(fs, Shard(2))] if fs else []))

        def body(x_loc, router, wg, wu, wd):
            wg, wu, wd = gather(wg, 1), gather(wu, 1), gather(wd, 2)
            T, st, sg, aux, x_pad = expert_slots(x_loc, router)
            y = _expert_ffn(x_pad[st], wg, wu, wd)  # ff sliced -> partial d out
            return _combine(st, sg, y, T, d, x_loc.dtype), aux / n_all

        in_pl = (x_dp, rep, w_tp, w_tp, wd_tp)
        out_pl = (pl(*[(a, Shard(0)) for a in dp_axes], (tp_axis, Partial())), aux_all)
    else:  # "a2a": explicit all-to-all expert dispatch
        group = mesh.get_group(tp_axis)

        def a2a(t):
            return funcol.all_to_all_single_autograd(t.contiguous(), None, None, group)

        def body(x_my, router, wg, wu, wd):
            wg, wu, wd = gather(wg, 1), gather(wu, 1), gather(wd, 2)
            Tm, st, sg, aux, x_pad = expert_slots(x_my, router)
            C = st.shape[1]
            xr = a2a(x_pad[st].reshape(M, E // M, C, d))
            # xr[s]: tokens from source rank s destined for my local experts
            xr = xr.permute(1, 0, 2, 3).reshape(E // M, M * C, d)
            y = _expert_ffn(xr, wg, wu, wd)  # [E/M, M*C, d]
            y = y.reshape(E // M, M, C, d).permute(1, 0, 2, 3)
            yb = a2a(y)
            out_my = _combine(st, sg, yb.reshape(E, C, d), Tm, d, x_my.dtype)
            return out_my, aux / n_all

        in_pl = (pl(*[(a, Shard(0)) for a in dp_axes + (tp_axis,)]), rep) + w_ep + (wd_ep,)
        out_pl = (in_pl[0], aux_all)

    # every axis splits the work (tokens over the data axes; experts, d_ff
    # or tokens over 'model'): a replicated input's grad is partial there
    fn = local_map(body, out_placements=out_pl, in_placements=in_pl,
                   in_grad_placements=grad_placements(in_pl, [True] * len(names)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
