"""Mixture-of-Experts FFN (port of ``repro.models.moe``).

GShard-style capacity dispatch, as the reference computes it:

* tokens are processed in groups of up to ``group`` tokens (the last one
  padded with zero rows); each token picks its ``top_k`` experts from a
  float32 softmax over the router logits, and its gates are renormalised;
* each (token, slot) takes the next place in its expert's queue, in the
  order of the group's tokens and, within a token, its slots; places at or
  beyond the capacity ``C`` are dropped;
* dispatch and combine are einsums against one-hot (n, G, E, C) tensors.

The reference's ``sharding.constraint`` hints do no arithmetic and have no
counterpart: the port runs on one card.  The dense one-hot dispatch is the
reference's design, kept as it is; the expert products are ``torch.einsum``
(TF32 off, ``repro_torch/__init__.py``).

``route`` is the routing alone (probabilities, gates, choices, the capacity
decision), so that it can be held to the reference on its own.  Its discrete
outputs match the reference's exactly where the probabilities do: the top-k
keeps the lower expert first among equal probabilities, as ``lax.top_k``
does (``torch.topk`` does not), and a dropped place past the capacity gives
an all-zero row in the capacity one-hot, as ``jax.nn.one_hot`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import sharding
from .config import ArchConfig
from .layers import dtype_of, normal
from .sharding import P


def _expert_ff_axis(cfg: ArchConfig) -> Tuple:
    """(expert_axis_spec, ff_axis_spec) for (E, d, ff) expert weights:
    experts over ``model`` and the FFN hidden dim over ``data`` where each
    divides (a 1T-parameter MoE fits only with this 2-D sharding)."""
    e = cfg.n_experts
    model = sharding.axis_size("model")
    data = sharding.axis_size("data")
    ff = cfg.moe_d_ff or cfg.d_ff
    e_ax = "model" if (model > 1 and e % model == 0) else None
    ff_ax = "data" if (data > 1 and ff % data == 0) else None
    return e_ax, ff_ax


def init_moe(gen: torch.Generator, cfg: ArchConfig):
    """The reference's names and layouts: ``router`` (d, E) in float32 in
    every model dtype, ``w_gate``/``w_up`` (E, d, ff), ``w_down`` (E, ff, d),
    and ``sh_*`` for the shared experts.  The expert tensors are drawn one
    expert at a time, so that no float32 copy of a whole tensor is made
    (Kimi K2's (384, 7168, 2048) would take 22.5 GB)."""
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    dt = dtype_of(cfg)

    def experts(shape, std):
        out = torch.empty((e, *shape), dtype=dt, device=gen.device)
        if gen.device.type == "meta":
            return out
        for i in range(e):
            out[i] = normal(gen, shape, std, dt)
        return out

    params = {
        "router": normal(gen, (d, e), d ** -0.5, torch.float32),
        "w_gate": experts((d, ff), d ** -0.5),
        "w_up": experts((d, ff), d ** -0.5),
        "w_down": experts((ff, d), ff ** -0.5),
    }
    if cfg.shared_experts:
        se_ff = ff * cfg.shared_experts
        params.update({
            "sh_gate": normal(gen, (d, se_ff), d ** -0.5, dt),
            "sh_up": normal(gen, (d, se_ff), d ** -0.5, dt),
            "sh_down": normal(gen, (se_ff, d), se_ff ** -0.5, dt),
        })
    return params


def moe_specs(cfg: ArchConfig):
    """``init_moe``'s specs (on the active mesh: ``_expert_ff_axis``)."""
    e_ax, ff_ax = _expert_ff_axis(cfg)
    specs = {"router": P(None, None), "w_gate": P(e_ax, None, ff_ax),
             "w_up": P(e_ax, None, ff_ax), "w_down": P(e_ax, ff_ax, None)}
    if cfg.shared_experts:
        specs.update({"sh_gate": P(None, "model"), "sh_up": P(None, "model"),
                      "sh_down": P("model", None)})
    return specs


# Below this group size every token gets a guaranteed place (capacity ==
# group): no token is dropped.  Decode (groups of B tokens) is therefore
# always dropless, and a teacher-forced pass agrees with decode only while
# it stays within one dropless group (B * S <= 256); larger groups keep
# GShard capacity, as in the reference.
DROPLESS_MAX_GROUP = 256


def _capacity(cfg: ArchConfig, group: int) -> int:
    if group <= DROPLESS_MAX_GROUP:
        return group
    c = int(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return max(c, cfg.top_k)


class Routing(NamedTuple):
    probs: torch.Tensor       # (n, G, E) float32 router softmax
    gate_vals: torch.Tensor   # (n, G, k) float32, renormalised over the k slots
    gate_idx: torch.Tensor    # (n, G, k) int64 experts, largest probability first
    keep: torch.Tensor        # (n, G, k) bool: the place is below the capacity
    pos: torch.Tensor         # (n, G, k) int64 place in the expert's queue
    capacity: int


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, largest first, the lower index first
    among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ArchConfig, router: torch.Tensor, xg: torch.Tensor) -> Routing:
    """Routing of grouped tokens ``xg`` (n, G, d) with ``router`` (d, E)."""
    n, g, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = xg.to(torch.float32) @ router                          # (n, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    c = _capacity(cfg, g)
    # a compare with arange(E), not F.one_hot, which reads the largest
    # index back to the host to check it (``.item()``: a sync on the card,
    # an error on ``meta``)
    onehot = (gate_idx[..., None] == torch.arange(e, device=xg.device)).to(torch.float32)
    # Place of each (token, slot) in its expert's queue: a float32 cumsum
    # over the (token, slot) axis flattened token-major, exact up to 2^24.
    pos = torch.cumsum(onehot.reshape(n, g * k, e), dim=1).reshape(n, g, k, e) - 1.0
    keep = ((pos < c) & (onehot > 0)).any(-1)
    pos = (pos * onehot).sum(-1).to(torch.int64)
    return Routing(probs, gate_vals, gate_idx, keep, pos, c)


def moe_ffn(cfg: ArchConfig, params, x: torch.Tensor, *, group: int = 1024):
    """MoE FFN.  x: (B, S, d) -> (y, aux_loss).

    Tokens are reshaped into (n_groups, G, d); dispatch runs per group.
    """
    b, s, d = x.shape
    e = cfg.n_experts
    n_tok = b * s
    g = min(group, n_tok)
    n_groups = -(-n_tok // g)
    xt = x.reshape(n_tok, d)
    pad = n_groups * g - n_tok
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(n_groups, g, d)

    r = route(cfg, params["router"], xg)
    dt = x.dtype
    experts = torch.arange(e, device=x.device)
    kept = ((r.gate_idx[..., None] == experts) & r.keep[..., None]).to(dt)   # (n, G, k, E)
    # jax.nn.one_hot of a place >= C is a zero row: compare with arange(C).
    cap_onehot = (r.pos[..., None] == torch.arange(r.capacity, device=x.device)).to(dt)
    dispatch = torch.einsum("ngke,ngkc->ngec", kept, cap_onehot)              # (n, G, E, C)
    combine = torch.einsum("ngk,ngke,ngkc->ngec", r.gate_vals.to(dt), kept, cap_onehot)

    xe = torch.einsum("ngec,ngd->necd", dispatch, xg)                          # (n, E, C, d)
    hidden = F.silu(torch.einsum("necd,edf->necf", xe, params["w_gate"])) \
        * torch.einsum("necd,edf->necf", xe, params["w_up"])
    ye = torch.einsum("necf,efd->necd", hidden, params["w_down"])
    y = torch.einsum("ngec,necd->ngd", combine, ye)                            # (n, G, d)
    y = y.reshape(n_groups * g, d)[:n_tok].reshape(b, s, d)

    if cfg.shared_experts:
        sh = F.silu(x @ params["sh_gate"]) * (x @ params["sh_up"])
        y = y + sh @ params["sh_down"]

    # Load-balance aux loss (Switch/GShard): the top-1 fraction and the mean
    # probability per expert over every row, the padding rows included.
    frac_tokens = (r.gate_idx[..., 0, None] == experts).to(torch.float32).mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y, aux
