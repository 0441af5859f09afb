"""Plain reference of the first training steps of a Qwen3 decoder (dense
GQA attention with q/k RMSNorm and RoPE, SwiGLU MLP, untied output head,
next-token cross-entropy), with Adam and optionally the paper's stochastic
sign on each gradient leaf.

Plain PyTorch, imports nothing of the program.  It takes the benchmark's
inputs (the weights drawn from the seed, the token batches) and works out
everything else again.  The step follows the configuration as it is run:
the microbatches' gradients added onto float32 zeros and divided by their
count; Adam's arithmetic in the parameters' type, so bf16 weights turn
float32 after the first update; the sign Q_s(g) = K (2 Bernoulli(sigmoid(g
/ K)) - 1), K = mean |g|, its uniforms drawn from the frozen threefry copy
with one key per leaf (``split`` of the step key, leaves in sorted order).
Attention is computed whole in float32, causal, query head h reading
key/value head h // (H / H_kv).

``low=True`` is the control: each step computed in the nearest precision
below the one it runs in, fp8 (e4m3, each operand scaled by its amax) for
the matrix products of a bf16 step and TF32 for those of a float32 step.
``half_batch=True`` drops half of each microbatch's rows, a planted fault.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.yardstick import threefry as tf
from portbench.yardstick.lm_params import leaves

EPS_NORM = 1e-6
FP8_MAX = 448.0
SIGN_RANGE = 1 << 24


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under its amax scale; the gradient passes
    straight through the rounding (a cast to fp8 has none)."""
    scale = FP8_MAX / t.detach().abs().amax().float().clamp_min(1e-30)
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    return t + (q - t.detach())


def _mm(a, b, low):
    if low and a.dtype == torch.bfloat16:
        return _fp8(a) @ _fp8(b)
    return a @ b


def rmsnorm(x, w):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS_NORM)
    return (out * (1.0 + w.float())).to(x.dtype)


def rope(x, theta):
    dh, s = x.shape[-1], x.shape[1]
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device),
                          torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def attend(q, k, v, low):
    """Causal GQA attention in float32: q (B, S, H, Dh), k/v (B, S, Hk, Dh)."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    qf = q.float().transpose(1, 2) * dh ** -0.5
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    scores = _mm(qf, kf.transpose(-1, -2), low)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return _mm(p, vf, low).transpose(1, 2).to(q.dtype)


def loss_fn(c: Dict, P: Dict, tokens, labels, low: bool):
    h, hk, dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    L = {k.rsplit("/", 1)[-1]: v.unbind(0) for k, v in leaves(P["pattern"][0])}
    x = P["embed"][tokens]
    b, s, _ = x.shape
    for i in range(c["num_hidden_layers"]):
        y = rmsnorm(x, L["ln1"][i])
        q = rmsnorm(_mm(y, L["wq"][i], low).reshape(b, s, h, dh), L["q_norm"][i])
        k = rmsnorm(_mm(y, L["wk"][i], low).reshape(b, s, hk, dh), L["k_norm"][i])
        v = _mm(y, L["wv"][i], low).reshape(b, s, hk, dh)
        q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
        x = x + _mm(attend(q, k, v, low).reshape(b, s, h * dh), L["wo"][i], low)
        y = rmsnorm(x, L["ln2"][i])
        x = x + _mm(F.silu(_mm(y, L["w_gate"][i], low)) * _mm(y, L["w_up"][i], low),
                    L["w_down"][i], low)
    lf = _mm(rmsnorm(x, P["final_norm"]), P["head"], low).float()
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(lf, dim=-1) - gold).mean()


def _sign(g: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    kt = g.abs().mean() + 1e-12
    q = torch.sigmoid(g / kt).reshape(-1)
    bit = torch.empty(q.shape, dtype=torch.bool, device=g.device)
    for lo in range(0, q.numel(), SIGN_RANGE):
        hi = min(lo + SIGN_RANGE, q.numel())
        at = torch.arange(lo, hi, dtype=torch.int64, device=g.device)
        bit[lo:hi] = tf.uniform_at(key, at) < q[lo:hi]
    return (2.0 * bit.reshape(g.shape).to(g.dtype) - 1.0) * kt


def _unflatten(tree, vals):
    it = iter(vals)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(t) for t in node]
        return next(it)

    return build(tree)


def norms(ts) -> List[float]:
    return [float(torch.linalg.vector_norm(t, dtype=torch.float64)) for t in ts]


def run_steps(c: Dict, params: Dict, batches: List[Dict], traffic: Dict, seed: int, *,
              low: bool = False, half_batch: bool = False) -> Dict:
    """The reference's first ``len(batches)`` steps from ``params``: each
    step's loss, the norm of every leaf of the first step's gradient as
    Adam gets it, and the norm of every leaf's change over the steps."""
    lr, mb = traffic["lr"], traffic["microbatches"]
    sign = traffic.get("grad_compression") == "stochastic_sign"
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = [n for n, _ in leaves(params)]
    p = [t for _, t in leaves(params)]
    p0 = [t.detach().clone() for t in p]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    key = tf.fold_in(tf.key(seed, p[0].device), 1)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    out = {"names": names, "losses": [], "grad_norms": None}
    try:
        for step, batch in enumerate(batches, start=1):
            ks = tf.split(key)
            key, skey = ks[0], ks[1]
            torch.backends.cuda.matmul.allow_tf32 = low and p[0].dtype == torch.float32
            toks = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=p[0].device)
            labs = torch.as_tensor(batch["labels"], dtype=torch.int64, device=p[0].device)
            rows = toks.shape[0] // mb
            keep = rows // 2 if half_batch else rows
            grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in p]
            loss_sum = 0.0
            for i in range(mb):
                sl = slice(i * rows, i * rows + keep)
                leaf = [t.detach().requires_grad_() for t in p]
                loss = loss_fn(c, _unflatten(params, leaf), toks[sl], labs[sl], low)
                for acc, g in zip(grads, torch.autograd.grad(loss, leaf)):
                    acc.add_(g)
                loss_sum += float(loss.detach())
                del loss, leaf
            for g in grads:
                g.div_(mb)
            if sign:
                keys = tf.split(skey, len(grads))
                for i in range(len(grads)):
                    grads[i] = _sign(grads[i], keys[i])
            out["losses"].append(loss_sum / mb)
            if step == 1:
                out["grad_norms"] = norms(grads)
            with torch.no_grad():
                t = torch.full((), float(step), dtype=torch.float32, device=p[0].device)
                bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=t.device) ** t
                bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=t.device) ** t
                for i, g in enumerate(grads):   # leaf by leaf: one leaf's temporaries
                    mu[i] = b1 * mu[i] + (1 - b1) * g
                    nu[i] = b2 * nu[i] + (1 - b2) * g * g
                    p[i] = p[i] - lr * (mu[i] / bc1) / (
                        torch.sqrt((nu[i] / bc2).double()).float() + eps)
            del grads
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    out["change_norms"] = norms(a - b.float() for a, b in zip(p, p0))
    return out


def compare(prog: Dict, ref: Dict, rel_floor: float = 1e-3) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, and by the
    worst leaf the gap between the program's and the reference's norms of
    the first gradient and of the change, each over the reference's norm of
    that leaf or of the median leaf, whichever is larger.  Leaves whose
    reference gradient is under ``rel_floor`` of the median leaf's move by
    round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gr = ref["grad_norms"]
    med_g = sorted(gr)[len(gr) // 2]
    grad = max(abs(a - b) / max(b, med_g) for a, b in zip(prog["grad_norms"], gr))
    kept = [i for i, v in enumerate(gr) if v >= rel_floor * med_g]
    dr = [ref["change_norms"][i] for i in kept]
    med_d = sorted(dr)[len(dr) // 2]
    change = max(abs(prog["change_norms"][i] - ref["change_norms"][i])
                 / max(ref["change_norms"][i], med_d) for i in kept)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def nonfinite(x: float) -> bool:
    return not math.isfinite(x)
