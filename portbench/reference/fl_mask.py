"""Plain reference of a BiCompFL-GR job over fixed blocks (paper Alg. 1):
every client trains a Bernoulli mask over the frozen signed-constant MLP by
score-space Adam with the straight-through estimator, conveys one sample of
its posterior by Minimal Random Coding against the global prior on the
round's common candidates, and the federator relays the indices, so every
client holds the mean of the conveyed samples.

Plain PyTorch on the inputs the benchmark made; it imports nothing of the
program.  Randomness comes from the frozen threefry copy, keyed as the
paper's shared randomness is (round key ``fold_in(seed key, t)``; training
keys from tag 1, selection keys from tag 2, candidate key ``fold_in(kt,
0)``, block ``j`` keyed by ``fold_in(key, j)``).  A block's importance
log-weight ``sum_s x_s a_s + sum_s b_s`` is summed in one fixed float32
order (chunks of four elements per lane of a group of lanes, the lanes'
sums added by an xor butterfly), so that a comparison can be exact.

``tf32=True`` runs local training's matrix products in TF32: the control,
the nearest precision below the float32 the configuration states.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.yardstick import threefry as tf

EPS = 1e-6
TAG_TRAIN, TAG_UL_SELECT = 1, 2


def clip01(x):
    return torch.clamp(x, EPS, 1.0 - EPS)


def log_ratio(q, p):
    """(a, b): log Q(x)/P(x) = sum_e x_e a_e + b_e for Bernoulli q, p."""
    q, p = clip01(q), clip01(p)
    llr1 = torch.log(q) - torch.log(p)
    llr0 = torch.log1p(-q) - torch.log1p(-p)
    return llr1 - llr0, llr0


def _sqrt(x):
    return torch.sqrt(x.double()).to(torch.float32)


def mean_rows(x):
    """Mean over axis 0: rows added in order, times the float32 1/n."""
    total = x[0]
    for row in x[1:]:
        total = total + row
    return total * torch.full((), 1.0 / x.shape[0], dtype=x.dtype, device=x.device)


def unravel(v, dims):
    """``(..., d)`` -> the ``(..., d_in, d_out)`` matrices, row-major."""
    out, at = [], 0
    for a, b in zip(dims[:-1], dims[1:]):
        out.append(v[..., at:at + a * b].reshape(*v.shape[:-1], a, b))
        at += a * b
    return out


def mlp(x, weights):
    nb = weights[0].dim() - 2
    h = x.reshape(*x.shape[:nb + 1], -1)
    for w in weights[:-1]:
        h = F.relu(torch.matmul(h, w))
    return torch.matmul(h, weights[-1])


def local_train(theta_hat, xs, ys, keys, w0, dims, *, epochs, batch, lr):
    """Every client's posterior q after ``epochs`` epochs of Adam on its
    scores s = logit(theta_hat): (n, d)."""
    n, shard = ys.shape
    bs = min(batch, shard)
    n_steps = epochs * max(shard // bs, 1)
    kb_km = tf.split(keys, 2)
    batch_idx = tf.randint(kb_km[:, 0], (n_steps, bs), 0, shard)
    mks = tf.split(kb_km[:, 1], n_steps)
    rows = torch.arange(n, device=xs.device)[:, None]
    th = clip01(theta_hat)
    s = torch.log(th) - torch.log1p(-th)
    mu, nu = torch.zeros_like(s), torch.zeros_like(s)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for k in range(n_steps):
        idx = batch_idx[:, k]
        xb, yb = xs[rows, idx], ys[rows, idx]
        sg = s.detach().requires_grad_(True)
        prob = torch.sigmoid(sg)
        m = (tf.uniform(mks[:, k], (s.shape[-1],)) < prob.detach()).to(torch.float32)
        m_ste = m + prob - prob.detach()
        logp = F.log_softmax(mlp(xb, unravel(w0 * m_ste, dims)), dim=-1)
        loss = -torch.take_along_dim(logp, yb[..., None], dim=-1)[..., 0].mean(dim=-1)
        (g,) = torch.autograd.grad(loss.sum(), sg)
        with torch.no_grad():
            step = k + 1
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            t = torch.full((), float(step), dtype=torch.float32, device=s.device)
            bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=s.device) ** t
            bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=s.device) ** t
            s = s - lr * (mu / bc1) / (_sqrt(nu / bc2) + eps)
    return clip01(torch.sigmoid(s))


def lane_order_sum(v):
    """Sum over the last axis (S) in the fixed order: chunks of four, lane
    ``l`` of a group of G lanes (G = ceil(S/4) up to a power of two, at
    most 32) adds chunks l, l + G, ... element by element from 0, then the
    lanes are added by an xor butterfly."""
    s = v.shape[-1]
    nq = -(-s // 4)
    g = 1
    while g < nq and g < 32:
        g *= 2
    rounds = -(-nq // g)
    v = F.pad(v, (0, rounds * g * 4 - s)).reshape(*v.shape[:-1], rounds, g, 4)
    acc = torch.zeros(v.shape[:-3] + (g,), dtype=v.dtype, device=v.device)
    for r in range(rounds):
        for e in range(4):
            acc = acc + v[..., r, :, e]
    lanes = torch.arange(g, device=v.device)
    off = g // 2
    while off:
        acc = acc + acc[..., lanes ^ off]
        off //= 2
    return acc[..., 0]


def mrc_encode(kt, q, p, ids, *, block, n_is):
    """One MRC sample of every client's q against prior p on the round's
    common candidates: (indices (n, B), samples (n, d))."""
    n, d = q.shape
    nb = -(-d // block)

    def blocks(v):
        pad = nb * block - d
        if pad:
            v = torch.cat([v, v.new_full((n, pad), 0.5)], dim=-1)
        return v.reshape(n, nb, block)

    qb, pb = blocks(clip01(q)), blocks(clip01(p))
    a, b = log_ratio(qb, pb)
    jj = torch.arange(nb, dtype=torch.int64, device=q.device)
    cand_key = tf.fold_in(tf.fold_in(kt, 0)[None], jj)                    # (B, 2)
    u = tf.uniform(cand_key, (n_is, block))                               # (B, n_is, S)
    x = (u[None] < pb[:, :, None, :]).to(torch.float32)                   # (n, B, n_is, S)
    logw = lane_order_sum(x * a[:, :, None, :]) + lane_order_sum(b)[..., None]
    sel = tf.fold_in(tf.fold_in(tf.fold_in(kt, TAG_UL_SELECT), ids), 0)   # (n, 2)
    gu = tf.uniform(tf.fold_in(sel[:, None, :], jj), (n_is,))             # (n, B, n_is)
    gumbel = -torch.log(-torch.log(torch.clamp(gu, 1e-12, 1.0 - 1e-12)))
    idx = torch.argmax(logw + gumbel, dim=-1)
    chosen = torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]
    return idx, chosen.reshape(n, nb * block)[:, :d]


def accuracy(w0, theta, dims, x, y):
    with torch.no_grad():
        pred = torch.argmax(mlp(x, unravel(w0 * theta, dims)), dim=-1)
        correct = (pred == y).to(torch.float32).sum()
    return correct * torch.full((), 1.0 / x.shape[0], dtype=torch.float32, device=x.device)


def run_job(inputs: Dict, seed: int, cfg: Dict, traffic: Dict, *, tf32: bool = False) -> Dict:
    """One job of ``traffic["rounds"]`` rounds from the job seed: the final
    model, the booked bits and the accuracy at each eval round."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _run_job(inputs, seed, cfg, traffic)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run_job(inputs, seed, cfg, traffic):
    if traffic["variant"] != "GR" or traffic["allocation"] != "fixed":
        raise ValueError("the plain reference runs BiCompFL-GR over fixed blocks only")
    xs, ys, w0, dims = inputs["x"], inputs["y"], inputs["w0"], inputs["dims"]
    n, d = ys.shape[0], w0.shape[0]
    dev = w0.device
    rounds, every = traffic["rounds"], traffic["eval_every"]
    block, n_is = traffic["block_size"], traffic["n_is"]
    base = tf.key(seed, dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    theta = torch.full((d,), 0.5, dtype=torch.float32, device=dev)
    theta_hat = theta[None].repeat(n, 1)
    accs = {}
    for t in range(rounds):
        kt = tf.fold_in(base, t)
        keys = tf.split(tf.fold_in(kt, TAG_TRAIN), n)
        q = local_train(theta_hat, xs, ys, keys, w0, dims, epochs=cfg["local_epochs"],
                        batch=cfg["batch_size"], lr=cfg["lr"])
        _, samples = mrc_encode(kt, q, theta_hat, ids, block=block, n_is=n_is)
        theta = mean_rows(samples)
        theta_hat = theta[None].repeat(n, 1)
        if (t + 1) % every == 0 or t == rounds - 1:
            accs[t + 1] = float(accuracy(w0, theta, dims, inputs["x_test"], inputs["y_test"]))
    n_blocks = -(-d // block)
    per_round = (n + n * (n - 1)) * n_blocks * math.log2(n_is)
    return {"theta": theta.cpu(), "total_bits": rounds * per_round, "accs": accs}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """One job's numbers: entries of the final model that differ, the gap in
    booked bits, and the widest gap in accuracy over the eval rounds (an
    eval round missing on either side reads infinite)."""
    acc = float("inf") if set(prog["accs"]) != set(ref["accs"]) else max(
        [0.0, *(abs(prog["accs"][r] - a) for r, a in ref["accs"].items())])
    return {"theta_entries_differing": float((prog["theta"] != ref["theta"]).sum()),
            "bits_gap": abs(prog["total_bits"] - ref["total_bits"]), "acc_gap": acc}
