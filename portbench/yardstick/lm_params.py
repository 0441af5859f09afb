"""The decoder's weights, drawn on the device from the run's seed in the
type they are trained in, and the tree they are handed over in.

One ``torch.Generator`` on the device draws every matrix in one call of
standard normals; each matrix is then scaled by ``fan_in ** -0.5`` (the
output projection of attention by ``d_model ** -0.5``).  The norm scales
are zeros: the model's RMSNorm multiplies by ``1 + scale``.  The tree is
``{embed, prefix: [], pattern: [layer], final_norm, head}`` with each layer
leaf stacked over the layers; ``leaves`` walks it with dict keys sorted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def matrix_shapes(c: Dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every matrix, in draw order."""
    d, h, hk, dh, ff, v, n = (c["hidden_size"], c["num_attention_heads"],
                              c["num_key_value_heads"], c["head_dim"],
                              c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"])
    return [("embed", (v, d), d ** -0.5),
            ("mixer/wq", (n, d, h * dh), d ** -0.5),
            ("mixer/wk", (n, d, hk * dh), d ** -0.5),
            ("mixer/wv", (n, d, hk * dh), d ** -0.5),
            ("mixer/wo", (n, h * dh, d), d ** -0.5),
            ("ffn/w_gate", (n, d, ff), d ** -0.5),
            ("ffn/w_up", (n, d, ff), d ** -0.5),
            ("ffn/w_down", (n, ff, d), ff ** -0.5),
            ("head", (d, v), d ** -0.5)]


def draw(c: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The stacked parameter tree of configuration ``c`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = matrix_shapes(c)
    sizes = [torch.Size(s).numel() for _, s, _ in shapes]
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    mats, at = {}, 0
    for (path, shape, std), size in zip(shapes, sizes):
        mats[path] = buf[at:at + size].view(shape).mul_(std)
        at += size
    n, d, dh = c["num_hidden_layers"], c["hidden_size"], c["head_dim"]

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layer = {"ln1": zeros(n, d), "ln2": zeros(n, d),
             "mixer": {"wq": mats["mixer/wq"], "wk": mats["mixer/wk"],
                       "wv": mats["mixer/wv"], "wo": mats["mixer/wo"],
                       "q_norm": zeros(n, dh), "k_norm": zeros(n, dh)},
             "ffn": {"w_gate": mats["ffn/w_gate"], "w_up": mats["ffn/w_up"],
                     "w_down": mats["ffn/w_down"]}}
    return {"embed": mats["embed"], "prefix": [], "pattern": [layer],
            "final_norm": zeros(d), "head": mats["head"]}


def leaves(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in leaves(t, f"{path}/{i}")]
    return [(path, tree)]
