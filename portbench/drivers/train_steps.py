"""Training steps back to back through ``launch.train.Trainer.step``.

Set-up draws the weights on the device from the seed (bf16, as the
configuration trains), builds one ``Trainer`` over them and drives it
through its first three steps on batches of the frozen token stream: the
bf16 first step and two float32 steps (the first Adam update turns the
weights float32), which builds the kernels and warms every shape the
window runs.  It keeps each step's loss, the norm of every leaf of the
first gradient as Adam got it (its first moment over 1 - beta1) and the
norm of every leaf's change over the three steps.  The window then runs
steps on the stream's next batches until ``--seconds`` have passed; the
same ``Trainer`` object throughout.  Once the window has closed and the
trainer is freed, the plain reference runs the same three steps from the
same weights and batches, and the two are compared.
"""
from __future__ import annotations

import gc
import time

import torch

from portbench.harness import Result, closed_loop
from portbench.reference import qwen3_train
from portbench.yardstick import lm_params, peaks
from portbench.yardstick.lm_stream import TokenStream
from portbench.yardstick.trace import trace_window

CHECKED_STEPS = 3
ADAM_B1 = 0.9


def arch(c):
    """The program's configuration object over the configuration file's sizes."""
    from repro_torch.models.config import ArchConfig
    return ArchConfig(name=c["name"], arch_type="dense", n_layers=c["num_hidden_layers"],
                      d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
                      n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
                      vocab=c["vocab_size"], head_dim=c["head_dim"], qk_norm=True,
                      rope_theta=float(c["rope_theta"]), dtype=c["torch_dtype"], remat=True)


def step_flops(c, traffic) -> float:
    """Model FLOPs of one step: 6 x the matmul parameters (the output head
    included, the embedding gather not) x tokens, plus forward and backward
    of attention over the visible causal pairs (3 x 4 H Dh pairs) in every
    layer and sequence.  Remat's recompute is not counted."""
    d, h, hk, dh, ff, v, n = (c["hidden_size"], c["num_attention_heads"],
                              c["num_key_value_heads"], c["head_dim"],
                              c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"])
    mm = n * (2 * d * h * dh + 2 * d * hk * dh + 3 * d * ff) + d * v
    b, s = traffic["batch"], traffic["seq"]
    attn = 3 * 4 * h * dh * peaks.visible_pairs(s, s, True) * n * b
    return 6 * mm * b * s + attn


def run(cfg, traffic, *, seed, seconds, trace, device, t_start, log) -> Result:
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer

    log(f"set-up: driver started at {time.perf_counter() - t_start:.3f} s")
    on_card = torch.device(device).type == "cuda"
    b, s = traffic["batch"], traffic["seq"]
    stream = TokenStream(cfg["vocab_size"], seed).stream(b, s)
    trainer = Trainer(arch(cfg), lr=traffic["lr"], microbatches=traffic["microbatches"],
                      kv_chunk=s, grad_compression=traffic.get("grad_compression"), seed=seed,
                      params=lm_params.draw(cfg, seed, device), device=device)
    log(f"set-up: weights drawn and trainer built at {time.perf_counter() - t_start:.3f} s")
    batches, prog = [], {"losses": []}
    for step in range(1, CHECKED_STEPS + 1):
        batches.append(next(stream))
        prog["losses"].append(trainer.step(batches[-1]))
        log(f"set-up: step {step} done at {time.perf_counter() - t_start:.3f} s")
        if step == 1:       # Adam's first moment is (1 - beta1) g
            prog["grad_norms"] = [x / (1 - ADAM_B1) for x in qwen3_train.norms(
                t for _, t in lm_params.leaves(trainer.opt_state.mu))]
    p0 = lm_params.leaves(lm_params.draw(cfg, seed, device))
    prog["change_norms"] = qwen3_train.norms(
        a - w.float() for (_, a), (_, w) in zip(lm_params.leaves(trainer.params), p0))
    del p0
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    losses, res_trace, ctx = [], None, {}

    def one():
        losses.append(trainer.step(next(stream)))

    if trace:
        n_steps = traffic["traced_steps"]
        counted = {}

        def traced():
            counted["flash"] = -ops.flash_attention.launches
            for _ in range(n_steps):
                one()
            counted["flash"] += ops.flash_attention.launches

        res_trace = trace_window(traced, lambda tr: tr.count(peaks.is_flash_fwd)
                                 >= counted["flash"], log=log)
        fl, nb = peaks.attention_work(b // traffic["microbatches"], s, s,
                                      cfg["num_attention_heads"],
                                      cfg["num_key_value_heads"], cfg["head_dim"], True,
                                      trainer.params["head"].element_size())
        ctx = {"steps": n_steps, "train_flops": n_steps * step_flops(cfg, traffic),
               "flash_bound_s": peaks.bound_seconds(fl, nb)}
        attempted, e2e = n_steps, {}
    else:
        calls, elapsed = closed_loop(seconds, one, time.perf_counter)
        attempted = calls
        e2e = {"train_tokens_per_s": calls * b * s / elapsed, "setup_s": setup_s}
    failed = sum(1 for x in losses if qwen3_train.nonfinite(x))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = qwen3_train.run_steps(cfg, lm_params.draw(cfg, seed, device), batches, traffic, seed)
    gaps = qwen3_train.compare(prog, ref)
    log(f"losses: program {prog['losses']}, reference {ref['losses']}")
    lim = traffic["limits"]
    checks = [(k, gaps[k], lim[k]) for k in ("loss_gap", "grad_gap", "change_gap")]
    return Result(attempted=attempted, failed=failed, e2e=e2e, checks=checks,
                  memory_peak_bytes=peak, trace=res_trace, ctx=ctx)
