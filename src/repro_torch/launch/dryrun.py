"""Dry run: trace every (arch x input shape x mesh) on the ``meta`` device
(port of ``repro.launch.dryrun``, which lowers and compiles with XLA).

Nothing is allocated: parameters, optimizer state, caches and inputs are
``meta`` tensors (``transformer.abstract_init``, ``configs.input_specs``),
and the step -- the train step of ``launch.train.build_setup``,
``transformer.prefill_step``, or ``transformer.serve_step`` on a ``meta``
cache -- runs under ``launch.op_cost.OpCost``, so only shapes flow.  It
runs on the host of any machine, card or none.

Per combination it gives the reference's result record:
  * memory: per-device argument, output, temp and peak bytes (arguments
    exact from the specs; temp from the trace's peak live bytes);
  * per-device FLOPs and HBM bytes (the traced totals over the chips);
  * the collective schedule (``roofline.collective_schedule``: the port's
    model, from the spec trees);
  * the three roofline terms on the H100's constants (``launch/roofline.py``).

The path reads no value: no ``.item()``, no ``nonzero``, no shape that
depends on data.  Decode traces ``serve_step`` at ``pos = seq - 1`` (its
work does not depend on the position).  The long per-step loops trace one
step, counted as many times (``kernels.cost.repeat``): the train step's
microbatches, the Mamba token scan, the RWKV chunk loop.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \
      [--json out.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Dict, Optional

import torch

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as RL
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_F32, Mesh, \
    make_production_mesh
from repro_torch.models import sharding, transformer as T
from repro_torch.models.sharding import P


# Microbatch counts keeping per-device activation checkpoints << HBM.
def default_microbatches(cfg, global_batch: int, data_total: int) -> int:
    """Gradient-accumulation depth: ~1 sample/device/microbatch for large
    models (activation checkpoints dominate), more for small ones."""
    b_local = max(1, global_batch // max(data_total, 1))
    target_local = 1 if cfg.params_count() > 20e9 else min(4, b_local)
    return max(1, b_local // target_local)


def _activation_bytes(mesh: Mesh, cfg, batch: int, seq: int) -> int:
    """Per-device bytes of one (batch, seq, d) activation, batch over the
    batch axes."""
    return sharding.Sharding(mesh, P(sharding.batch_axes(), None, None)).shard_bytes(
        (batch, seq, cfg.d_model), T.dtype_of(cfg))


def trace_combo(arch: str, shape: str, mesh: Mesh, *, kv_chunk: int = 1024,
                overrides: Optional[Dict] = None, microbatches: Optional[int] = None,
                reduced: bool = False, batch: Optional[int] = None,
                seq: Optional[int] = None):
    """Trace one (arch, shape, mesh) step on ``meta``; returns (op_cost
    totals, ``roofline.analyze``'s record, meta).  ``reduced`` takes the
    config's ``reduced()`` variant (the tests' size); ``batch`` and ``seq``
    replace the shape's (a run cut to one card, as ``chip_smoke.py``'s)."""
    cfg = configs.for_shape(configs.get(arch), shape)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    info = dict(configs.SHAPES[shape])
    info.update({k: v for k, v in (("batch", batch), ("seq", seq)) if v})
    sharding.set_mesh(mesh)
    model = T.build(cfg)
    batch = configs.input_specs(cfg, shape, batch=info["batch"], seq=info["seq"])
    kind = info["kind"]
    logits_spec = P(sharding.batch_axes(), None, "model")

    if kind == "train":
        data_total = mesh.size // mesh.shape["model"]
        mb = microbatches or default_microbatches(cfg, info["batch"], data_total)
        setup = train_lib.build_setup(cfg, microbatches=mb, kv_chunk=kv_chunk)
        key = torch.empty((2,), dtype=torch.int64, device="meta")
        b_specs = train_lib.batch_specs(cfg, batch)
        with op_cost.OpCost() as oc:
            _, params, opt_state = setup.step_fn(setup.params_sds, setup.opt_sds, batch, key)
        arguments = [(setup.params_sds, setup.param_specs), (setup.opt_sds, setup.opt_specs),
                     (batch, b_specs), (key, P())]
        outputs = [(params, setup.param_specs), (opt_state, setup.opt_specs)]
        coll = RL.collective_schedule(
            mesh, kind, setup.params_sds, setup.param_specs, microbatches=mb,
            activation_bytes=_activation_bytes(mesh, cfg, info["batch"] // mb, info["seq"]),
            mixer_outputs=2 * cfg.n_layers)
        meta = {"kind": "train", "microbatches": mb, "optimizer": setup.opt_name}
    elif kind == "prefill":
        params, specs = T.abstract_init(model)
        specs = T.fsdp_specs(params, specs)
        with op_cost.OpCost() as oc:
            logits = T.prefill_step(model, convert.params_view(model, params), batch,
                                    kv_chunk=kv_chunk)
        arguments = [(params, specs), (batch, train_lib.batch_specs(cfg, batch))]
        outputs = [(logits, logits_spec)]
        coll = RL.collective_schedule(
            mesh, kind, params, specs, mixer_outputs=2 * cfg.n_layers,
            activation_bytes=_activation_bytes(mesh, cfg, info["batch"], info["seq"]))
        meta = {"kind": "prefill"}
    else:  # decode: weights sharded over model only (no ZeRO gathers on the latency path)
        params, specs = T.abstract_init(model)
        b = info["batch"]
        cache = T.init_cache(model, b, info["seq"], "meta")
        c_specs = [T.cache_entry_spec(cfg, plan, batch=b) for plan in T.layer_plans(model)]
        tokens = batch["tokens"]
        with op_cost.OpCost() as oc:
            logits, cache = T.serve_step(model, convert.params_view(model, params), cache,
                                         tokens, info["seq"] - 1)
        arguments = [(params, specs), (cache, c_specs),
                     (tokens, P(sharding.batch_axes(), None)), (batch["pos"], P())]
        outputs = [(logits, logits_spec), (cache, c_specs)]
        coll = RL.collective_schedule(
            mesh, kind, params, specs, mixer_outputs=2 * cfg.n_layers,
            activation_bytes=_activation_bytes(mesh, cfg, b, 1))
        meta = {"kind": "decode"}

    oc.totals.coll_bytes, oc.totals.coll_count = coll.bytes_by_kind, coll.count_by_kind
    peak = PEAK_FLOPS_BF16 if cfg.dtype == "bfloat16" else PEAK_FLOPS_F32
    out = RL.analyze(oc.totals, mesh, arguments, outputs=outputs, collectives=coll,
                     peak_flops=peak)
    return oc.totals, out, meta


def run_combo(arch: str, shape: str, *, multi_pod: bool = False, mesh: Optional[Mesh] = None,
              kv_chunk: int = 1024, verbose: bool = True, overrides: Optional[Dict] = None,
              microbatches: Optional[int] = None, reduced: bool = False) -> Dict:
    """One combination's result record (the reference's keys; ``trace_s``
    for its ``compile_s``).  ``mesh`` defaults to the production mesh."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    head = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "mesh": list(mesh.sizes)}
    skip = configs.shape_supported(configs.get(arch), shape)
    if skip:
        return {**head, "status": "skip", "reason": skip}
    t0 = time.time()
    try:
        totals, out, meta = trace_combo(arch, shape, mesh, kv_chunk=kv_chunk,
                                        overrides=overrides, microbatches=microbatches,
                                        reduced=reduced)
    except Exception as e:  # a failure here is a port bug
        if verbose:
            traceback.print_exc()
        return {**head, "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
    finally:
        sharding.set_mesh(None)
    rl = out["roofline"]
    res = {
        **head, "status": "ok", "trace_s": round(time.time() - t0, 1),
        **meta,
        "roofline": rl.row(),
        "collectives": {"bytes": out["collectives"].bytes_by_kind,
                        "count": out["collectives"].count_by_kind},
        "memory": out["memory"],
        "model_flops_6nd": model_flops(arch, shape),
    }
    if verbose:
        mem = out["memory"]
        print(f"[{arch} x {shape} x {'x'.join(map(str, mesh.sizes))}] "
              f"trace {res['trace_s']}s  "
              f"args/dev {fmt_b(mem['argument_bytes'])}  "
              f"temp/dev {fmt_b(mem['temp_bytes'])}  "
              f"flops/dev {rl.flops:.3e}  dominant={rl.dominant}", flush=True)
    return res


def model_flops(arch: str, shape: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens/step."""
    cfg = configs.get(arch)
    info = configs.SHAPES[shape]
    n = cfg.active_params_count()
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n * tokens
    if info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        return 2.0 * n * tokens
    return 2.0 * n * info["batch"]  # decode: one token per sequence


def fmt_b(x: Optional[float]) -> str:
    if x is None:
        return "?"
    for u in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024:
            return f"{x:.1f}{u}"
        x /= 1024
    return f"{x:.1f}PB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(configs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = list(configs.ALIASES) if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.time()
    results = [run_combo(a, s, multi_pod=mp, kv_chunk=args.kv_chunk)
               for mp in meshes for a in archs for s in shapes]

    n_fail = sum(r["status"] == "FAIL" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_fail} FAILED "
          f"in {time.time() - t0:.1f} s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
