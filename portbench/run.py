"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration is
``portbench/configs/<config>.json``, its traffic ``portbench/traffic/
<traffic>.json`` (which names its driver, ``portbench/drivers/<driver>.py``),
and each per-layer metric a reader ``portbench/metrics/<metric>.py``.  The
run makes its inputs from the seed on the card, warms up the cell's own
shapes (set-up), runs the traffic closed-loop for ``--seconds`` (with
``--trace 1``: a shorter traced window under the profiler), checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output.  It needs an NVIDIA card, and refuses to
print a result when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The checkout's root (for ``portbench``) and ``src`` (for the port),
    and the caches of the program's compilers inside the checkout."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def cell(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == name:
            return {"spec": spec, "workload": w,
                    "config": json.loads((BENCH / "configs" / f"{w['config']}.json").read_text()),
                    "traffic": json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())}
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def for_cell(metrics: list, name: str) -> list:
    """The metrics a cell reports: those without a ``workloads`` list, and
    those whose list names the cell."""
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    c = cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["workload"]["chips"]:
        log(f"needs {c['workload']['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from portbench import harness
    driver = importlib.import_module(f"portbench.drivers.{c['traffic']['driver']}")
    res = driver.run(c["config"], c["traffic"], seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda", t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"refusing to report: modules of JAX or the JAX package are loaded: {found}")
        return 3
    line = harness.result_line(res, for_cell(c["spec"]["end_to_end"], args.workload),
                               for_cell(c["spec"]["per_layer"], args.workload),
                               trace=bool(args.trace), log=log)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
