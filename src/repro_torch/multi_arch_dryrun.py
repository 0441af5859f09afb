"""Example: dry-run one (arch x shape) pair on the production mesh and print
its roofline decomposition (port of ``examples/multi_arch_dryrun.py``): the
programmatic version of ``python -m repro_torch.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.multi_arch_dryrun --arch jamba-v0.1-52b \
        --shape decode_32k [--multi-pod]

It traces on the ``meta`` device, on the host: nothing is allocated and no
card is needed.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import dryrun


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    res = dryrun.run_combo(args.arch, args.shape, multi_pod=args.multi_pod)
    print(json.dumps(res, indent=2, default=str))
    return res


if __name__ == "__main__":
    main()
