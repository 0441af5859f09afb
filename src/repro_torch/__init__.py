"""PyTorch/CUDA port of the BiCompFL reproduction (``repro`` is the JAX reference).

The layout mirrors ``repro`` (``core/``, ``fl/``, ``kernels/``, ``optim``) so
each module's counterpart is found by name.  The port imports ``torch`` and
numpy only -- never ``jax`` and never ``repro``.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
the CPU is used only when the caller passes ``device="cpu"``.  There is no
silent fallback from a missing card to the CPU.
"""
from __future__ import annotations

import torch

# The reference computes every matmul and convolution in full fp32 (XLA on
# CPU/TPU at "highest" precision in the parity runs).  TF32 keeps ~3 decimal
# digits, which would move the MRC log-weights and the STE mask draws away
# from the reference, so both TF32 switches stay off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when a card is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev
