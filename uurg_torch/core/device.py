"""Device resolution: the CUDA card by default, the CPU only on request."""
from __future__ import annotations

import torch

from uurg_torch.parallel.dist import is_initialized, local_rank


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``, and under a process group ``cuda:<local
    rank>``, the card of this rank. Raises when CUDA is asked for and
    missing; nothing falls back to the CPU unless ``device="cpu"`` was
    passed.

    On CUDA this also fixes the float32 precision of cuDNN convolutions and
    cuBLAS matmuls to full float32 (TF32 off): the only float32 layer on the
    sampling path is ``conv_out``, which the JAX model runs in float32 on
    purpose, and the parity checks on the card compare float32 results."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if device is None and is_initialized():
            dev = torch.device("cuda", local_rank())
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# every mode of the JAX package's runners
PARALLELISMS = ("dp", "fsdp", "tp", "pp", "sp")


def refuse_multi_device(parallelism: str = "dp") -> None:
    """Raise ``ValueError`` for a ``parallelism`` that is none of
    :data:`PARALLELISMS`; each of those passes (the runners check the
    mesh's axes for it)."""
    if parallelism not in PARALLELISMS:
        raise ValueError(f"unknown parallelism {parallelism!r}")
