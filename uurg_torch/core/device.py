"""Device resolution: the CUDA card by default, the CPU only on request."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and missing;
    nothing falls back to the CPU unless ``device="cpu"`` was passed.

    On CUDA this also fixes the float32 precision of cuDNN convolutions and
    cuBLAS matmuls to full float32 (TF32 off): the only float32 layer on the
    sampling path is ``conv_out``, which the JAX model runs in float32 on
    purpose, and the parity checks on the card compare float32 results."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def refuse_multi_device(mesh=None, parallelism: str = "dp",
                        pp_microbatches: int | None = None) -> None:
    """Raise for the multi-device knobs (a mesh, ``parallelism`` other than
    ``"dp"``, pipeline microbatches), which the port does not run yet."""
    if mesh is not None or parallelism != "dp" or pp_microbatches:
        raise NotImplementedError(
            f"mesh={mesh!r}, parallelism={parallelism!r}, pp_microbatches="
            f"{pp_microbatches!r}: the port runs on one device; the "
            f"multi-device paths come with ROADMAP Queue 1 item 8")
