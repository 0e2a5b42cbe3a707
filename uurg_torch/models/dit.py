"""Multi-head self-attention of the transformer classifiers.

Port of ``MHSA`` in ``uurg_tpu/models/dit.py`` (the rest of that module, the
DiT itself, is not ported yet): a fused qkv projection, the split into
``(B, T, 3, H, D / H)``, heads to the front, the attention dispatcher of
:mod:`uurg_torch.ops.flash_attention` (the hand-written kernels on CUDA in
bfloat16 and float32, the plain version on the CPU) and the output
projection. The projections compute in ``dtype`` with float32 parameters,
as Flax's ``nn.Dense(dtype=...)`` does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uurg_torch.ops.flash_attention import attention


class Linear(nn.Linear):
    """Linear computing in ``dtype``: input, weight and bias cast at the
    call, float32 parameters kept (Flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class MHSA(nn.Module):
    """(B, T, dim) -> (B, T, dim). The dispatcher wants contiguous
    (B, H, T, D) q, k and v, so the transposed heads are made contiguous."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, T, 3, H, D // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        out = attention(q, k, v).to(self.compute_dtype)
        return self.proj(out.transpose(1, 2).reshape(B, T, D))
