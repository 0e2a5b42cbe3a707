"""DiT (Diffusion Transformer) on NHWC latents, and the multi-head
self-attention that the transformer classifiers share.

Port of ``uurg_tpu/models/dit.py``: patchify, the fixed 2-D sin-cos position
embedding, adaLN-Zero blocks and the learned-sigma output
(DiT/models.py:27-370). The submodules carry facebookresearch DiT's names
(``x_embedder.proj``, ``t_embedder.mlp.{0,2}``,
``y_embedder.embedding_table``, ``blocks.{i}.{attn.qkv, attn.proj,
mlp.fc1, mlp.fc2, adaLN_modulation.1}``, ``final_layer.{adaLN_modulation.1,
linear}``), so a reference ``.pt`` loads with ``load_state_dict`` once its
``pos_embed`` entry is dropped (:mod:`uurg_torch.io.dit_interop`), and
saliency masks and Fishers are keyed by the reference's names. The position
embedding is a non-persistent buffer, recomputed and never loaded.

Dtypes follow the JAX model: the patchify convolution, the attention
projections and the MLP compute in ``dtype`` (bf16 by default) with float32
parameters, as Flax's ``nn.Dense(dtype=...)`` does; the timestep MLP, the
label table, every adaLN modulation and the final layer in float32 (float64
in a model built and run in float64, for precision references); the
LayerNorm + modulate chain between the matmuls in ``norm_dtype``, the
LayerNorm statistics in float32 either way. LayerNorm takes torch's two-pass
variance where Flax takes E[x^2] - E[x]^2 (a float32 rounding difference,
held by the tests).

``scan_blocks`` only names the JAX parameter layout (depth-stacked or one
subtree a block, both read by ``io.jax_interop.jax_dit_params_to_torch``):
the blocks are an ``nn.ModuleList`` either way. ``remat`` recomputes each
block in the backward with ``torch.utils.checkpoint`` (non-reentrant), under
``remat_policy``:

- ``None``: the whole block, the attention kernel included;
- ``"attn"``: the attention output is kept, so the attention kernel runs
  once in the forward and once in the backward (the block is two
  checkpointed segments around it);
- ``"dots"``: the matmul outputs (``aten.mm`` / ``aten.addmm``) are kept by a
  selective-checkpoint policy and the elementwise and norm work is
  recomputed; the attention ``autograd.Function`` is invisible to the
  policy and re-runs, as a ``pallas_call`` does under JAX's ``dots``;
- ``"attn+dots"``: both.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from uurg_torch.models.init import init_classifier
from uurg_torch.ops.flash_attention import attention
from uurg_torch.parallel import tensor as tp

LN_EPS = 1e-6           # flax nn.LayerNorm
REMAT_POLICIES = (None, "attn", "dots", "attn+dots")


def wide(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for float64 inputs (precision references)."""
    return x if x.dtype == torch.float64 else x.float()


class Linear(nn.Linear):
    """Linear computing in ``dtype``: input, weight and bias cast at the
    call, float32 parameters kept (Flax ``nn.Dense(dtype=...)``); the
    column- or row-parallel form on a tensor-parallel weight."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return tp.linear(x.to(dt), self.weight, self.bias, dt)


class WideLinear(nn.Linear):
    """Linear in float32 (Flax ``nn.Dense(dtype=jnp.float32)``), or in
    float64 when the input is float64."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = wide(x)
        return tp.linear(x, self.weight, self.bias, x.dtype)


class MHSA(nn.Module):
    """(B, T, dim) -> (B, T, dim). q, k and v go to the attention dispatcher
    as (B, H, T, D) views of the fused projection's (B, T, 3, H, D), with no
    copy: the bfloat16 kernels read them where they lie, write the output
    token-major, and :meth:`merge` is then a view as well. Under tensor
    parallel the rank's H / model heads: ``qkv`` column-parallel (its shard
    holds those heads of q, k and v), ``proj`` row-parallel."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def heads(self, x: torch.Tensor):
        """q, k, v as (B, H, T, D / H) views of the projection (one stack
        into its gradient in the backward, where a select each would fill a
        whole (B, T, 3, H, D) tensor)."""
        B, T, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, T, 3, H // tp.model_size(
            self.qkv.weight), D // H)
        return tuple(t.transpose(1, 2) for t in qkv.unbind(2))

    def merge(self, out: torch.Tensor) -> torch.Tensor:
        """The attention output (B, H, T, D / H) back to (B, T, dim),
        projected."""
        B, H, T, Dh = out.shape
        out = out.to(self.compute_dtype).transpose(1, 2).reshape(B, T, H * Dh)
        return self.proj(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.merge(attention(*self.heads(x)))


def dit_timestep_embedding(t: torch.Tensor, dim: int,
                           max_period: float = 10000.0,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DiT/ADM timestep embedding: freqs exp(-ln(P) * i / half), [cos | sin]
    (DiT/models.py TimestepEmbedder.timestep_embedding)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=dtype, device=t.device)
                      / half)
    args = t.to(dtype)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_2d_pos_embed(dim: int, grid: int) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding (DiT/models.py:270-312 math),
    (grid * grid, dim) float32, computed in float64."""
    def one_dim(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    emb = np.concatenate(
        [one_dim(dim // 2, gx), one_dim(dim // 2, gy)], axis=1)
    return emb.astype(np.float32)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _layer_norm(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.LayerNorm(use_bias=False, use_scale=False, dtype=dtype)``
    of ``x.astype(dtype)``: statistics in float32 (float64 for float64),
    output in ``dtype``."""
    x = x.to(dtype)
    return F.layer_norm(wide(x), x.shape[-1:], eps=LN_EPS).to(dtype)


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(hidden, mlp_dim, dtype=dtype)
        self.fc2 = Linear(mlp_dim, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block (DiT/models.py:101-123)."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype, self.norm_dtype = dtype, norm_dtype
        self.attn = MHSA(hidden, num_heads, dtype)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              WideLinear(hidden, 6 * hidden))

    def modulation(self, c: torch.Tensor):
        """(shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
        gate_mlp), each (B, hidden) in ``norm_dtype`` (gathered whole from
        the ranks' slices of the six under tensor parallel)."""
        mods = tp.gather_from_model(self.adaLN_modulation(c),
                                    self.adaLN_modulation[1].weight)
        return mods.to(self.norm_dtype).chunk(6, dim=-1)

    def pre_attn(self, x, shift_msa, scale_msa):
        """The attention's q, k, v."""
        h = modulate(_layer_norm(x, self.norm_dtype), shift_msa, scale_msa)
        return self.attn.heads(h.to(self.compute_dtype))

    def post_attn(self, x, out, gate_msa, shift_mlp, scale_mlp, gate_mlp):
        """The block's output from its input and the attention output."""
        dt = self.compute_dtype
        x = x + gate_msa[:, None, :].to(dt) * self.attn.merge(out)
        h = modulate(_layer_norm(x, self.norm_dtype), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :].to(dt) * self.mlp(h.to(dt))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        s1, sc1, g1, s2, sc2, g2 = self.modulation(c)
        out = attention(*self.pre_attn(x, s1, sc1))
        return self.post_attn(x, out, g1, s2, sc2, g2)

    def forward_saving_attn(self, x: torch.Tensor, c: torch.Tensor,
                            context_fn=ckpt.noop_context_fn) -> torch.Tensor:
        """The block as two checkpointed segments around the attention: the
        attention's inputs and output are kept, everything else is
        recomputed in the backward."""
        s1, sc1, g1, s2, sc2, g2 = self.modulation(c)
        q, k, v = ckpt.checkpoint(self.pre_attn, x, s1, sc1,
                                  use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=context_fn)
        out = attention(q, k, v)
        return ckpt.checkpoint(self.post_attn, x, out, g1, s2, sc2, g2,
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=context_fn)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of the projections'
    matmuls (unbatched dots, JAX's ``dots_with_no_batch_dims_saveable``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


_dots_context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                  _save_dots)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(WideLinear(freq_dim, hidden), nn.SiLU(),
                                 WideLinear(hidden, hidden))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.mlp(dit_timestep_embedding(t, self.freq_dim, dtype=dtype))


class LabelEmbedder(nn.Module):
    """Class table with a null row (index ``num_classes``) for CFG."""

    def __init__(self, num_classes: int, hidden: int):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_table = nn.Embedding(num_classes + 1, hidden)

    def forward(self, y: torch.Tensor, keep: torch.Tensor | None = None):
        if keep is not None:
            y = torch.where(keep, y, self.num_classes)
        return self.embedding_table(y)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, cin: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(cin, hidden, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> (B, T, hidden), tokens row-major."""
        dt = self.compute_dtype
        h = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.proj.stride)
        return h.flatten(2).transpose(1, 2)


class FinalLayer(nn.Module):
    def __init__(self, hidden: int, out_dim: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              WideLinear(hidden, 2 * hidden))
        self.linear = WideLinear(hidden, out_dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(_layer_norm(x, wide(x).dtype), shift,
                                    scale))


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32           # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True
    dtype: torch.dtype = torch.bfloat16
    scan_blocks: bool = True       # the JAX parameter layout only
    remat: bool = True             # recompute block activations in bwd
    norm_dtype: torch.dtype = torch.float32  # LN + modulate chain dtype
    remat_policy: str | None = None  # None (full), attn, dots, attn+dots


class DiT(nn.Module):
    """``forward(x, t, y, cond_keep=None)``: NHWC latents (B, H, W, C),
    timesteps (B,), labels (B,) and an optional keep-mask (False: the null
    label) -> (B, H, W, 2C) (eps | variance) with ``learn_sigma``."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one "
                             f"of {REMAT_POLICIES}")
        self.cfg = cfg
        D, p = cfg.hidden_size, cfg.patch_size
        self.out_channels = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.x_embedder = PatchEmbed(p, cfg.in_channels, D, cfg.dtype)
        self.t_embedder = TimestepEmbedder(D)
        self.y_embedder = LabelEmbedder(cfg.num_classes, D)
        self.blocks = nn.ModuleList(
            DiTBlock(D, cfg.num_heads, cfg.mlp_ratio, cfg.dtype,
                     cfg.norm_dtype) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(D, p * p * self.out_channels)
        grid = cfg.input_size // p
        self.register_buffer(
            "pos_embed", torch.from_numpy(sincos_2d_pos_embed(D, grid)),
            persistent=False)

    def _block(self, block: DiTBlock, h, c):
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return block(h, c)
        if cfg.remat_policy in ("attn", "attn+dots"):
            context = (_dots_context if cfg.remat_policy == "attn+dots"
                       else ckpt.noop_context_fn)
            return block.forward_saving_attn(h, c, context)
        context = (_dots_context if cfg.remat_policy == "dots"
                   else ckpt.noop_context_fn)
        return ckpt.checkpoint(block, h, c, use_reentrant=False,
                               preserve_rng_state=False, context_fn=context)

    def embed(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
              cond_keep: torch.Tensor | None = None):
        """The input stem: (tokens h (B, T, hidden) in ``dtype``, the
        conditioning c (B, hidden) in float32)."""
        cfg = self.cfg
        h = self.x_embedder(x) + self.pos_embed.to(cfg.dtype)[None]
        fdt = wide(self.final_layer.linear.weight).dtype
        c = self.t_embedder(t, fdt) + wide(self.y_embedder(y, cond_keep))
        return h, c

    def head(self, h: torch.Tensor, c: torch.Tensor, shape) -> torch.Tensor:
        """The final adaLN layer and the unpatchify, to NHWC of the input
        ``shape``'s size."""
        B, H, W, C = shape
        p = self.cfg.patch_size
        grid = H // p
        h = self.final_layer(h, c)
        out_c = self.out_channels
        h = h.reshape(B, grid, grid, p, p, out_c).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(B, H, W, out_c)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                cond_keep: torch.Tensor | None = None) -> torch.Tensor:
        h, c = self.embed(x, t, y, cond_keep)
        for block in self.blocks:
            h = self._block(block, h, c)
        return self.head(h, c, x.shape)


def _mk(depth, hidden, heads):
    def factory(patch, **kw):
        return DiTConfig(patch_size=patch, hidden_size=hidden, depth=depth,
                         num_heads=heads, **kw)
    return factory


_SIZES = {"XL": _mk(28, 1152, 16), "L": _mk(24, 1024, 16),
          "B": _mk(12, 768, 12), "S": _mk(12, 384, 6)}

# DiT_models registry parity (DiT/models.py:328-370)
DiT_configs = {
    f"DiT-{s}/{p}": (lambda s=s, p=p: _SIZES[s](p))
    for s in _SIZES for p in (2, 4, 8)
}


@torch.no_grad()
def init_dit_(model: DiT, generator: torch.Generator) -> DiT:
    """Flax's initial weights of the JAX DiT, in distribution, drawn from
    ``generator`` in place: LeCun-normal kernels (truncated at two standard
    deviations) and zero biases, the label table N(0, 1 / hidden), and the
    adaLN-Zero layers zero (every block's modulation, the final modulation
    and the final linear), so a fresh model outputs exactly 0."""
    init_classifier(generator, model)
    table = model.y_embedder.embedding_table.weight
    table.normal_(0.0, table.shape[1] ** -0.5, generator=generator)
    zero = [b.adaLN_modulation[1] for b in model.blocks]
    zero += [model.final_layer.adaLN_modulation[1], model.final_layer.linear]
    for lin in zero:
        lin.weight.zero_()
        lin.bias.zero_()
    return model


def build_dit(name: str, device: str | torch.device | None = None,
              **overrides) -> tuple[DiT, DiTConfig]:
    """A registry config with ``overrides`` and its model, built on
    ``device`` (the CPU when None) with torch's default initial weights."""
    cfg = DiT_configs[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    with torch.device(device or "cpu"):
        model = DiT(cfg)
    return model.to(device or "cpu"), cfg


def init_dit(seed: int, cfg: DiTConfig,
             device: str | torch.device = "cpu") -> DiT:
    """A DiT of ``cfg`` on ``device`` with :func:`init_dit_`'s weights from
    a generator on that device seeded with ``seed``."""
    with torch.device(device):
        model = DiT(cfg)
    model = model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_dit_(model, gen)
