"""Stable Diffusion's UNet (LDM v1, 860M), bf16 compute.

Port of ``uurg_tpu/models/sd_unet.py`` (parity targets
SD/ldm/modules/diffusionmodules/openaimodel.py:428-1064 and
SD/ldm/modules/attention.py:149-303): residual blocks conditioned on the
timestep embedding, spatial transformers with self-attention and
cross-attention over a text context, a skip-connected encoder and decoder.
Latents go in and eps comes out NHWC, as in the JAX package; inside,
activations are NCHW tensors in channels-last memory, as in the DDPM UNet
(:mod:`uurg_torch.models.layers`), so the GroupNorm kernel and the
transformers read them as NHWC views.

Modules carry the Flax names (``conv_in``, ``time_embed_{0,2}``,
``down_{i}_res_{j}.{norm1,conv1,emb_proj,norm2,conv2,skip}``,
``down_{i}_attn_{j}.tblock_0.attn1.to_q``, ``down_{i}_downsample``,
``mid_res_1``, ``mid_attn``, ``up_{i}_upsample``, ``norm_out``,
``conv_out``), so Fishers and masks are keyed by the Flax paths and the
``train_method`` name map applies unchanged.

Dtypes follow the JAX model: every convolution and dense layer computes in
``dtype`` (bf16 by default) with float32 parameters, the LayerNorms in
float32, ``conv_out`` in float32 on float32 parameters. Self-attention goes
to the attention dispatcher (on the card, the bf16 kernels at the true head
width, on q, k, v views of the three projections) exactly where the JAX
model sends it to its dispatcher: ``T % 128 == 0`` (T = 4096, 1024, 256 at
full width). The 8x8 mid site, cross-attention over the 77 context tokens
and every other site run :func:`~uurg_torch.ops.flash_attention.
attention_plain`, the JAX einsums' arithmetic (fp32 scores from upcast
operands). GEGLU takes the tanh GELU (``jax.nn.gelu``'s default).

``remat`` recomputes each residual block and each spatial transformer in
the backward (``torch.utils.checkpoint``, non-reentrant); under
``remat_policy="dots"`` a selective-checkpoint policy keeps the matmul and
convolution outputs and recomputes the rest. Either gives the gradients of
no remat bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from uurg_torch.models.init import init_classifier
from uurg_torch.models.layers import (Conv2d, GroupNorm32, Linear,
                                      swish, timestep_embedding)
from uurg_torch.ops.flash_attention import attention, attention_plain
from uurg_torch.parallel.tensor import model_size

LN_EPS = 1e-6           # flax nn.LayerNorm
REMAT_POLICIES = (None, "dots")
_CL = torch.channels_last


class SDResBlock(nn.Module):
    """swish(norm1) -> conv1, plus the timestep projection, then
    swish(norm2) -> conv2, plus the input (a 1x1 ``skip`` where the channels
    change)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.emb_proj = Linear(emb_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.skip = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = h + self.emb_proj(swish(emb))[:, :, None, None]
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    """(B, T, C) -> (B, T, C): heads of ``dim_head`` from bias-free
    ``to_q`` (of x), ``to_k`` and ``to_v`` (of the context, or of x for
    self-attention), then ``to_out``. q, k and v are (B, H, T, D) views of
    the projections: the bf16 kernels read them where they lie. Under
    tensor parallel the rank's ``heads`` / model heads: ``to_q``, ``to_k``
    and ``to_v`` column-parallel, ``to_out`` row-parallel."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        cdim = context_dim or dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(cdim, inner, bias=False)
        self.to_v = Linear(cdim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        self_attn = context is None
        context = x if self_attn else context
        B, T, _ = x.shape
        S = context.shape[1]
        H, D = self.heads // model_size(self.to_q.weight), self.dim_head
        q = self.to_q(x).reshape(B, T, H, D).transpose(1, 2)
        k = self.to_k(context).reshape(B, S, H, D).transpose(1, 2)
        v = self.to_v(context).reshape(B, S, H, D).transpose(1, 2)
        if self_attn and T % 128 == 0:
            out = attention(q, k, v)
        else:
            out = attention_plain(q, k, v)
        out = out.to(x.dtype).transpose(1, 2).reshape(B, T, H * D)
        return self.to_out(out)


class GEGLU(nn.Module):
    """Value times the tanh GELU of the gate, both from one projection
    (under tensor parallel the rank's slice of each)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, 2 * dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b, approximate="tanh")


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Flax ``nn.LayerNorm(dtype=float32)`` of ``x.astype(float32)``, cast
    back to x's dtype."""
    return norm(x.float()).to(x.dtype)


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention over the context, GEGLU feed-forward,
    each after a float32 LayerNorm and added to the stream."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff_geglu = GEGLU(dim, 4 * dim)
        self.ff_out = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(_layer_norm(self.norm1, x))
        x = x + self.attn2(_layer_norm(self.norm2, x), context)
        return x + self.ff_out(self.ff_geglu(_layer_norm(self.norm3, x)))


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 ``proj_in``, ``depth`` transformer blocks over the
    H W tokens, 1x1 ``proj_out``, plus the input."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.proj_in = Conv2d(channels, channels, 1)
        for i in range(depth):
            self.add_module(f"tblock_{i}", BasicTransformerBlock(
                channels, heads, dim_head, context_dim))
        self.depth = depth
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).contiguous(memory_format=_CL)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for i in range(self.depth):
            h = getattr(self, f"tblock_{i}")(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + self.proj_out(h)


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_ds: tuple = (1, 2, 4)    # downsample factors with attention
    num_heads: int = 8
    context_dim: int = 768
    transformer_depth: int = 1
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                  # recompute blocks in the backward
    remat_policy: str | None = None     # None: whole blocks; "dots": keep
    #                                     the matmul and convolution outputs


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.convolution.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of the projections'
    matmuls and of the convolutions, recompute the rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


_dots_context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                  _save_dots)


class SDUNet(nn.Module):
    """``forward(x, t, context)``: NHWC latents (B, H, W, in_channels),
    timesteps (B,) (integer or float), context (B, S, context_dim) ->
    float32 NHWC eps (B, H, W, out_channels)."""

    def __init__(self, cfg: SDUNetConfig | None = None):
        super().__init__()
        cfg = cfg or SDUNetConfig()
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one "
                             f"of {REMAT_POLICIES}")
        self.cfg = cfg
        ch0, emb_ch = cfg.model_channels, 4 * cfg.model_channels
        self.time_embed_0 = Linear(ch0, emb_ch)
        self.time_embed_2 = Linear(emb_ch, emb_ch)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)

        def attn(name, c):
            self.add_module(name, SpatialTransformer(
                c, cfg.num_heads, c // cfg.num_heads, cfg.context_dim,
                cfg.transformer_depth))

        chans = [ch0]
        ch, ds, last = ch0, 1, len(cfg.channel_mult) - 1
        for i, mult in enumerate(cfg.channel_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_res_{j}",
                                SDResBlock(ch, ch0 * mult, emb_ch))
                ch = ch0 * mult
                if ds in cfg.attention_ds:
                    attn(f"down_{i}_attn_{j}", ch)
                chans.append(ch)
            if i != last:
                self.add_module(f"down_{i}_downsample",
                                Conv2d(ch, ch, 3, stride=2, padding=1))
                chans.append(ch)
                ds *= 2
        self.mid_res_1 = SDResBlock(ch, ch, emb_ch)
        attn("mid_attn", ch)
        self.mid_res_2 = SDResBlock(ch, ch, emb_ch)
        for i in reversed(range(len(cfg.channel_mult))):
            for j in range(cfg.num_res_blocks + 1):
                out = ch0 * cfg.channel_mult[i]
                self.add_module(f"up_{i}_res_{j}",
                                SDResBlock(ch + chans.pop(), out, emb_ch))
                ch = out
                if ds in cfg.attention_ds:
                    attn(f"up_{i}_attn_{j}", ch)
            if i != 0:
                self.add_module(f"up_{i}_upsample",
                                Conv2d(ch, ch, 3, padding=1))
                ds //= 2
        self.norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, padding=1)

    def fsdp_units(self) -> list[nn.Module]:
        """The modules FSDP2 shards as units of their own
        (``uurg_torch.parallel.mesh.shard_params_fsdp``), the rest going
        with the root: the time embedding, the residual blocks' two
        convolutions and timestep projection, the spatial transformers'
        projections and transformer blocks, the resampling convolutions.
        The input of each reaches it alone. A residual block's or a
        spatial transformer's input also feeds its skip path and the
        UNet's skip list: as a unit, FSDP2's autograd node on its inputs
        would group those gradients' sum otherwise, and a one-rank run
        would leave one device's bits."""
        units: list[nn.Module] = [self.time_embed_0, self.time_embed_2]
        for name, mod in self.named_children():
            if isinstance(mod, SDResBlock):
                units += [mod.conv1, mod.emb_proj, mod.conv2]
            elif isinstance(mod, SpatialTransformer):
                units += [mod.proj_in, *(getattr(mod, f"tblock_{i}")
                                         for i in range(mod.depth)),
                          mod.proj_out]
            elif name.endswith("sample"):
                units.append(mod)
        return units

    def _call(self, block: nn.Module, *args) -> torch.Tensor:
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return block(*args)
        context = (_dots_context if cfg.remat_policy == "dots"
                   else ckpt.noop_context_fn)
        return ckpt.checkpoint(block, *args, use_reentrant=False,
                               preserve_rng_state=False, context_fn=context)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        emb = self.time_embed_0(
            timestep_embedding(t, cfg.model_channels).to(dt))
        emb = self.time_embed_2(swish(emb))
        context = context.to(dt)

        def block(name, h):
            mod = getattr(self, name)
            if isinstance(mod, SDResBlock):
                return self._call(mod, h, emb)
            return self._call(mod, h, context)

        h = x.to(dt).contiguous().permute(0, 3, 1, 2)      # NCHW view
        hs = [self.conv_in(h)]
        ds = 1
        for i in range(len(cfg.channel_mult)):
            for j in range(cfg.num_res_blocks):
                h = block(f"down_{i}_res_{j}", hs[-1])
                if ds in cfg.attention_ds:
                    h = block(f"down_{i}_attn_{j}", h)
                hs.append(h)
            if hasattr(self, f"down_{i}_downsample"):
                hs.append(getattr(self, f"down_{i}_downsample")(hs[-1]))
                ds *= 2
        h = block("mid_res_1", hs[-1])
        h = block("mid_attn", h)
        h = block("mid_res_2", h)
        for i in reversed(range(len(cfg.channel_mult))):
            for j in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = block(f"up_{i}_res_{j}", h)
                if ds in cfg.attention_ds:
                    h = block(f"up_{i}_attn_{j}", h)
            if i != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
                ds //= 2
        h = swish(self.norm_out(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


@torch.no_grad()
def init_sd_unet(seed: int, cfg: SDUNetConfig | None = None,
                 device: str | torch.device = "cpu") -> SDUNet:
    """An SDUNet of ``cfg`` built on ``device`` with flax's initial weights
    in distribution, drawn from a generator on that device seeded with
    ``seed``: LeCun-normal kernels (truncated at two standard deviations),
    zero biases, unit norms. No SD checkpoint is in the repository: a
    seeded init stands in for the CompVis weights until one is read
    (:mod:`uurg_torch.io.sd_interop`)."""
    with torch.device(device):
        model = SDUNet(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_classifier(gen, model.to(device))


# -- train_method parameter-subset masks -----------------------------------
#
# The reference selects trainable parameters by substring and prefix tests
# on the CompVis torch names (SD/train-scripts/train-esd.py:209-235,
# nsfw_removal.py:67-77). Every parameter name of this model (the Flax path,
# '.'-joined) is mapped to its CompVis equivalent and the reference's
# decision function runs on the mapped name: input_blocks.0 is conv_in,
# then num_res_blocks res(+attn) slots plus one downsample slot a level;
# output_blocks hold num_res_blocks + 1 slots a level, in reversed order.

def _arch_dims(names) -> tuple[int, int]:
    """(levels, num_res_blocks) from the parameter names."""
    levels, nres = 1, 1
    for p in names:
        # decoder levels run num_res_blocks + 1 res blocks, so only the
        # encoder (down_*) names reflect num_res_blocks itself
        m = re.match(r"(?:down|up)_(\d+)_", p)
        if m:
            levels = max(levels, int(m.group(1)) + 1)
        m = re.match(r"down_(\d+)_res_(\d+)", p)
        if m:
            nres = max(nres, int(m.group(2)) + 1)
    return levels, nres


def _torch_name(p: str, levels: int, nres: int) -> str:
    """A parameter name (``head.rest``) -> its CompVis torch-name
    equivalent, as much of it as the reference's tests read."""
    head, _, rest = p.partition(".")
    per = nres + 1  # res(+attn) slots plus the down/up-sample slot
    m = re.match(r"down_(\d+)_(res|attn)_(\d+)$", head)
    if m:
        i, kind, j = int(m.group(1)), m.group(2), int(m.group(3))
        sub = "0" if kind == "res" else "1.transformer_blocks"
        return f"input_blocks.{1 + i * per + j}.{sub}.{rest}"
    m = re.match(r"down_(\d+)_downsample$", head)
    if m:
        return f"input_blocks.{1 + int(m.group(1)) * per + nres}.0.op.{rest}"
    m = re.match(r"up_(\d+)_(res|attn)_(\d+)$", head)
    if m:
        i, kind, j = int(m.group(1)), m.group(2), int(m.group(3))
        sub = "0" if kind == "res" else "1.transformer_blocks"
        return f"output_blocks.{(levels - 1 - i) * per + j}.{sub}.{rest}"
    m = re.match(r"up_(\d+)_upsample$", head)
    if m:
        i = int(m.group(1))
        return f"output_blocks.{(levels - 1 - i) * per + nres}.2.conv.{rest}"
    fixed = {
        "conv_in": "input_blocks.0.0",
        "mid_res_1": "middle_block.0",
        "mid_attn": "middle_block.1.transformer_blocks",
        "mid_res_2": "middle_block.2",
        "time_embed_0": "time_embed.0",
        "time_embed_2": "time_embed.2",
        "norm_out": "out.0",
        "conv_out": "out.2",
    }
    return f"{fixed[head]}.{rest}"


def reference_train_method_select(name: str, method: str) -> bool:
    """The reference's parameter-selection predicate over CompVis torch
    names (SD/train-scripts/train-esd.py:209-235)."""
    if method == "full":
        return True
    if method == "noxattn":
        return not (name.startswith("out.") or "attn2" in name
                    or "time_embed" in name)
    if method == "selfattn":
        return "attn1" in name
    if method == "xattn":
        return "attn2" in name
    if method == "notime":
        return not (name.startswith("out.") or "time_embed" in name)
    if method == "xlayer":
        return "attn2" in name and ("output_blocks.6." in name
                                    or "output_blocks.8." in name)
    if method == "selflayer":
        return "attn1" in name and ("input_blocks.4." in name
                                    or "input_blocks.7." in name)
    raise ValueError(f"unknown train_method {method!r}")


def _named(params) -> dict[str, torch.Tensor]:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else dict(params))


def train_method_leaf_mask(params: nn.Module | Mapping[str, torch.Tensor],
                           method: str) -> dict[str, bool]:
    """Whether each parameter (of a model, or a dict of named tensors) is
    trained under ``method``: ``train_method`` subsets select whole layers,
    so a bool a parameter is exact."""
    names = list(_named(params))
    levels, nres = _arch_dims(names)
    return {n: reference_train_method_select(_torch_name(n, levels, nres),
                                             method) for n in names}


def train_method_mask(params: nn.Module | Mapping[str, torch.Tensor],
                      method: str) -> dict[str, torch.Tensor]:
    """0/1 float32 gradient mask of the reference's ``train_method``
    parameter selection, keyed by parameter name."""
    named = _named(params)
    decisions = train_method_leaf_mask(named, method)
    return {n: torch.full(p.shape, float(decisions[n]), dtype=torch.float32,
                          device=p.device) for n, p in named.items()}
