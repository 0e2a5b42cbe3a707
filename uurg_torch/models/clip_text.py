"""CLIP text encoder (the ViT-L/14 text tower), the frozen conditioning
stage of Stable Diffusion.

Port of ``uurg_tpu/models/clip_text.py`` (parity target
SD/ldm/modules/encoders/modules.py:230-271, FrozenCLIPEmbedder over
openai/clip-vit-large-patch14): token and position embeddings, a causal
pre-LN transformer with quick-gelu MLPs, a final LayerNorm; the full
77-token hidden-state sequence is the UNet's cross-attention context. The
modules carry the Flax names (``token_embed``, ``pos_embed``,
``attn_{i}.qkv``, ``attn_{i}.proj``, ``ln1_{i}``, ``ln2_{i}``, ``fc1_{i}``,
``fc2_{i}``, ``ln_final``). The causal attention over 77 tokens is a plain
matmul with fp32 scores, as the JAX einsum is: no Pallas kernel stands
behind it. LayerNorm takes torch's two-pass variance where Flax takes
E[x^2] - E[x]^2 (an fp32 rounding difference, held by the tests).

Tokenization (SD runs the real CLIP BPE) has three tiers, the first that is
available on the machine wins, all deterministic across processes:

1. :class:`CLIPBPETokenizer`, CLIP's BPE reimplemented, over a local vocab:
   the openai ``bpe_simple_vocab_16e6.txt.gz`` (``$UURG_CLIP_BPE``) or an
   HF ``vocab.json`` + ``merges.txt`` directory;
2. the HF ``CLIPTokenizer`` when its files are in the local cache;
3. :func:`hash_tokenize`, per-word ``zlib.crc32`` ids: not the CLIP
   vocabulary, so prompts tokenized this way mean nothing to converted
   CLIP weights.

:func:`active_tokenizer` says which tier is live.
"""
from __future__ import annotations

import dataclasses
import functools
import gzip
import json
import os
import re
import zlib
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from uurg_torch.models.init import init_classifier
from uurg_torch.models.layers import Linear

LN_EPS = 1e-6           # flax nn.LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    dtype: torch.dtype = torch.float32


class CausalMHSA(nn.Module):
    """Causal multi-head self-attention: one fused qkv projection, fp32
    scores scaled by D^-0.5, -1e9 above the diagonal, fp32 softmax, the
    probabilities cast to the compute dtype before the PV product."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        q, k, v = (t.transpose(1, 2) for t in
                   self.qkv(x).reshape(B, T, 3, H, D // H).unbind(2))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (D // H) ** -0.5
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        attn = torch.softmax(attn.masked_fill(~causal, -1e9), dim=-1)
        out = torch.matmul(attn.to(x.dtype).float(), v.float()).to(x.dtype)
        return self.proj(out.transpose(1, 2).reshape(B, T, D))


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids)``: (B, T) int token ids -> (B, T, hidden) fp32
    hidden states after the final LayerNorm."""

    def __init__(self, cfg: CLIPTextConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or CLIPTextConfig()
        D = cfg.hidden_size
        self.token_embed = nn.Embedding(cfg.vocab_size, D)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_length, D))
        for i in range(cfg.depth):
            self.add_module(f"ln1_{i}", nn.LayerNorm(D, eps=LN_EPS))
            self.add_module(f"attn_{i}", CausalMHSA(D, cfg.num_heads))
            self.add_module(f"ln2_{i}", nn.LayerNorm(D, eps=LN_EPS))
            self.add_module(f"fc1_{i}", Linear(D, 4 * D))
            self.add_module(f"fc2_{i}", Linear(4 * D, D))
        self.ln_final = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        T = input_ids.shape[1]
        h = self.token_embed(input_ids.long()) + self.pos_embed[None, :T]
        for i in range(cfg.depth):
            ln1, attn, ln2, fc1, fc2 = (getattr(self, f"{n}_{i}") for n in
                                        ("ln1", "attn", "ln2", "fc1", "fc2"))
            h = h + attn(ln1(h).to(cfg.dtype)).float()
            m = fc1(ln2(h).to(cfg.dtype))
            m = m * torch.sigmoid(1.702 * m)      # quick-gelu (CLIP)
            h = h + fc2(m).float()
        return self.ln_final(h)


@torch.no_grad()
def init_clip_text(seed: int, cfg: CLIPTextConfig | None = None,
                   device: str | torch.device = "cpu") -> CLIPTextEncoder:
    """A CLIPTextEncoder of ``cfg`` on ``device`` in eval mode, frozen,
    with flax's initial weights in distribution drawn from a generator on
    that device seeded with ``seed``: LeCun-normal dense kernels, zero
    biases, unit LayerNorms, the token table N(0, 1 / hidden) and the
    position table N(0, 0.01^2). A seeded init stands in for the CLIP
    weights until a checkpoint is read
    (:mod:`uurg_torch.io.vae_clip_interop`)."""
    with torch.device(device):
        model = CLIPTextEncoder(cfg)
    model = model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_classifier(gen, model)
    table = model.token_embed.weight
    table.normal_(0.0, table.shape[1] ** -0.5, generator=gen)
    model.pos_embed.normal_(0.0, 0.01, generator=gen)
    return model.eval().requires_grad_(False)


_BOS, _EOS = 49406, 49407

# CLIP's text-splitting regex (contractions, letter runs, digit singles,
# symbol runs), minus the ftfy pass; \p{L}/\p{N} approximated with the
# std-re unicode word classes
_CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE)


def _bytes_to_unicode() -> dict[int, str]:
    """The GPT-2/CLIP reversible byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPBPETokenizer:
    """CLIP's BPE, reimplemented: greedy lowest-rank pair merging over
    byte-mapped words with a ``</w>`` end-of-word marker.

    ``path``: the openai ``bpe_simple_vocab_16e6.txt.gz`` merges list, or a
    directory holding HF ``vocab.json`` + ``merges.txt``."""

    def __init__(self, path: str):
        self.byte_encoder = _bytes_to_unicode()
        if os.path.isdir(path):
            with open(os.path.join(path, "vocab.json")) as f:
                self.encoder = json.load(f)
            with open(os.path.join(path, "merges.txt")) as f:
                lines = f.read().split("\n")
            lines = [ln for ln in lines[1:] if ln and not ln.startswith("#")]
            merges = [tuple(ln.split()) for ln in lines][:48894]
        else:
            with gzip.open(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(m.split()) for m in lines[1:48894 + 1]]
            vocab = list(self.byte_encoder.values())
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        if token in self.cache:
            return self.cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1
                        and (word[i], word[i + 1]) == best):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.lower()).strip()
        ids: list[int] = []
        for tok in _CLIP_PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped))
        return ids

    def __call__(self, prompts: Sequence[str],
                 max_length: int = 77) -> np.ndarray:
        out = np.full((len(prompts), max_length), _EOS, np.int32)
        for i, p in enumerate(prompts):
            ids = [_BOS] + self.encode(p)[: max_length - 2] + [_EOS]
            out[i, : len(ids)] = ids
        return out


def _find_bpe_vocab() -> str | None:
    """A CLIP BPE vocab on this machine (no downloads): ``$UURG_CLIP_BPE``,
    else an HF hub snapshot holding ``vocab.json`` and ``merges.txt``."""
    cands = [os.environ.get("UURG_CLIP_BPE", "")]
    hub = os.path.expanduser("~/.cache/huggingface/hub")
    if os.path.isdir(hub):
        for root, _dirs, files in os.walk(hub):
            if "merges.txt" in files and "vocab.json" in files:
                cands.append(root)
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


@functools.lru_cache(maxsize=1)
def _resolve_tokenizer():
    """(name, callable(prompts, max_length) -> ids) of the best local
    tier."""
    path = _find_bpe_vocab()
    if path:
        try:
            return f"clip-bpe:{path}", CLIPBPETokenizer(path)
        except (OSError, ValueError, KeyError):
            pass
    try:
        from transformers import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained(
            "openai/clip-vit-large-patch14", local_files_only=True)
        # a cached tokenizer that is not CLIP's 49,408-token vocabulary
        # (one such gave every prompt the same ids) is no tier
        if (len(tok), tok.bos_token_id, tok.eos_token_id) != (
                49408, _BOS, _EOS):
            raise ValueError(f"the cached tokenizer has {len(tok)} tokens, "
                             f"BOS {tok.bos_token_id}, EOS "
                             f"{tok.eos_token_id}: not CLIP's")

        def hf(prompts, max_length):
            enc = tok(list(prompts), truncation=True, max_length=max_length,
                      padding="max_length", return_tensors="np")
            return enc["input_ids"].astype(np.int32)

        return "hf-clip", hf
    except (ImportError, OSError, ValueError):  # no transformers, or no
        return "crc32-fallback", hash_tokenize   # files in its cache


def active_tokenizer() -> str:
    """Which tokenization tier is live in this process."""
    return _resolve_tokenizer()[0]


def hash_tokenize(prompts: Sequence[str], max_length: int = 77,
                  vocab_size: int = 49408) -> np.ndarray:
    """The last tier (no vocab files on the machine): stable ``zlib.crc32``
    per-word ids, the same in every process, unlike Python's salted
    ``hash()``. NOT the CLIP vocabulary."""
    out = np.full((len(prompts), max_length), _EOS, np.int32)
    for i, p in enumerate(prompts):
        ids = [_BOS]
        for w in p.lower().split()[: max_length - 2]:
            ids.append(zlib.crc32(w.encode("utf-8")) % (vocab_size - 2))
        ids.append(_EOS)
        out[i, : len(ids)] = ids
    return out


def tokenize(prompts: Sequence[str], max_length: int = 77) -> np.ndarray:
    """(len(prompts), max_length) int32 ids from the best local tier."""
    return _resolve_tokenizer()[1](prompts, max_length)
