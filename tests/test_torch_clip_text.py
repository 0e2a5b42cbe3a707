"""The port's CLIP text encoder and tokenizer tiers vs the JAX package's
(CPU): TINY_TEXT of the JAX tests with the JAX init's weights carried
across (``jax_clip_text_params_to_torch``); the crc32 tier and the BPE tier
on a tiny vocabulary written to ``tmp_path``."""
import gzip
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.io.jax_interop import jax_clip_text_params_to_torch  # noqa: E402
from uurg_torch.models import clip_text as TC  # noqa: E402
from uurg_tpu.models import clip_text as JC  # noqa: E402

TINY = dict(vocab_size=49408, max_length=8, hidden_size=16, depth=2,
            num_heads=2)
# fp32 on both sides: LayerNorm's two-pass variance against E[x^2] - E[x]^2
F32_REL = 1e-5
PROMPTS = ["a photo of a nude person", "A photo of a person wearing clothes",
           "", "Hello, world! it's 42 degrees   outside\tnow",
           "café naïve"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_clip():
    model, params = JC.init_clip_text(jax.random.key(0),
                                      JC.CLIPTextConfig(**TINY))
    rng = np.random.default_rng(0)
    # LayerNorms and biases off their init, so a mis-wired one shows
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (0.1 * rng.standard_normal(
            np.shape(a))).astype(np.float32) * (np.ndim(a) == 1), params)
    return model, params


def port_clip(params) -> TC.CLIPTextEncoder:
    model = TC.CLIPTextEncoder(TC.CLIPTextConfig(**TINY))
    model.load_state_dict(jax_clip_text_params_to_torch(params), strict=True)
    return model


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_forward_matches_jax(jax_clip):
    model_j, params = jax_clip
    ids = np.concatenate([
        JC.hash_tokenize(PROMPTS, TINY["max_length"]),
        np.random.default_rng(1).integers(0, 49408, (2, 8), np.int32)])
    want = np.asarray(jax.jit(model_j.apply)({"params": params}, ids))
    with torch.no_grad():
        got = port_clip(params)(torch.from_numpy(ids))
    assert got.shape == (len(ids), 8, 16) and got.dtype == torch.float32
    assert rel(got.numpy(), want) <= F32_REL


def test_causal_mask(jax_clip):
    # a later token never reaches an earlier position
    _, params = jax_clip
    model = port_clip(params)
    ids = torch.from_numpy(JC.hash_tokenize(["one two three"], 8))
    other = ids.clone()
    other[0, 3:] = 7
    with torch.no_grad():
        a, b = model(ids), model(other)
    assert torch.equal(a[:, :3], b[:, :3])
    assert not torch.allclose(a[:, 3:], b[:, 3:])


def test_full_width_parameter_count():
    # openai/clip-vit-large-patch14's text tower
    with torch.device("meta"):
        model = TC.CLIPTextEncoder()
    assert sum(p.numel() for p in model.parameters()) == 123_060_480


def test_init_is_seeded_and_frozen():
    a = TC.init_clip_text(3, TC.CLIPTextConfig(**TINY))
    b = TC.init_clip_text(3, TC.CLIPTextConfig(**TINY))
    assert not a.training and not any(p.requires_grad for p in a.parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    table = a.token_embed.weight
    assert abs(table.std().item() - 16 ** -0.5) < 0.01


@pytest.mark.parametrize("max_length", [8, 77])
def test_hash_tokenize_is_jax_bit_for_bit(max_length):
    got = TC.hash_tokenize(PROMPTS, max_length)
    want = JC.hash_tokenize(PROMPTS, max_length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TC.hash_tokenize(PROMPTS, 8, 64),
                                  JC.hash_tokenize(PROMPTS, 8, 64))


def _tiny_bpe(tmp_path):
    """A tiny HF-layout BPE vocabulary (vocab.json + merges.txt) and the
    openai-layout gzip of the same merges."""
    byte_chars = list(TC._bytes_to_unicode().values())
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"),
              ("hell", "o</w>"), ("p", "h"), ("ph", "o"), ("t", "o</w>"),
              ("pho", "to</w>"), ("a", "</w>")]
    # merges whose right half ends a word carry the marker in the vocab
    merged = ["".join(m) for m in merges]
    vocab = byte_chars + [c + "</w>" for c in byte_chars] + merged
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "vocab.json").write_text(json.dumps(
        {tok: i for i, tok in enumerate(vocab)}))
    (hf / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    gz = tmp_path / "bpe_simple_vocab.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("\"bpe\"\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return str(hf), str(gz)


BPE_PROMPTS = ["Hello a photo", "hello, hello!!  photo 2024 it's",
               "a photo of a nude person", "naïve"]


@pytest.mark.parametrize("layout", ["hf", "gzip"])
def test_bpe_tier_matches_jax(tmp_path, layout):
    path = _tiny_bpe(tmp_path)[layout == "gzip"]
    got, want = TC.CLIPBPETokenizer(path), JC.CLIPBPETokenizer(path)
    for p in BPE_PROMPTS:
        assert got.encode(p) == want.encode(p)
    np.testing.assert_array_equal(got(BPE_PROMPTS, 16), want(BPE_PROMPTS, 16))
    # the merges are used: "hello" is one piece
    assert len(got.encode("hello")) == 1


def test_tier_resolution_matches_jax(tmp_path, monkeypatch):
    hf, _ = _tiny_bpe(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (TC, JC):
        mod._resolve_tokenizer.cache_clear()
    try:
        monkeypatch.setenv("UURG_CLIP_BPE", hf)
        assert TC.active_tokenizer() == JC.active_tokenizer() \
            == f"clip-bpe:{hf}"
        np.testing.assert_array_equal(TC.tokenize(BPE_PROMPTS, 12),
                                      JC.tokenize(BPE_PROMPTS, 12))
    finally:
        for mod in (TC, JC):
            mod._resolve_tokenizer.cache_clear()


@pytest.mark.parametrize("vocab,bos,eos,tier", [
    (49408, 49406, 49407, "hf-clip"),
    # a cached tokenizer that is not CLIP's (every prompt the same ids on
    # one machine) falls through to the crc32 tier
    (3, 0, 2, "crc32-fallback"),
])
def test_the_transformers_tier_must_be_clips_vocabulary(tmp_path, monkeypatch,
                                                        vocab, bos, eos,
                                                        tier):
    import sys
    import types

    class FakeTokenizer:
        bos_token_id, eos_token_id = bos, eos

        @classmethod
        def from_pretrained(cls, name, local_files_only):
            assert name == "openai/clip-vit-large-patch14"
            assert local_files_only
            return cls()

        def __len__(self):
            return vocab

        def __call__(self, prompts, **kw):
            return {"input_ids": np.full((len(prompts), kw["max_length"]),
                                         7)}

    monkeypatch.setenv("HOME", str(tmp_path))           # no BPE files
    monkeypatch.delenv("UURG_CLIP_BPE", raising=False)
    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(CLIPTokenizer=FakeTokenizer))
    TC._resolve_tokenizer.cache_clear()
    try:
        assert TC.active_tokenizer() == tier
        ids = TC.tokenize(["a", "b c"], 8)
        if tier == "hf-clip":
            assert (ids == 7).all() and ids.dtype == np.int32
        else:
            np.testing.assert_array_equal(ids, TC.hash_tokenize(["a", "b c"],
                                                                8))
    finally:
        TC._resolve_tokenizer.cache_clear()
