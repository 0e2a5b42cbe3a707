"""The attention at padded head widths 320-512 (the ``xwide`` kernels, both
dtypes, forward and backward) on the CPU: the port's plain versions against
the JAX package's Pallas pair in interpret mode at widths 320 and 512, the
dispatcher's routes and refusals, the CPU dispatcher's gradients, a model
of the bf16 forward kernel's arithmetic (its key tiles, the online softmax,
P rounded unnormalised) against the plain version, the Pallas kernel and
``torch.logsumexp``, the bf16 forward's binding to its own source, a model
of the backward kernels' arithmetic (P from the log-sum-exp, delta from
dO o, their tiles and order of sums, the dS scratch, bf16 roundings)
against the plain version, the float32 kernels' TF32 split, and the wide
CondUNet's parameter count. The kernels themselves are held on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s width phase)."""
import ctypes
import math
import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from uurg_torch.core.config import load_config  # noqa: E402
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_torch.ops import _build  # noqa: E402
from uurg_torch.ops import flash_attention as FA  # noqa: E402
from uurg_tpu.ops.flash_attention import fused_attention  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32: the same arithmetic in another order (relative L2 of the output,
# and of each gradient, whose dS = P (dP - delta) cancels where dP is close
# to delta). bfloat16: both sides round P (normalised) to bf16 before P V,
# dS and P before the gradients' products, and each output once (2**-8 of
# relative step); the sums over T differ in order and in where they round
REL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(T, D, seed, B=2, H=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D), dtype=np.float32)
            for _ in range(4)]


def _f32(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [320, 512])
def test_plain_matches_pallas_interpret(D, dtype):
    """The plain versions against ``fused_attention(..., interpret=True)``
    and its gradients, on the same bf16- or fp32-valued inputs."""
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs(64, D, D))
    jq, jk, jv, jg = (jnp.asarray(_f32(t)).astype(JNP[dtype])
                      for t in (q, k, v, g))
    import jax
    want, vjp = jax.vjp(lambda a, b, c: fused_attention(a, b, c, 64, True),
                        jq, jk, jv)
    want_grads = vjp(jg)
    fwd_tol, bwd_tol = REL[dtype]
    got = FA.attention_plain(q, k, v)
    assert got.dtype == dtype
    assert _rel(_f32(got), np.asarray(want, np.float32)) <= fwd_tol
    for name, a, b in zip("qkv", FA.attention_bwd_plain(q, k, v, g),
                          want_grads):
        assert a.dtype == dtype, name
        assert _rel(_f32(a), np.asarray(b, np.float32)) <= bwd_tol, name


@pytest.mark.parametrize("D,Dp", [(320, 320), (300, 320), (384, 384),
                                  (448, 448), (512, 512), (260, 320)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_widths_320_to_512_take_the_xwide_route(dtype, D, Dp):
    q = torch.empty(1, 1, 4, D, dtype=dtype)
    assert FA._kernel_width(q) == Dp
    assert FA._xwide_bf16(q) == (dtype == torch.bfloat16)
    assert FA._f32_plan(2, 1, 100, D) == ("xwide", None)
    assert FA._f32_plan(2, 1, 100, D, backward=True) == ("xwide", None)


def test_bf16_tma_plan_keeps_to_256_and_widths_to_512():
    # the TMA bf16 kernels' plan takes up to 256; wider bf16 heads take the
    # xwide kernels, and above 512 both dtypes raise naming ROADMAP.md
    ts = [torch.empty(1, 1, 4, 256, dtype=torch.bfloat16) for _ in range(3)]
    assert FA._bf16_plan(*ts).Dp == 256
    assert not FA._xwide_bf16(ts[0])
    with pytest.raises(ValueError, match="xwide"):
        FA._bf16_plan(*(torch.empty(1, 1, 4, 320, dtype=torch.bfloat16)
                        for _ in range(3)))
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            FA._kernel_width(torch.empty(1, 1, 4, 513, dtype=dtype))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        FA._f32_plan(1, 1, 16, 640, backward=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatcher_at_width_512_is_the_plain_pair(dtype):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs(16, 512, 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (FA.attention.launches_xwide, FA.attention_bwd.launches_xwide,
                FA.attention.launches_f32, FA.attention_bwd.launches_f32)
    out = FA.attention(*leaves)
    out.backward(g)
    assert (FA.attention.launches_xwide, FA.attention_bwd.launches_xwide,
            FA.attention.launches_f32,
            FA.attention_bwd.launches_f32) == counters
    assert torch.equal(out.detach(), FA.attention_plain(q, k, v))
    for t, w in zip(leaves, FA.attention_bwd_plain(q, k, v, g)):
        assert torch.equal(t.grad, w)


def _round(x, dtype):
    return x.to(dtype).float()


# the bf16 forward kernel's key tile (csrc/flash_attention_xwide_fwd.cu's
# kBK): the online softmax takes the keys in tiles of it
XF_KEYS = 64
_XF_SOURCE = os.path.join(ROOT, "uurg_torch", "csrc",
                          "flash_attention_xwide_fwd.cu")


def _xwide_fwd_model(q, k, v, keys: int = XF_KEYS):
    """What the bf16 xwide forward kernel computes, in torch on its tiles:
    per key tile of ``keys`` in order, fp32 scores scaled by scale * log2 e,
    the running max and the rescale of O and of the row sum, P = 2^(s - m)
    rounded to bf16 unnormalised before P V (fp32 sums), the row sum from
    the unrounded P; O divided by the row sum and rounded once. Returns
    (o in q's dtype, the natural log-sum-exp fp32 (B*H, T)). Keys past T
    are absent (the kernel's -inf adds nothing)."""
    T, D = q.shape[-2:]
    scale_log2 = D ** -0.5 * math.log2(math.e)
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(q.shape[:-1] + (1,))
    o = torch.zeros(qf.shape)
    for k0 in range(0, T, keys):
        ks = slice(k0, k0 + keys)
        s = qf @ kf[..., ks, :].transpose(-1, -2) * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _round(p, q.dtype) @ vf[..., ks, :]
        m = m_new
    lse = (m + torch.log2(l)) * math.log(2.0)
    return (o / l).to(q.dtype), lse.reshape(-1, T)


@pytest.mark.parametrize("T", [16, 33, 64, 100, 130, 256])
@pytest.mark.parametrize("D", [320, 384, 448, 512])
def test_forward_kernel_arithmetic_matches_plain(D, T):
    # T below a key tile (16, 33), a tile exactly (64), ragged ends (100,
    # 130) and the CondUNet's 16 x 16 site (256)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(T, D, D + T)[:3])
    got, lse = _xwide_fwd_model(q, k, v)
    assert got.dtype == torch.bfloat16
    assert _rel(_f32(got), _f32(FA.attention_plain(q, k, v))) \
        <= REL[torch.bfloat16][0]
    s = q.float() @ k.float().transpose(-1, -2) * D ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(-1, T),
                               atol=chip_smoke.LSE_ATOL, rtol=0)


@pytest.mark.parametrize("D", [320, 512])
def test_forward_model_matches_pallas_interpret(D):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(100, D, D)[:3])
    want = fused_attention(*(jnp.asarray(_f32(t)).astype(jnp.bfloat16)
                             for t in (q, k, v)), 64, True)
    got = _xwide_fwd_model(q, k, v)[0]
    assert _rel(_f32(got), np.asarray(want, np.float32)) \
        <= REL[torch.bfloat16][0]


def test_forward_model_tile_is_the_sources():
    # the model's key tile is the one the kernel states
    with open(_XF_SOURCE) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kBK = (\d+);", text).group(1)) \
        == XF_KEYS


def test_bf16_forward_binds_its_own_source(monkeypatch):
    # uurg_attention_fwd_xwide_bf16 is defined in one source, its own; the
    # wrapper binds it there (five pointers, three ints, the scale, the
    # stream) and the build compiles it; flash_attention_f32.cu holds no
    # bf16 kernel
    defining = sorted(p.name for p in _build.CSRC.glob("*.cu")
                      if re.search(r'extern "C" int uurg_attention_fwd_xwide_bf16\(',
                                   p.read_text()))
    assert defining == ["flash_attention_xwide_fwd.cu"]
    assert _build.CSRC / "flash_attention_xwide_fwd.cu" in _build.sources()
    calls = []
    monkeypatch.setattr(_build, "function",
                        lambda *a: calls.append(a) or "bound")
    assert FA._fwd_xwide_bf16_fn() == "bound"
    (name, symbol, argtypes), = calls
    assert (name, symbol) == ("flash_attention_xwide_fwd",
                              "uurg_attention_fwd_xwide_bf16")
    assert argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_void_p]
    f32 = (_build.CSRC / "flash_attention_f32.cu").read_text()
    assert "__nv_bfloat16" not in f32
    assert "uurg_attention_fwd_xwide_bf16" not in f32


# the backward kernels' tiles (csrc/flash_attention_xwide_bwd.cu): a key
# pass block's keys, its query tiles, the column chunks over which the
# float32 scores are summed in the tensor cores, a dq pass tile's keys
XB_KEYS, XB_QUERIES, XB_CHUNK, XB_DQ_KEYS = 32, 64, 64, 32


def _xwide_bwd_model(q, k, v, g, keys: int = XB_KEYS,
                     queries: int = XB_QUERIES, chunk: int = XB_CHUNK,
                     dq_keys: int = XB_DQ_KEYS):
    """What the xwide backward kernels compute, in torch on their tiles:
    the forward's log-sum-exp and output (the output in the input dtype),
    delta = rowsum(dO o); the key pass per (key block, query tile): S^T and
    dP^T summed over ``chunk``-wide column chunks, a fp32 term a chunk,
    P = exp(s scale - lse), dS = P (dP - delta) scale, P and dS rounded to
    the input dtype, dK and dV of the block summed over its query tiles in
    order (a fp32 term a tile), dS stored in the input dtype; the dq pass
    per query block: dq = dS K summed over key tiles of ``dq_keys`` in
    order. Rows past T are absent (the kernels' zeros add nothing)."""
    dtype = q.dtype
    T, D = q.shape[-2:]
    scale = D ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s_full = qf @ kf.transpose(-1, -2) * scale
    lse = torch.logsumexp(s_full, -1, keepdim=True)
    o = _round(torch.softmax(s_full, -1) @ vf, dtype)
    delta = (gf * o).sum(-1, keepdim=True)
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    ds_scratch = torch.zeros(q.shape[:-1] + (T,))
    for k0 in range(0, T, keys):
        ks = slice(k0, k0 + keys)
        for q0 in range(0, T, queries):
            qs = slice(q0, q0 + queries)
            s = dp = 0
            for c0 in range(0, D, chunk):
                cs = slice(c0, c0 + chunk)
                s = s + qf[..., qs, cs] @ kf[..., ks, cs].transpose(-1, -2)
                dp = dp + gf[..., qs, cs] @ vf[..., ks, cs].transpose(-1, -2)
            p = torch.exp(s * scale - lse[..., qs, :])
            ds = _round(p * (dp - delta[..., qs, :]) * scale, dtype)
            p = _round(p, dtype)
            ds_scratch[..., qs, ks] = ds
            dv[..., ks, :] += p.transpose(-1, -2) @ gf[..., qs, :]
            dk[..., ks, :] += ds.transpose(-1, -2) @ qf[..., qs, :]
    for k0 in range(0, T, dq_keys):
        ks = slice(k0, k0 + dq_keys)
        dq += ds_scratch[..., ks] @ kf[..., ks, :]
    return tuple(t.to(dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D", [(40, 320), (16, 512), (33, 448),
                                 (64, 512), (100, 320), (130, 384)])
def test_backward_kernels_arithmetic_matches_plain(T, D, dtype):
    # T below a key block (16), a query tile exactly (64), and ragged ones
    # that end inside a key block and a query tile (33, 40, 100, 130)
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs(T, D, T))
    tol = REL[dtype][1]
    for name, a, b in zip("qkv", _xwide_bwd_model(q, k, v, g),
                          FA.attention_bwd_plain(q, k, v, g)):
        assert _rel(_f32(a), _f32(b)) < tol, name


@pytest.mark.parametrize("T", [1, 16, 32, 33, 100, 1024])
def test_backward_scratch_pads_the_keys_to_a_key_block(T):
    # the dS scratch the wrapper hands the kernels: (B*H, T, Tk), Tk the
    # key pass's blocks of XB_KEYS keys, each of which writes all its keys
    assert FA._XWIDE_KEYS == XB_KEYS
    BH, rows, Tk = FA._xwide_ds_shape(6, T)
    assert (BH, rows) == (6, T)
    assert Tk % XB_KEYS == 0 and T <= Tk < T + XB_KEYS


def _tf32_round(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (11 significant bits), ties away from zero, as
    cvt.rna.tf32.f32 rounds it, in float64 arithmetic."""
    m, e = np.frexp(x.astype(np.float64))
    return np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)


def test_tf32_split_by_add_and_mask_rounds_to_nearest():
    # the float32 kernels' split x = hi + lo: hi = (bits + 0x1000) & ~0x1fff,
    # the bits of cvt.rna.tf32.f32 for finite x, and lo = x - hi exactly
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32),
        (rng.standard_normal(1000) * 1e30).astype(np.float32),
        (rng.standard_normal(1000) * 1e-30).astype(np.float32),
        # ties in [1, 2) and (-2, -1]: bit 12 set, bits 0-11 clear
        ((rng.integers(0, 2 ** 10, 1000, dtype=np.uint32) << 13)
         | rng.choice(np.array([0, 2 ** 31], np.uint32), 1000)
         | np.uint32(0x3f801000)).view(np.float32)])
    assert np.isfinite(x).all()
    hi = ((x.view(np.uint32) + np.uint32(0x1000))
          & np.uint32(0xffffe000)).view(np.float32)
    np.testing.assert_array_equal(hi.astype(np.float64), _tf32_round(x))
    lo = x - hi
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x)
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -11)


def test_wide_condunet_parameters_counted_on_the_cpu():
    # configs/cifar10_sfron.yml at model.ch 256, as chip_smoke.py's width
    # phase builds it on the card: the count it holds that model to
    cfg = load_config(os.path.join(ROOT, "configs", "cifar10_sfron.yml"))
    cfg.model.ch = chip_smoke.WIDE_CH
    with torch.device("meta"):
        model = TU.CondUNet(TU.UNetConfig.from_config(cfg))
    assert sum(p.numel() for p in model.parameters()) == \
        chip_smoke.WIDE_PARAMS == 154_400_515
    # its attention: one head of ch * 2 = 512 at 16 x 16, and the mid site
    assert cfg.model.ch * max(cfg.model.ch_mult) == 512
    assert list(cfg.model.attn_resolutions) == [16]
