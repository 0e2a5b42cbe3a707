"""uurg_torch kernels on the card against their plain versions (bf16).

Marked ``cuda``: each test skips without a CUDA device. On a GPU machine:
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
"""
import pytest

torch = pytest.importorskip("torch")

from uurg_torch.ops.flash_attention import attention, attention_plain  # noqa: E402
from uurg_torch.ops.group_norm import group_norm, group_norm_plain  # noqa: E402

pytestmark = pytest.mark.cuda

# both sides round their output to bf16 after fp32 arithmetic in another
# order: one to two output roundings (relative 2**-8 each)
ATOL, RTOL = 1e-2, 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("T,D", [(16, 256), (256, 256), (100, 64), (77, 40)])
def test_attention_kernel_matches_plain(gen, T, D):
    q, k, v = (torch.randn(4, 2, T, D, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = attention.launches
    got = attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,C", [(32, 128), (16, 384), (4, 512), (8, 24)])
def test_group_norm_kernel_matches_plain(gen, dtype, H, C):
    x = (torch.randn(3, H, H, C, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    bias = torch.randn(C, generator=gen, device="cuda") * 0.2
    got, mean, rstd = group_norm(x, scale, bias, return_stats=True)
    torch.cuda.synchronize()
    groups = mean.shape[1]
    want, mean_p, rstd_p = group_norm_plain(x, scale, bias, groups, 1e-6, True)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.bfloat16 else \
        dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(mean, mean_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_p, atol=1e-4, rtol=1e-4)
