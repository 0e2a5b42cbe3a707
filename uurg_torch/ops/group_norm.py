"""GroupNorm over NHWC activations with fp32 statistics, and its gradient.

Port of ``uurg_tpu/ops/group_norm.py``. ``group_norm`` is the dispatcher:
for a CUDA tensor it launches the hand-written kernel in
``uurg_torch/csrc/group_norm.cu`` (which replaces the Pallas
``_gn_fwd_kernel``), for a CPU tensor it runs :func:`group_norm_plain`. It
never falls back from one to the other. Both compute ``_gn_reference``:
``var = max(E[x^2] - mean^2, 0)``, ``y = x * a + b`` with
``a = rstd * scale``, ``b = bias - mean * a``, all in fp32, y in x's dtype.

The forward kernel has two routes, chosen here by shape alone
(:func:`_fwd_route`), never by a failed launch: ``slab`` holds a sample in
the shared memory of a cluster of 1, 2, 4 or 8 thread blocks and reads x
from device memory once; ``split`` (a sample too large for that, or a
single pixel) cuts each sample into S runs of pixels, one a block, with S
from the batch and the sample's bytes (:func:`_split_count`), and reads x
twice in two launches: partial sums into an fp32 scratch that the wrapper
allocates, then the statistics and y.

When a gradient is wanted the op goes through one
``torch.autograd.Function``. It saves x, scale and the forward's (B, G)
mean and rstd, and its backward is :func:`group_norm_bwd`: the backward
kernel of the same source (which replaces the Pallas ``_gn_bwd_kernel``)
for a CUDA tensor, :func:`group_norm_bwd_plain` for a CPU tensor. The
backward has the same two routes (:func:`_bwd_route`): ``slab`` (which
holds x and g, so twice the forward's bytes; one launch) and ``split`` (S
runs a sample, S from the batch and the sample's pixels,
:func:`_bwd_split_count`; x and g read twice in two launches: each run's
channel and group sums into an fp32 scratch that the wrapper allocates,
then dx), and folds dscale and dbias over the batch in the launch that
writes dx.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from uurg_torch.ops import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_CHUNK_BYTES = 16
_MAX_CHUNKS = 512   # C / (16 / itemsize): one thread per 16-byte column chunk
# route codes of the C launchers, forward and backward
_ROUTE_CODE = {"split": 0, "slab": 1}
_CLUSTERS = (1, 2, 4, 8)     # 8: the largest cluster every launch may ask for
_SMEM_MAX = 226 * 1024       # a block's 227 KB on sm_90 less the kernel's static part
_SLAB_THREADS = 256          # kSlabThreads of csrc/group_norm.cu
_SMS = 132                   # an H100's SMs
# the split route's runs a sample: B S near four blocks an SM, at most two
# an SM's worth a sample (every block of the normalise launch folds its
# sample's S rows), at least _SPLIT_MIN_BYTES of the sample a run (two
# 16-byte loads a thread) and at least a pixel
_SPLIT_BLOCKS, _SPLIT_MAX, _SPLIT_MIN_BYTES = 4 * _SMS, 2 * _SMS, 8192
# the backward's split route: B S near _BWD_SPLIT_BLOCKS, two blocks an SM
# (every block of its dx launch folds its sample's S group rows, so runs
# past that cost more than they fill: on an H100, SD's 64 x 64 sites at
# batch 4 took 1.4 to 2.0 times as long at four blocks an SM), and a run of
# at least _BWD_MIN_PIXELS pixels, so that its channel sums (2 C fp32
# written by the sums launch and read by the dx launch) stay a small share
# of its x and g (a tenth in bf16)
_BWD_SPLIT_BLOCKS, _BWD_MIN_PIXELS = 2 * _SMS, 16
# the backward's batch fold: groups of at least _FOLD_ROWS samples, at most
# _FOLD_GROUPS groups, so 1 + _FOLD_GROUPS arrival counters serve any batch
_FOLD_ROWS, _FOLD_GROUPS = 16, 64


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, return_stats: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xr = x.reshape(b, -1, groups, cg).float()
    mean = xr.mean(dim=(1, 3), keepdim=True)
    mean2 = xr.square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + eps)
    a = rstd * scale.float().reshape(1, 1, groups, cg)
    bterm = bias.float().reshape(1, 1, groups, cg) - mean * a
    y = (xr * a + bterm).reshape(x.shape).to(x.dtype)
    if return_stats:
        return y, mean.reshape(b, groups), rstd.reshape(b, groups)
    return y


def group_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         g: torch.Tensor):
    """Plain version of the Pallas ``_gn_bwd_kernel``'s analytic formula
    (not autograd of :func:`group_norm_plain`): with x_hat = (x - mean) rstd
    and gs = g scale, ``dx = (gs - mean_group(gs) - x_hat
    mean_group(gs x_hat)) rstd`` in x's dtype, ``dscale = sum g x_hat`` and
    ``dbias = sum g`` over batch and space, fp32. The groups are those of
    the (B, G) statistics."""
    b, c = x.shape[0], x.shape[-1]
    groups = mean.shape[1]
    cg = c // groups
    xr = x.reshape(b, -1, groups, cg).float()
    gr = g.reshape(b, -1, groups, cg).float()
    rstd_r = rstd.reshape(b, 1, groups, 1)
    xhat = (xr - mean.reshape(b, 1, groups, 1)) * rstd_r
    dbias = gr.sum(dim=(0, 1)).reshape(c)
    dscale = (gr * xhat).sum(dim=(0, 1)).reshape(c)
    gs = gr * scale.float().reshape(1, 1, groups, cg)
    n = xr.shape[1] * cg
    s1 = gs.sum(dim=(1, 3), keepdim=True) / n
    s2 = (gs * xhat).sum(dim=(1, 3), keepdim=True) / n
    dx = ((gs - s1 - xhat * s2) * rstd_r).reshape(x.shape).to(x.dtype)
    return dx, dscale, dbias


def _check(x, scale, bias, groups):
    if x.ndim != 4:
        raise ValueError(f"group_norm wants NHWC x, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must have shape ({c},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels-last NCHW "
                         "permuted to NHWC)")
    if not (x.device == scale.device == bias.device):
        raise ValueError("x, scale and bias must be on one device")
    if c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")


def _check_kernel(x):
    """The constraints of both kernels on a CUDA x."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the GroupNorm kernels take bfloat16 or float32, "
                        f"not {x.dtype}")
    c = x.shape[-1]
    per_chunk = _CHUNK_BYTES // x.element_size()
    if c % per_chunk != 0 or c // per_chunk > _MAX_CHUNKS:
        raise ValueError(f"the GroupNorm kernels need C a multiple of "
                         f"{per_chunk} and at most {per_chunk * _MAX_CHUNKS}, "
                         f"got {c}")
    if x.data_ptr() % _CHUNK_BYTES:
        raise ValueError("the GroupNorm kernels need 16-byte aligned tensors")


def _slab_rows(hw: int, c: int, itemsize: int, s: int) -> int:
    """Thread rows of a slab block (kSlabThreads over the 16-byte chunks of
    a pixel, at most the slice's pixels)."""
    return max(1, min(_SLAB_THREADS // (c * itemsize // _CHUNK_BYTES),
                      -(-hw // s)))


def _slab_smem(hw: int, c: int, itemsize: int, groups: int, s: int) -> int:
    """Dynamic shared memory of one block of the forward's slab route, as
    the C launcher reckons it: the slice, the [2][rows][C] scratch,
    per-channel and per-group sums, statistics, and the cluster's
    [S][2][G] partials."""
    rows = _slab_rows(hw, c, itemsize, s)
    floats = 2 * rows * c + 2 * c + 4 * groups + (2 * groups * s if s > 1 else 0)
    return -(-hw // s) * c * itemsize + 4 * floats


def _bwd_slab_smem(hw: int, c: int, itemsize: int, groups: int, s: int) -> int:
    """The same for the backward's slab route: slices of x and of g, the
    [2][rows][C] scratch, per-channel and per-group sums, and with a cluster
    its [S][2][G] group sums and [S][2][ceil(C / S)] channel sums."""
    rows = _slab_rows(hw, c, itemsize, s)
    floats = 2 * rows * c + 2 * c + 2 * groups
    if s > 1:
        floats += 2 * groups * s + 2 * -(-c // s) * s
    return 2 * -(-hw // s) * c * itemsize + 4 * floats


def _slab_cluster(smem, hw: int, c: int, itemsize: int, groups: int):
    """The smallest cluster S whose slab block (a slice of ``ceil(hw / S)``
    whole pixels and the scratch, ``smem`` bytes) fits shared memory, else
    None. A cluster never has as many blocks as the sample has pixels (a
    one-pixel sample has nothing to hold), and a pixel must be whole 16-byte
    chunks for the bulk copy."""
    if c * itemsize % _CHUNK_BYTES == 0:
        for s in _CLUSTERS:
            if s < hw and smem(hw, c, itemsize, groups, s) <= _SMEM_MAX:
                return s
    return None


def _split_count(batch: int, hw: int, c: int, itemsize: int) -> int:
    """Runs a sample (S) of the forward's split route: ``_SPLIT_BLOCKS``
    blocks in all, at most ``_SPLIT_MAX`` a sample, at most one a
    ``_SPLIT_MIN_BYTES`` of the sample and one a pixel; at least 1. A pure
    function of the shape, so a shape's bits repeat from run to run."""
    want = -(-_SPLIT_BLOCKS // batch)
    return max(1, min(want, _SPLIT_MAX, hw,
                      hw * c * itemsize // _SPLIT_MIN_BYTES))


def _split_scratch(batch: int, s: int, groups: int) -> int:
    """fp32 floats of the split route's partial sums, part[B][S][2][G]."""
    return batch * s * 2 * groups


def _bwd_split_count(batch: int, hw: int, c: int, itemsize: int) -> int:
    """Runs a sample (S) of the backward's split route:
    ``_BWD_SPLIT_BLOCKS`` blocks in all, at most one a ``_BWD_MIN_PIXELS``
    pixels and one a ``_SPLIT_MIN_BYTES`` of the sample; at least 1. A pure
    function of the shape."""
    want = -(-_BWD_SPLIT_BLOCKS // batch)
    return max(1, min(want, hw // _BWD_MIN_PIXELS,
                      hw * c * itemsize // _SPLIT_MIN_BYTES))


def _bwd_split_scratch(batch: int, s: int, c: int, groups: int) -> int:
    """fp32 floats of the backward's split scratch: each run's channel sums
    chs[B][S][2][C], then its group sums grps[B][S][2][G]."""
    return batch * s * 2 * (c + groups)


@functools.lru_cache(maxsize=None)
def _fwd_route(hw: int, c: int, itemsize: int, groups: int = 32,
               batch: int = 1):
    """(route, blocks a sample) of the forward kernel for ``batch`` samples
    of ``hw`` pixels of ``c`` channels: ``("slab", S)`` with the smallest
    cluster that fits (:func:`_slab_cluster`, whatever the batch), else
    ``("split", S)`` with S runs a sample (:func:`_split_count`)."""
    s = _slab_cluster(_slab_smem, hw, c, itemsize, groups)
    if s is not None:
        return "slab", s
    return "split", _split_count(batch, hw, c, itemsize)


@functools.lru_cache(maxsize=None)
def _bwd_route(hw: int, c: int, itemsize: int, groups: int = 32,
               batch: int = 1):
    """(route, blocks a sample) of the backward kernel: ``("slab", S)`` as
    the forward's, but the slab holds x and g, so S is the forward's doubled
    where the forward's slice was the limit (whatever the batch); else
    ``("split", S)`` with S runs a sample (:func:`_bwd_split_count`)."""
    s = _slab_cluster(_bwd_slab_smem, hw, c, itemsize, groups)
    if s is not None:
        return "slab", s
    return "split", _bwd_split_count(batch, hw, c, itemsize)


def _fold_rows(b: int) -> int:
    """Samples a group of the backward's batch fold: ``_FOLD_ROWS``, or
    more where the batch would need more than ``_FOLD_GROUPS`` groups."""
    return max(_FOLD_ROWS, -(-b // _FOLD_GROUPS))


@functools.lru_cache(maxsize=None)
def _load(symbol: str, n_ptr: int, ints: tuple):
    """``symbol`` of the built source: ``n_ptr`` pointers, then ``ints``
    (ctypes types), then the stream."""
    return _build.function(
        "group_norm", symbol,
        [ctypes.c_void_p] * n_ptr + list(ints) + [ctypes.c_void_p])


_I, _F = ctypes.c_int, ctypes.c_float
_FWD_INTS = (_I,) * 4 + (_F,) + (_I,) * 3   # B, HW, C, G, eps, dtype, route, S
_BWD_INTS = (_I,) * 8   # B, HW, C, G, fold, dtype, route, S
_fold_counters: dict = {}


def _group_norm_kernel(x, scale, bias, groups, eps, route=None):
    """Launch the forward kernel: (y, mean, rstd). ``route`` overrides
    :func:`_fwd_route` (to time one route beside the other). One fp32
    allocation holds mean, rstd (returned as views of it) and, on the split
    route, its partial sums: every call has its own, so calls captured in
    one CUDA graph share no scratch."""
    _check_kernel(x)
    b, h, w, c = x.shape
    name, cluster = route or _fwd_route(h * w, c, x.element_size(), groups,
                                        b)
    y = torch.empty_like(x)
    stats = 2 * b * groups
    work = torch.empty(stats + (_split_scratch(b, cluster, groups)
                                if name == "split" else 0),
                       dtype=torch.float32, device=x.device)
    if not scale.is_contiguous():
        scale = scale.contiguous()
    if not bias.is_contiguous():
        bias = bias.contiguous()
    err = _load("uurg_group_norm_fwd", 7, _FWD_INTS)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        work.data_ptr(), work.data_ptr() + 4 * b * groups,
        work.data_ptr() + 4 * stats, b, h * w, c, groups, eps,
        _DTYPE_CODE[x.dtype], _ROUTE_CODE[name], cluster,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GroupNorm kernel launch failed ({name} route, "
                           f"{cluster} blocks a sample): CUDA error {err}")
    group_norm.launches += 1
    mean, rstd = work[:stats].view(2, b, groups).unbind(0)
    return y, mean, rstd


def group_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor):
    """(dx, dscale, dbias) of GroupNorm at x for the output gradient g,
    from the forward's fp32 (B, G) mean and rstd. g must match x in shape,
    dtype, device and contiguity. CPU tensors: :func:`group_norm_bwd_plain`;
    CUDA tensors: the backward kernel (two launches on the split route,
    one on the slab route; ``group_norm_bwd.launches`` counts calls)."""
    b = x.shape[0]
    groups = mean.shape[-1]
    _check(x, scale, scale, groups)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError("g must be a contiguous NHWC tensor of x's shape, "
                         "dtype and device")
    for t in (mean, rstd):
        if t.shape != (b, groups) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("mean and rstd must be the forward's contiguous "
                             "fp32 (B, G) statistics")
    if x.device.type == "cpu":
        return group_norm_bwd_plain(x, scale, mean, rstd, g)
    return _group_norm_bwd_kernel(x, scale, mean, rstd, g)


def _group_norm_bwd_kernel(x, scale, mean, rstd, g, route=None):
    """Launch the backward kernel on checked inputs: (dx, dscale, dbias).
    ``route`` overrides :func:`_bwd_route` (to time one route beside the
    other). One fp32 allocation holds dscale, dbias (returned as views of
    it), the batch fold's scratch and, on the split route, the runs' sums:
    every call has its own, so calls captured in one CUDA graph share none.
    The fold's arrival counters are one zeroed buffer a device, which every
    launch leaves zero, so launches that share it must run one at a time
    (one stream)."""
    _check_kernel(x)
    b, h, w, c = x.shape
    groups = mean.shape[-1]
    name, cluster = route or _bwd_route(h * w, c, x.element_size(), groups,
                                        b)
    fold = _fold_rows(b)
    counters = _fold_counters.get(x.device)
    if counters is None:
        counters = _fold_counters[x.device] = torch.zeros(
            1 + _FOLD_GROUPS, dtype=torch.int32, device=x.device)
    dx = torch.empty_like(x)
    fold_floats = (2 + 2 * b + 2 * -(-b // fold)) * c
    work = torch.empty(fold_floats + (_bwd_split_scratch(b, cluster, c, groups)
                                      if name == "split" else 0),
                       dtype=torch.float32, device=x.device)
    if not scale.is_contiguous():
        scale = scale.contiguous()
    err = _load("uurg_group_norm_bwd", 9, _BWD_INTS)(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), work.data_ptr(), counters.data_ptr(),
        work.data_ptr() + 4 * fold_floats, b, h * w, c, groups, fold,
        _DTYPE_CODE[x.dtype], _ROUTE_CODE[name], cluster,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GroupNorm backward kernel launch failed ({name} "
                           f"route, {cluster} blocks a sample): CUDA error "
                           f"{err}")
    group_norm_bwd.launches += 1
    return dx, work[:c], work[c:2 * c]


class _GroupNorm(torch.autograd.Function):
    """The op with a gradient: the kernels on CUDA, the plain versions on
    the CPU (the same saved tensors either way). mean and rstd are outputs
    without a gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        if x.device.type == "cpu":
            y, mean, rstd = group_norm_plain(x, scale, bias, groups, eps, True)
        else:
            y, mean, rstd = _group_norm_kernel(x, scale, bias, groups, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, gy, _gmean, _grstd):
        x, scale, mean, rstd = ctx.saved_tensors
        # the gradient may arrive in any stride order (the convolution's
        # backward); the kernel takes contiguous NHWC
        if not gy.is_contiguous():
            gy = gy.contiguous()
        dx, dscale, dbias = group_norm_bwd(x, scale, mean, rstd, gy)
        return dx, dscale, dbias, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               groups: int = 32, eps: float = 1e-6,
               return_stats: bool = False):
    """GroupNorm over the channel axis of contiguous NHWC ``x``.

    Returns y, or ``(y, mean, rstd)`` with (B, G) fp32 statistics when
    ``return_stats``. The group count is halved until it divides C, as the
    JAX dispatcher does for narrow test configs. Differentiable in x, scale
    and bias when grad mode is on and one of them requires grad; otherwise
    (sampling, ``torch.inference_mode``) one call of the forward kernel
    (two launches on the split route; ``group_norm.launches`` counts
    calls)."""
    c = x.shape[-1]
    while c % groups != 0:
        groups //= 2
    _check(x, scale, bias, groups)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        out = _GroupNorm.apply(x, scale, bias, groups, eps)
    elif x.device.type == "cpu":
        out = group_norm_plain(x, scale, bias, groups, eps, True)
    else:
        out = _group_norm_kernel(x, scale, bias, groups, eps)
    return out if return_stats else out[0]


group_norm.launches = 0
group_norm_bwd.launches = 0
