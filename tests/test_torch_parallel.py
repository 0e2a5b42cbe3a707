"""``uurg_torch.parallel`` without ranks (CPU): the mesh spec and the FSDP
rule against the JAX package's, the parameters FSDP shards in the tiny
CondUNet, a depth-2 DiT-S/2 and SD's TINY_UNET against JAX's choice,
``make_mesh``'s rules on a one-rank gloo group, the random draws under a
batch split against the one-device draw, the refusal of an unknown mode
and of a mesh without the ``stage`` or ``seq`` axis, and ``spawn``'s time
limit (tensor parallel's rules and placement:
``tests/test_torch_parallel_tp*``). The two- and four-rank runs are in
``tests/test_torch_parallel_*.py``."""
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_ranks as PR  # noqa: E402
from tests.test_torch_sd_unet import TINY as SD_TINY  # noqa: E402
from tests.test_torch_sd_unet import jax_unet_params  # noqa: E402
from uurg_torch.core import rng as TRng  # noqa: E402
from uurg_torch.core.device import refuse_multi_device, resolve_device  # noqa: E402
from uurg_torch.io import jax_interop as JI  # noqa: E402
from uurg_torch.models import layers as TLay  # noqa: E402
from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from uurg_torch.models.unet_cond import CondUNet, UNetConfig  # noqa: E402
from uurg_torch.parallel import dist as D  # noqa: E402
from uurg_torch.parallel import mesh as M  # noqa: E402
from uurg_tpu.models import dit as JD  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402
from uurg_tpu.parallel import mesh as JM  # noqa: E402


@pytest.fixture
def one_rank():
    with PR.one_rank_group():
        yield


@pytest.mark.parametrize("spec", ["data=4,model=2", "data=-1", " data = 2 ,",
                                  "data", "", "=2"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = JM.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            M.parse_mesh_spec(spec)
        return
    assert M.parse_mesh_spec(spec) == want


@pytest.mark.parametrize("shape,size,min_size", [
    ((8,), 2, 4), ((3, 128), 2, 4), ((3,), 2, 1024), ((5, 7), 2, 1),
    ((128, 64, 3, 3), 4, 2**14), ((), 2, 1), ((6, 4), 3, 1)])
def test_fsdp_spec_matches_jax(shape, size, min_size):
    want = JM.fsdp_spec(shape, "model", size, min_size)
    got = M.fsdp_spec(shape, size, min_size)
    assert got == next((i for i, a in enumerate(want) if a == "model"), None)


def _local_counts_jax(params, size, min_size, to_torch, *args):
    """JAX's FSDP choice as {port name: elements a rank holds}: each leaf
    filled with its local count, carried through the interop map."""
    mesh = JM.make_mesh({"model": size}, devices=jax.devices()[:size])
    specs = JM.fsdp_param_specs(params, mesh, min_size=min_size)

    def count(p, spec):
        sharded = any(a == "model" for a in spec)
        n = int(np.prod(p.shape)) // (size if sharded else 1)
        return np.full(p.shape, n, np.float32)

    filled = jax.tree_util.tree_map(count, params, specs,
                                    is_leaf=lambda x: hasattr(x, "shape"))
    return {k: int(v.reshape(-1)[0]) for k, v in
            to_torch(filled, *args).items()}


def _local_counts_port(model, size, min_size):
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(size,))
    specs = M.fsdp_param_specs(model, mesh, min_size=min_size)
    return {n: p.numel() // (size if specs[n] is not None else 1)
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("min_size", [64, 2**14])
def test_fsdp_param_specs_match_jax(min_size):
    """The same parameters sharded, to the same elements a rank, in the
    three models (layouts differ: (in, out) kernels against (out, in)
    weights, HWIO against OIHW). JAX's DiT keeps its blocks apart here
    (``scan_blocks=False``): a depth-stacked leaf counts the depth axis."""
    cases = []
    _, params = JU.init_unet(jax.random.key(0),
                             JU.UNetConfig(dtype=jnp.float32, **PR.TINY_UNET))
    cases.append((CondUNet(UNetConfig(dtype=torch.float32, **PR.TINY_UNET)),
                  params, JI.jax_unet_params_to_torch, ()))
    dit = PR.dit_workload().init_params(0)
    jcfg = JD.DiTConfig(input_size=8, patch_size=2, in_channels=4,
                        hidden_size=384, depth=2, num_heads=6,
                        num_classes=10, scan_blocks=False)
    cases.append((dit, JD.init_dit(jax.random.key(0), jcfg)[1],
                  JI.jax_dit_params_to_torch, (2,)))
    cases.append((SDUNet(SDUNetConfig(**SD_TINY)), jax_unet_params(SD_TINY),
                  JI.jax_sd_unet_params_to_torch, ()))
    for model, params, to_torch, args in cases:
        for size in (2, 4):
            want = _local_counts_jax(params, size, min_size, to_torch, *args)
            got = _local_counts_port(model, size, min_size)
            assert got == want, type(model).__name__
    # the blocks FSDP2 wraps on their own: the UNet's residual and attention
    # blocks, DiT's blocks; SD's UNet names its own (fsdp_units): every
    # transformer block and each residual block's convolutions, no residual
    # block or spatial transformer whole (their inputs feed skip paths)
    units = {type(b).__name__ for b in M._blocks(cases[0][0])}
    assert {"ResnetBlockDDPM", "SelfAttention2D"} <= units
    assert [type(b).__name__ for b in M._blocks(dit)] == ["DiTBlock"] * 2
    sd = cases[2][0]
    units = M._blocks(sd)
    assert units == sd.fsdp_units()
    kinds = [type(b).__name__ for b in sd.modules()]
    assert sum(type(b).__name__ == "BasicTransformerBlock"
               for b in units) == kinds.count("BasicTransformerBlock") > 0
    res = [m for m in sd.modules() if type(m).__name__ == "SDResBlock"]
    assert all(m.conv1 in units and m.conv2 in units for m in res)
    assert not {"SDResBlock", "SpatialTransformer", "SDUNet"} & {
        type(b).__name__ for b in units}
    unit_params = sum(p.numel() for b in units for p in b.parameters())
    assert unit_params > 0.9 * sum(p.numel() for p in sd.parameters())


def test_make_mesh_rules_on_one_rank(one_rank):
    mesh = M.make_mesh({"data": -1})
    assert M.mesh_shape(mesh) == {"data": 1}
    mesh = M.make_mesh({"data": 1, "model": -1})
    assert mesh.mesh_dim_names == ("data", "model")
    assert M.mesh_shape(M.make_mesh()) == {"data": 1}
    with pytest.raises(ValueError, match=r"need 2 ranks, only 1"):
        M.make_mesh({"data": 2})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        M.make_mesh({"model": 1})
    # a one-rank mesh resolves fsdp over its axis, but shards nothing
    # without the named axis (no axis larger than 1)
    assert M._resolve_axis(mesh, "model") == "model"
    assert M._resolve_axis(M.make_mesh({"data": 1}), "model") is None
    split = M._split_of(M.make_mesh({"data": 1}))
    assert (split.index, split.count) == (0, 1)
    # the default device under a group is this rank's card: never the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert (D.rank(), D.world_size()) == (0, 1)


def test_rank_helpers_without_a_group():
    assert not D.is_initialized()
    assert (D.rank(), D.world_size()) == (0, 1)
    assert D.initialize_distributed() is False
    D.sync_global_devices("nothing to wait for")
    lin = torch.nn.Linear(2, 2)
    before = lin.weight.detach().clone()
    assert M.replicate(lin) is lin and torch.equal(lin.weight, before)


class _FakeMesh:
    """A ``data`` axis of ``count`` ranks seen from rank ``index``, with no
    group (the draws need none)."""

    mesh_dim_names = ("data",)

    def __init__(self, index, count):
        self.index, self.shape = index, (count,)

    def get_local_rank(self, axis):
        return self.index

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("index", [0, 1, 2])
def test_draws_under_a_split_are_rows_of_the_one_device_draw(index):
    """Every draw of a loss, a sampler or dropout, made under a split, is
    the split's rows of the same draw on one device."""
    def draws(n):
        g = torch.Generator().manual_seed(5)
        x = torch.ones(12 // n, 2, 3, 4).to(memory_format=torch.channels_last)
        return [TRng.antithetic_timesteps(g, 12 // n, 1000),
                TRng.cond_keep_mask(g, 12 // n, 0.3),
                TRng.randn_rows((12 // n, 5), g),
                TRng.randint_rows(7, 12 // n, g),
                TLay.dropout(x, 0.5, g)]

    want = draws(1)
    with M.split_batches(_FakeMesh(index, 3)) as split:
        assert (split.index, split.count) == (index, 3)
        got = draws(3)
    assert M.batch_split().count == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w[4 * index:4 * (index + 1)])
    with M.split_batches(_FakeMesh(0, 5)):
        with pytest.raises(ValueError, match="does not split over 5"):
            M.local_rows(torch.zeros(12))
    batch = (np.arange(12), (torch.arange(24).reshape(12, 2),))
    rows = M.shard_batch(batch, _FakeMesh(index, 3))
    assert rows[0].tolist() == list(range(4 * index, 4 * index + 4))
    assert torch.equal(rows[1][0], batch[1][0][4 * index:4 * index + 4])
    stack = torch.arange(24).reshape(2, 12)     # [grad_accum, B]
    cut = M.shard_batch((stack,), _FakeMesh(index, 3), batch_dim=1)[0]
    assert torch.equal(cut, stack[:, 4 * index:4 * index + 4])
    assert M.shard_batch(batch, None)[0].tolist() == list(range(12))


def test_spawn_kills_ranks_that_wait_for_ever(tmp_path):
    """A deadlocked group fails its own test within the time limit, naming
    the function, instead of hanging the suite."""
    import time

    start = time.monotonic()
    with pytest.raises(TimeoutError, match="wait_for_ever on 2 ranks"):
        PR.spawn("wait_for_ever", 2, tmp_path, timeout=5)
    assert time.monotonic() - start < 60


@pytest.mark.parametrize("parallelism", ["pp", "sp"])
def test_refuse_multi_device_passes_pp_and_sp(parallelism):
    # every mode of the JAX package's runners passes; the runners check
    # the mesh's axes for it
    assert refuse_multi_device(parallelism) is None


@pytest.mark.parametrize("parallelism,axes,error", [
    ("pp", {"data": 2}, "'stage' mesh axis"),
    ("sp", {"model": 2}, "'seq' mesh axis"),
    ("pp", {"data": 1, "stage": 2}, None),
    ("sp", {"data": 2, "seq": 2}, None)])
def test_pp_and_sp_need_their_mesh_axis(parallelism, axes, error):
    """JAX's ValueError for a mesh without the mode's axis."""
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 shape=tuple(axes.values()))
    if error is None:
        M.require_axis(mesh, parallelism)
    else:
        with pytest.raises(ValueError, match=error):
            M.require_axis(mesh, parallelism)


def test_dp_and_fsdp_pass_the_refusal():
    refuse_multi_device("dp")
    refuse_multi_device("fsdp")
    refuse_multi_device("tp")
    with pytest.raises(ValueError, match="unknown parallelism"):
        refuse_multi_device("zero3")
