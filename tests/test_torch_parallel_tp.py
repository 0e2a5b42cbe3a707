"""Tensor parallel's rules and layout without ranks (CPU): the port's
choice for every parameter of a depth-2 DiT-S/2 and of SD's TINY UNet
against the JAX package's ``tp_param_specs``, carried through the interop
name maps; JAX's edge cases and the heads rule the port adds; the fused
pieces' round trip (qkv, adaLN, GEGLU at sizes 2 and 4); and the placement
on a one-rank gloo group, whose forward and backward give one device's
bits. The multi-rank runs are in ``tests/test_torch_parallel_tp_*.py``."""
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tests import torch_parallel_ranks as PR  # noqa: E402
from tests.test_torch_sd_unet import TINY as SD_TINY  # noqa: E402
from tests.test_torch_sd_unet import jax_unet_params  # noqa: E402
from uurg_torch.core.device import refuse_multi_device  # noqa: E402
from uurg_torch.io import jax_interop as JI  # noqa: E402
from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from uurg_torch.parallel import mesh as M  # noqa: E402
from uurg_torch.parallel import tensor as T  # noqa: E402
from uurg_tpu.models import dit as JD  # noqa: E402
from uurg_tpu.parallel import mesh as JM  # noqa: E402

QKV, ADALN = "blocks.0.attn.qkv.weight", "blocks.0.adaLN_modulation.1.weight"
FINAL = "final_layer.adaLN_modulation.1.weight"
GEGLU = "down_0_attn_0.tblock_0.ff_geglu.proj.weight"


def _mesh(**axes):
    """The mesh as the rules read it (axis names and sizes), no ranks."""
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 shape=tuple(axes.values()))


def _jax_dims(params, specs, to_torch, *args) -> dict:
    """JAX's choice as ``{port name: the port dimension it shards, or
    None}``: each leaf filled with its index along the sharded axis (-1
    when whole), carried through the interop map, which transposes."""
    def fill(p, spec):
        axes = [i for i, a in enumerate(spec) if a is not None]
        if not axes:
            return np.full(p.shape, -1, np.float32)
        shape = [1] * p.ndim
        shape[axes[0]] = p.shape[axes[0]]
        return np.broadcast_to(np.arange(p.shape[axes[0]], dtype=np.float32)
                               .reshape(shape), p.shape).copy()

    filled = jax.tree_util.tree_map(fill, params, specs,
                                    is_leaf=lambda x: isinstance(x, P))
    out = {}
    for k, v in to_torch(filled, *args).items():
        v = v.numpy()
        if (v == -1).all():
            out[k] = None
            continue
        dims = [d for d in range(v.ndim) if v.shape[d] > 1
                and np.any(np.diff(v, axis=d) != 0)]
        assert len(dims) == 1, k
        out[k] = dims[0]
    return out


def _dit_pair():
    jcfg = JD.DiTConfig(input_size=8, patch_size=2, in_channels=4,
                        hidden_size=384, depth=2, num_heads=6,
                        num_classes=10)
    return PR.dit_workload().init_params(0), JD.init_dit(jax.random.key(0),
                                                         jcfg)[1]


def _check_against_jax(got, want, model, size):
    """The rules' parameters on JAX's dimension; the fallback's sharded
    where JAX shards them (JAX's FSDP dimension, mapped, may differ where
    two dimensions tie: the same elements a rank); the rest whole."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, spec in got.items():
        if spec is None:
            assert want[name] is None, name
        elif spec.kind == "tp":
            assert want[name] == spec.dim, name
            assert shapes[name][spec.dim] % (size * spec.pieces) == 0
        else:
            assert want[name] is not None, name
            assert shapes[name][spec.dim] % size == 0


def test_dit_tp_specs_match_jax():
    """Depth-2 DiT-S/2 at model=2: JAX's DIT_TP_RULES on its scan-stacked
    params, the port's on its own names; the final modulation whole on
    both sides (JAX's final_adaLN matches no rule)."""
    model, params = _dit_pair()
    jmesh = JM.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    want = _jax_dims(params, JM.tp_param_specs(params, jmesh,
                                               JM.DIT_TP_RULES),
                     JI.jax_dit_params_to_torch, 2)
    got = M.tp_param_specs(model, _mesh(data=2, model=2), M.DIT_TP_RULES)
    _check_against_jax(got, want, model, 2)
    assert got[QKV] == M.ParamShard("tp", 0, 3)
    assert got[ADALN] == M.ParamShard("tp", 0, 6)
    assert got["blocks.1.attn.proj.weight"] == M.ParamShard("tp", 1)
    assert got["blocks.1.mlp.fc2.bias"] is None          # row bias whole
    assert got[FINAL] is None and want[FINAL] is None
    assert sum(s is not None for s in got.values()) == 2 * 8


@pytest.mark.parametrize("min_size", [64, 2**14])
def test_sd_tp_specs_match_jax(min_size):
    """SD's TINY UNet at model=2, JAX's SD_TP_RULES with the FSDP
    fallback (the JAX runner's) at two floors."""
    model = SDUNet(SDUNetConfig(**SD_TINY))
    params = jax_unet_params(SD_TINY)
    jmesh = JM.make_mesh({"model": 2}, devices=jax.devices()[:2])
    want = _jax_dims(params, JM.tp_param_specs(
        params, jmesh, JM.SD_TP_RULES, fallback="fsdp",
        fsdp_min_size=min_size), JI.jax_sd_unet_params_to_torch)
    got = M.tp_param_specs(model, _mesh(model=2), M.SD_TP_RULES,
                           fallback="fsdp", fsdp_min_size=min_size)
    _check_against_jax(got, want, model, 2)
    assert got[GEGLU] == M.ParamShard("tp", 0, 2)
    kinds = {s.kind for s in got.values() if s is not None}
    assert kinds == {"tp", "fsdp"}


class _Tiny(torch.nn.Module):
    def __init__(self, attn_dim=6, embed=256):
        super().__init__()
        self.attn = torch.nn.Module()
        self.attn.qkv = torch.nn.Linear(attn_dim, attn_dim)
        self.patch_embed = torch.nn.Linear(embed, embed)


def test_tp_edge_cases_match_jax():
    # a dimension the pieces times the axis size do not divide: whole
    jmesh = JM.make_mesh({"data": 2, "model": 4}, devices=jax.devices()[:8])
    jspec = JM.tp_param_specs({"attn": {"qkv": {"kernel": jnp.zeros((6, 6))}}},
                              jmesh, JM.DIT_TP_RULES)
    assert jspec["attn"]["qkv"]["kernel"] == P()
    got = M.tp_param_specs(_Tiny(), _mesh(data=2, model=4), M.DIT_TP_RULES)
    assert got["attn.qkv.weight"] is None and got["attn.qkv.bias"] is None
    # unmatched parameters under the FSDP fallback
    jspec = JM.tp_param_specs({"patch_embed": {"kernel": jnp.zeros((256,
                                                                    256))}},
                              jmesh, JM.DIT_TP_RULES, fallback="fsdp",
                              fsdp_min_size=64)
    assert jspec["patch_embed"]["kernel"] == P("model", None)
    got = M.tp_param_specs(_Tiny(), _mesh(data=2, model=4), M.DIT_TP_RULES,
                           fallback="fsdp", fsdp_min_size=64)
    assert got["patch_embed.weight"].kind == "fsdp"
    assert got["patch_embed.bias"] == M.ParamShard("fsdp", 0)
    assert got["attn.qkv.weight"] is None          # 36 elements < 64
    # the first matching rule wins, even where it falls through
    rules = [M.TPRule(r"qkv\.weight$", 0, 4), M.TPRule(r"qkv\.weight$", 0)]
    assert M.tp_param_specs(_Tiny(6), _mesh(model=2), rules)[
        "attn.qkv.weight"] is None
    assert M.tp_param_specs(_Tiny(6), _mesh(model=2), rules[1:])[
        "attn.qkv.weight"] == M.ParamShard("tp", 0)
    # a mesh without a model axis: JAX's error
    with pytest.raises(ValueError) as jerr:
        JM.tp_param_specs({}, JM.make_mesh({"data": 2},
                                           devices=jax.devices()[:2]))
    with pytest.raises(ValueError) as err:
        M.tp_param_specs(_Tiny(), _mesh(data=2))
    assert str(err.value) == str(jerr.value)


def test_heads_rule_keeps_an_indivisible_attention_whole():
    """At model=4 DiT-S/2's 6 heads do not split: the port keeps each
    block's qkv and proj whole (JAX shards qkv and reshards), warns naming
    them, and still shards the MLP and adaLN."""
    model, params = _dit_pair()
    jmesh = JM.make_mesh({"model": 4}, devices=jax.devices()[:4])
    jspecs = JM.tp_param_specs(params, jmesh, JM.DIT_TP_RULES)
    assert jspecs["blocks"]["attn"]["qkv"]["kernel"] == P(None, None,
                                                          "model")
    with pytest.warns(UserWarning, match=r"blocks\.0\.attn: 6 heads"):
        got = M.tp_param_specs(model, _mesh(model=4), M.DIT_TP_RULES)
    for name in (QKV, "blocks.0.attn.qkv.bias", "blocks.1.attn.proj.weight"):
        assert got[name] is None, name
    assert got["blocks.0.mlp.fc1.weight"] == M.ParamShard("tp", 0)
    assert got[ADALN] == M.ParamShard("tp", 0, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert M.tp_param_specs(model, _mesh(model=2),
                                M.DIT_TP_RULES)[QKV] is not None
    # SD's TINY at model=4: two heads an attention, every pair whole
    sd = SDUNet(SDUNetConfig(**SD_TINY))
    with pytest.warns(UserWarning, match="2 heads"):
        got = M.tp_param_specs(sd, _mesh(model=4), M.SD_TP_RULES)
    assert got[GEGLU] == M.ParamShard("tp", 0, 2)
    assert all(got[n] is None for n in got if ".attn" in n)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name,shape,pieces", [
    ("qkv", (3 * 384, 384), 3), ("qkv bias", (3 * 384,), 3),
    ("adaLN", (6 * 384, 384), 6), ("GEGLU", (2 * 4 * 64, 64), 2),
    ("fc1", (1536, 384), 1)])
def test_pieces_round_trip(name, shape, pieces, size):
    """Rank r's local slice holds the r-th slice of each piece; the ranks'
    slices concatenated in rank order (what a DTensor gathers) and put in
    full_tensor's order give the one-device tensor."""
    full = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    parts = [M._piece_slice(full, 0, pieces, size, r) for r in range(size)]
    for r, part in enumerate(parts):
        want = torch.cat([p.chunk(size)[r] for p in full.chunk(pieces)])
        assert torch.equal(part, want)
    assert torch.equal(M._piece_order(torch.cat(parts), 0, pieces, size),
                       full)


@pytest.fixture
def one_rank():
    with PR.one_rank_group():
        yield


def _dit_perturbed():
    model = PR.dit_workload().init_params(0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def test_one_rank_tp_placement_gives_one_devices_bits(one_rank):
    """model=1: the rules' parameters become DTensors with their pieces
    recorded (what the card's one-rank run asserts), the final modulation
    stays whole, and a forward and backward through the paired operators
    give the one-device model's output and gradients bit for bit."""
    assert refuse_multi_device("tp") is None
    want = _dit_perturbed()
    got = _dit_perturbed()
    M.place_model(got, M.make_mesh({"data": 1, "model": 1}), "tp",
                  M.DIT_TP_RULES)
    params = dict(got.named_parameters())
    assert M.tp_pieces(params[QKV]) == 3 and M.tp_pieces(params[ADALN]) == 6
    assert M.tp_pieces(params["blocks.1.mlp.fc2.weight"]) == 1
    assert not M.is_sharded(params[FINAL])
    assert T.model_size(params[QKV]) == 1
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 8, 8, 4, generator=gen)
    t, y = torch.tensor([1, 50, 300, 999]), torch.tensor([0, 3, 7, 9])
    for model in (want, got):
        model(x, t, y).square().mean().backward()
    assert torch.equal(got(x, t, y), want(x, t, y))
    for n, p in want.named_parameters():
        assert torch.equal(M.full_tensor(params[n].grad, params[n]),
                           p.grad), n
    for k, v in M.full_state_dict(got).items():
        assert torch.equal(v, want.state_dict()[k]), k


@pytest.mark.parametrize("remat", [False, True])
def test_one_rank_sd_tp_placement(one_rank, remat):
    """SD's TINY UNet under tp on model=1: q, k, v, GEGLU (its pieces
    recorded), to_out and ff_out placed by the rules, the convolutions by
    the FSDP fallback; the forward and backward (the collectives again in
    the recompute under remat) give one device's bits."""
    cfg = SDUNetConfig(**SD_TINY, dtype=torch.float32, remat=remat)
    want = SDUNet(cfg)
    got = SDUNet(cfg)
    got.load_state_dict(want.state_dict())
    M.shard_params_tp(got, M.make_mesh({"model": 1}), M.SD_TP_RULES,
                      fallback="fsdp")
    params = dict(got.named_parameters())
    assert M.tp_pieces(params[GEGLU]) == 2
    assert M.tp_pieces(params["mid_attn.tblock_0.attn1.to_q.weight"]) == 1
    fsdp = [n for n, p in params.items()
            if M.is_sharded(p) and not M.is_tp(p)]
    assert fsdp == ["up_1_res_0.conv1.weight"]     # 2**14 elements
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 4, generator=gen)
    ctx = torch.randn(2, 8, 16, generator=gen)
    t = torch.tensor([5, 700])
    outs = [m(x, t, ctx) for m in (want, got)]
    assert torch.equal(outs[1], outs[0])
    for out in outs:
        out.square().mean().backward()
    for n, p in want.named_parameters():
        assert torch.equal(M.full_tensor(params[n].grad, params[n]),
                           p.grad), n
