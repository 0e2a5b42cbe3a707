"""The port's Diffusers export of the SD UNet vs the JAX package's (CPU):
``torch_unet_to_diffusers`` equals ``flax_unet_to_diffusers`` bit for bit,
over the same key set, on the same weights (TINY_UNET, with its attention,
and WIDE, a block with a channel change and none), and names every
parameter of the full-width UNet once, with JAX's key set."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tests.test_torch_sd_unet import WIDE, jax_unet_params  # noqa: E402
from uurg_torch.io import diffusers_interop as TD  # noqa: E402
from uurg_torch.io import sd_interop as TSI  # noqa: E402
from uurg_torch.io.jax_interop import jax_sd_unet_params_to_torch  # noqa: E402
from uurg_torch.models import sd_unet as TU  # noqa: E402
from uurg_tpu.io import diffusers_interop as JD  # noqa: E402
from uurg_tpu.io import sd_interop as JSI  # noqa: E402
from uurg_tpu.models import sd_unet as JU  # noqa: E402

TINY = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(1, 2), num_heads=2, context_dim=16)


@pytest.mark.parametrize("shape", [TINY, WIDE], ids=["tiny", "wide"])
def test_export_is_jax_bit_for_bit(shape):
    params = jax_unet_params(shape, perturb_seed=4)
    want = JD.flax_unet_to_diffusers(params, JU.SDUNetConfig(**shape))
    model = TU.SDUNet(TU.SDUNetConfig(**shape))
    model.load_state_dict(jax_sd_unet_params_to_torch(params), strict=True)
    for source in (model, dict(model.named_parameters())):
        got = TD.torch_unet_to_diffusers(source, model.cfg)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_full_width_key_set_is_jax_and_names_every_parameter():
    cfg = TU.SDUNetConfig()
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in TU.SDUNet(cfg).state_dict().items()}
    mapped = [ours for _, ours in TD.diffusers_key_map(cfg)]
    assert len(mapped) == len(set(mapped)) and set(shapes) <= set(mapped)
    assert all(".skip." in n for n in set(mapped) - set(shapes))
    got = {key for key, ours in TD.diffusers_key_map(cfg) if ours in shapes}
    # the JAX export of a stand-in tree of the full-width names (one
    # element a dimension: only the key set is compared)
    compvis = {f"{TSI.PREFIX}{ck}": np.zeros((1,) * len(shapes[ours]),
                                             np.float32)
               for ck, ours in TSI.sd_unet_key_map(cfg) if ours in shapes}
    flax = JSI.compvis_unet_to_flax(compvis, JU.SDUNetConfig())
    assert got == set(JD.flax_unet_to_diffusers(flax, JU.SDUNetConfig()))
    assert len(got) == len(shapes)
