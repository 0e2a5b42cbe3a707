"""The classifier registry and factory (port of
``uurg_tpu/models/__init__.py``: ``model_registry`` and ``create_model``
under the JAX names, without ``eval()``): the ResNets, ViT-B/16 and
Swin-T/S/B. ``init_classifier`` is re-exported beside them, and so are the
DiT names of :mod:`uurg_torch.models.dit`."""
from uurg_torch.core.registry import Registry

model_registry = Registry("model")

from uurg_torch.models.resnet import (  # noqa: E402
    ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
)
from uurg_torch.models.init import init_classifier  # noqa: E402,F401
from uurg_torch.models.swin import Swin_B, Swin_S, Swin_T  # noqa: E402
from uurg_torch.models.vit import ViT_B  # noqa: E402
from uurg_torch.models.dit import (  # noqa: E402,F401
    DiT, DiTConfig, DiT_configs, build_dit, init_dit, init_dit_,
)

for _name, _fn in [
    ("ResNet18", ResNet18), ("ResNet34", ResNet34), ("ResNet50", ResNet50),
    ("ResNet101", ResNet101), ("ResNet152", ResNet152),
    ("ViT_B", ViT_B), ("Swin_T", Swin_T), ("Swin_S", Swin_S),
    ("Swin_B", Swin_B),
]:
    model_registry.register(_name, _fn)


def create_model(model_name: str, num_classes: int = 10, **kw):
    """Classifier factory with the reference's ``create_model`` signature
    (Classification/models/__init__.py:5-6)."""
    return model_registry.get(model_name)(num_classes=num_classes, **kw)
