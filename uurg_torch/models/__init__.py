"""The classifier registry and factory (port of
``uurg_tpu/models/__init__.py``: ``model_registry`` and ``create_model``
under the JAX names, without ``eval()``). ``init_classifier`` is
re-exported beside them."""
from uurg_torch.core.registry import Registry

model_registry = Registry("model")

from uurg_torch.models.resnet import (  # noqa: E402
    ResNet18, ResNet34, ResNet50, ResNet101, ResNet152, init_classifier,
)


def _not_ported(name: str):
    def factory(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: ViT and Swin arrive with the next "
            f"classification slice (models/vit.py, models/swin.py)")
    return factory


for _name, _fn in [
    ("ResNet18", ResNet18), ("ResNet34", ResNet34), ("ResNet50", ResNet50),
    ("ResNet101", ResNet101), ("ResNet152", ResNet152),
    ("ViT_B", _not_ported("ViT_B")), ("Swin_T", _not_ported("Swin_T")),
    ("Swin_S", _not_ported("Swin_S")), ("Swin_B", _not_ported("Swin_B")),
]:
    model_registry.register(_name, _fn)


def create_model(model_name: str, num_classes: int = 10, **kw):
    """Classifier factory with the reference's ``create_model`` signature
    (Classification/models/__init__.py:5-6)."""
    return model_registry.get(model_name)(num_classes=num_classes, **kw)
