"""Model registry of the port. `MODEL_REGISTRY` lists the JAX package's
model names; UNet (MobileNetV2 encoder), DeepLabV3+ and HRNet are ported so
far (`ported_models()`), and `build_model` raises NotImplementedError for
the others, which follow in the order ROADMAP.md queue 1 item 6 lists."""

from .deeplabv3plus import DeepLabV3Plus
from .hrnet import HRNet
from .unet import UNet

__all__ = ["DeepLabV3Plus", "HRNet", "UNet", "MODEL_REGISTRY",
           "UNPORTED_MODEL_ITEM", "build_model", "ported_models",
           "variant_kwargs"]

UNPORTED_MODEL_ITEM = "ROADMAP queue 1 item 6, other model families"

# every name the JAX package's --model takes; None: not ported yet
MODEL_REGISTRY = {
    "unet": UNet,
    "bisenetv2": None,
    "danet": None,
    "deeplabv3plus": DeepLabV3Plus,
    "hrnet": HRNet,
    "ocrnet": None,
    "pspnet": None,
    "fpn": None,
    "fastfcn": None,
    "segformer": None,
    "segnext": None,
    "segmenter": None,
    "maskformer": None,
    "upernet": None,
    "fcn": None,
    "deeplabv3": None,
    "lraspp": None,
}


def ported_models() -> list[str]:
    return sorted(n for n, c in MODEL_REGISTRY.items() if c is not None)


def _model_class(name: str):
    try:
        cls = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODEL_REGISTRY)}") from None
    if cls is None:
        raise NotImplementedError(
            f"model {name!r} is not ported to the PyTorch package yet "
            f"({UNPORTED_MODEL_ITEM}); ported: {ported_models()}")
    return cls


def build_model(name: str, num_classes: int, **kwargs):
    return _model_class(name)(num_classes=num_classes, **kwargs)


def variant_kwargs(name: str, variant: str) -> dict:
    """Model-constructor kwargs for a CLI `--variant`; '' = the defaults.
    No ported family has variants yet, so any other value raises."""
    if not variant:
        return {}
    _model_class(name)
    raise ValueError(f"model {name!r} has no variants in the port "
                     f"(variant {variant!r})")
