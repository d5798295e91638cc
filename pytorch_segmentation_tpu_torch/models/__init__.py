"""Model registry of the port. `MODEL_REGISTRY` lists the JAX package's
model names; UNet (MobileNetV2 encoder), DeepLabV3+, HRNet, FPN, PSPNet,
FastFCN, FCN, DeepLabV3, DANet, LR-ASPP (MobileNetV3-Large), SegFormer
(MiT-B0...B5) and UPerNet (ResNet and MiT encoders) are ported so far
(`ported_models()`), and `build_model` raises NotImplementedError for the
others, which follow in the order ROADMAP.md queue 1 item 6 lists.
`MODEL_VARIANTS` is the JAX package's table for the ported families,
UPerNet's ConvNeXt, Swin and ViT entries included: `variant_kwargs` returns
them and the UPerNet constructor refuses them (`UNPORTED_ENCODERS`)."""

from .danet import DANet
from .deeplabv3plus import DeepLabV3Plus
from .fpn import FPN
from .hrnet import HRNet
from .lraspp import LRASPP
from .pspnet import PSPNet
from .segformer import SegFormer
from .tvseg import FCN, DeepLabV3
from .unet import UNet
from .upernet import UNPORTED_ENCODERS, UPerNet

__all__ = ["DANet", "DeepLabV3", "DeepLabV3Plus", "FCN", "FPN", "HRNet",
           "LRASPP", "PSPNet", "SegFormer", "UNet", "UPerNet",
           "UNPORTED_ENCODERS",
           "MODEL_REGISTRY", "MODEL_VARIANTS", "UNPORTED_MODEL_ITEM",
           "build_model", "ported_models", "variant_kwargs"]

UNPORTED_MODEL_ITEM = "ROADMAP queue 1 item 6, other model families"


def _fastfcn(**kw):
    """FastFCN: the PSPNet head over joint pyramid upsampling in place of
    the dilated backbone (`PSPNet(jpu=True)`)."""
    return PSPNet(jpu=True, **kw)


# every name the JAX package's --model takes; None: not ported yet
MODEL_REGISTRY = {
    "unet": UNet,
    "bisenetv2": None,
    "danet": DANet,
    "deeplabv3plus": DeepLabV3Plus,
    "hrnet": HRNet,
    "ocrnet": None,
    "pspnet": PSPNet,
    "fpn": FPN,
    "fastfcn": _fastfcn,
    "segformer": SegFormer,
    "segnext": None,
    "segmenter": None,
    "maskformer": None,
    "upernet": UPerNet,
    "fcn": FCN,
    "deeplabv3": DeepLabV3,
    "lraspp": LRASPP,
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


# per-family size variants of the CLIs' --variant, for the ported families
MODEL_VARIANTS = {
    # tiny / tiny-d4 are not paper variants: the JAX package's test sizes
    "segformer": {v: {"variant": v} for v in
                  ("b0", "b1", "b2", "b3", "b4", "b5", "tiny", "tiny-d4")},
    "upernet": {
        "r50": {},  # the default bottleneck (3, 4, 6, 3) backbone
        "r34": {"block": "basic", "backbone_layers": (3, 4, 6, 3)},
        **{f"mit-{v}": {"encoder": "mit", "mit_variant": v}
           for v in ("b0", "b1", "b2", "b3", "b4", "b5", "tiny")},
        # not ported: the constructor refuses these encoders
        **{f"cn-{v}": {"encoder": "convnext", "convnext_variant": v}
           for v in ("t", "s", "b", "pico")},
        **{f"swin-{v}": {"encoder": "swin", "swin_variant": v}
           for v in ("t", "s", "b", "pico")},
        **{f"vit-{v}": {"encoder": "vit", "vit_variant": v}
           for v in ("b16", "l16", "pico")},
    },
    "fpn": {
        "r50": {},  # the default bottleneck (3, 4, 6, 3) backbone
        "r34": {"block": "basic", "backbone_layers": (3, 4, 6, 3)},
    },
    # the torchvision zoo's ResNet depths (fcn_resnet50 / 101, ...)
    **{name: {"r50": {}, "r101": {"backbone_layers": (3, 4, 23, 3)}}
       for name in ("fcn", "deeplabv3", "danet")},
}


def variant_kwargs(name: str, variant: str) -> dict:
    """Model-constructor kwargs for a CLI `--variant`; '' = the defaults.
    Raises, with the valid choices, for a family that has no variants in
    the port or an unknown variant name; NotImplementedError for a family
    not ported yet."""
    if not variant:
        return {}
    _model_class(name)
    table = MODEL_VARIANTS.get(name.lower())
    if not table:
        raise ValueError(f"model {name!r} has no variants "
                         f"(families with variants: "
                         f"{sorted(MODEL_VARIANTS)})")
    try:
        return dict(table[variant.lower()])
    except KeyError:
        raise ValueError(f"unknown {name} variant {variant!r}; "
                         f"available: {sorted(table)}") from None
