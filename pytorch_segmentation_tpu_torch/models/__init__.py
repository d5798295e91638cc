"""Model registry of the port. `MODEL_REGISTRY` lists the JAX package's
model names; UNet (MobileNetV2 encoder), BiSeNetV2, DeepLabV3+, HRNet,
OCRNet (on HRNet), FPN, PSPNet, FastFCN, FCN, DeepLabV3, DANet, LR-ASPP
(MobileNetV3-Large), SegFormer (MiT-B0...B5), SegNeXt (MSCAN + LightHam),
UPerNet (ResNet, MiT, ConvNeXt, Swin and ViT encoders) and Segmenter (ViT)
are ported so far (`ported_models()`), 16 of the 17; `build_model` raises
NotImplementedError for MaskFormer, which follows as ROADMAP.md queue 1
item 6 lists. `MODEL_VARIANTS` is the JAX package's
table for the ported families. `UNPORTED_ENCODERS` (UPerNet encoders the
port lacks) is empty."""

from .bisenetv2 import BiSeNetV2
from .danet import DANet
from .deeplabv3plus import DeepLabV3Plus
from .fpn import FPN
from .hrnet import HRNet
from .lraspp import LRASPP
from .ocrnet import OCRNet
from .pspnet import PSPNet
from .segformer import SegFormer
from .segmenter import Segmenter
from .segnext import SegNeXt
from .tvseg import FCN, DeepLabV3
from .unet import UNet
from .upernet import UNPORTED_ENCODERS, UPerNet

__all__ = ["BiSeNetV2", "DANet", "DeepLabV3", "DeepLabV3Plus", "FCN", "FPN",
           "HRNet", "LRASPP", "OCRNet", "PSPNet", "SegFormer", "Segmenter",
           "SegNeXt", "UNet", "UPerNet", "UNPORTED_ENCODERS",
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
    "bisenetv2": BiSeNetV2,
    "danet": DANet,
    "deeplabv3plus": DeepLabV3Plus,
    "hrnet": HRNet,
    "ocrnet": OCRNet,
    "pspnet": PSPNet,
    "fpn": FPN,
    "fastfcn": _fastfcn,
    "segformer": SegFormer,
    "segnext": SegNeXt,
    "segmenter": Segmenter,
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
        **{f"cn-{v}": {"encoder": "convnext", "convnext_variant": v}
           for v in ("t", "s", "b", "pico")},
        **{f"swin-{v}": {"encoder": "swin", "swin_variant": v}
           for v in ("t", "s", "b", "pico")},
        **{f"vit-{v}": {"encoder": "vit", "vit_variant": v}
           for v in ("b16", "l16", "pico")},
    },
    # MSCAN sizes; tiny is not a paper variant: the JAX package's test size
    "segnext": {v: {"variant": v} for v in ("tiny", "t", "s", "b")},
    # HRNet widths (mmseg ocrnet_hr18 / hr48; w32 is HRNet's default)
    "ocrnet": {"w18": {"base_channels": 18}, "w32": {},
               "w48": {"base_channels": 48}},
    # pico is not a paper variant: the JAX package's test size
    "segmenter": {v: {"variant": v} for v in ("pico", "b16", "l16")},
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
