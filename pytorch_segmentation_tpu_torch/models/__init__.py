"""Model registry of the port. Only DeepLabV3+ is ported so far; the other
families of the JAX package follow in the order ROADMAP.md lists."""

from .deeplabv3plus import DeepLabV3Plus

__all__ = ["DeepLabV3Plus", "MODEL_REGISTRY", "build_model"]

MODEL_REGISTRY = {
    "deeplabv3plus": DeepLabV3Plus,
}


def build_model(name: str, num_classes: int, **kwargs):
    try:
        cls = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"model {name!r} is not ported to the PyTorch package yet; "
            f"ported: {sorted(MODEL_REGISTRY)}") from None
    return cls(num_classes=num_classes, **kwargs)
