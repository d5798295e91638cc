"""Model loading for serving (port of `load_model_bundle` in
pytorch_segmentation_tpu/engine/checkpoint.py).

The JAX package's own `.ckpt` files are msgpack trees that need flax to read;
the port reads the `{'model': state_dict}` `.pt` files that
`port_weights.py --reverse` writes from them.
"""

from __future__ import annotations

import torch

from ..utils.weights import load_state, seeded_state_dict

__all__ = ["load_model_bundle"]


def load_model_bundle(model: torch.nn.Module, weights_path: str | None,
                      device: torch.device | str,
                      seed: int = 0) -> torch.nn.Module:
    """Load weights into `model` and return it in eval mode on `device`.

    weights_path: a `.pt` checkpoint (loaded with strict=True), or
    None / '' for weights made from `seed` (utils/weights.seeded_state_dict).
    4-D parameters are stored channels_last, the layout the card's bf16
    convolutions are fastest in; the serving path feeds NHWC images the
    same way."""
    if weights_path:
        sd = load_state(weights_path)
    else:
        sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    model = model.to(torch.device(device), memory_format=torch.channels_last)
    return model.eval()
