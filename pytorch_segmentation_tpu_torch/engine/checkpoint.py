"""Checkpoints of the port (port of `save_checkpoint` and
`load_model_bundle` in pytorch_segmentation_tpu/engine/checkpoint.py).

The JAX package's own `.ckpt` files are msgpack trees that need flax to read;
the port reads and writes `.pt` files whose `'model'` entry is a state_dict:
the ones `port_weights.py --reverse` writes from a `.ckpt`, and the trainer's
own `last.pt` / `best.pt`, which carry the optimizer state and its update
count, the epoch, the best mIoU and the EMA weights beside it.
"""

from __future__ import annotations

import os

import torch

from ..utils.weights import load_state, seeded_state_dict

__all__ = ["load_model_bundle", "save_checkpoint"]


def save_checkpoint(path: str, model_state: dict, optimizer_state=None,
                    epoch: int = 0, best_miou: float = 0.0, ema=None,
                    step: int = 0) -> None:
    """Write `{'model', 'optimizer', 'step', 'epoch', 'best_miou', 'ema'}`
    to `path` (`step`: the optimizer updates so far; tensors moved to the
    CPU; written to a temporary file and renamed, so a reader never sees
    half a checkpoint). `load_state` and
    `load_model_bundle` read the `'model'` entry."""
    def to_cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu()
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to_cpu(v) for v in tree)
        return tree

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model": to_cpu(dict(model_state)),
                "optimizer": to_cpu(optimizer_state), "step": int(step),
                "epoch": int(epoch), "best_miou": float(best_miou),
                "ema": to_cpu(ema)}, tmp)
    os.replace(tmp, path)


# the top-level modules of the train-only auxiliary heads (aux=True):
# PSPNet's, FastFCN's and UPerNet's aux_conv and aux_cls, FCN's and
# DeepLabV3's nested aux_head (aux_head.aux_conv, aux_head.aux_cls), DANet's
# pam_cls and cam_cls, BiSeNetV2's booster heads aux2_conv, aux2_cls ...
# aux5_cls. OCRNet's aux_conv and aux_cls are in every OCRNet (they weight
# its gather), so a checkpoint's entries always have a slot there.
TRAIN_ONLY_MODULES = ("aux_conv", "aux_cls", "aux_head", "pam_cls",
                      "cam_cls") + tuple(
    f"aux{i}_{part}" for i in range(2, 6) for part in ("conv", "cls"))


def _drop_train_only(sd: dict, template: dict, what: str) -> dict:
    """`sd` without the train-only auxiliary-head entries that `template`
    (the model's state_dict) has no slot for, printing their names."""
    extra = sorted(k for k in sd if k not in template
                   and k.split(".")[0] in TRAIN_ONLY_MODULES)
    if extra:
        print(f"dropping train-only {what} not in the eval model: {extra}")
    return {k: v for k, v in sd.items() if k not in extra}


def load_model_bundle(model: torch.nn.Module, weights_path: str | None,
                      device: torch.device | str, seed: int = 0,
                      use_ema: bool = False) -> torch.nn.Module:
    """Load weights into `model` and return it in eval mode on `device`.

    weights_path: a `.pt` checkpoint (loaded with strict=True), or
    None / '' for weights made from `seed` (utils/weights.seeded_state_dict).
    A checkpoint of `train --aux-loss` carries the train-only auxiliary
    heads (`TRAIN_ONLY_MODULES`: `aux_conv` and `aux_cls`, the nested
    `aux_head.*`, `pam_cls` and `cam_cls`, BiSeNetV2's `aux2_*` ...
    `aux5_*`); a model built without them
    drops those entries and prints which, as the JAX package does. Every
    other entry stays strict.
    use_ema=True then loads the checkpoint's `'ema'` entry (the trainer's
    EMA-averaged parameters) over the parameters; BN running statistics stay
    the checkpoint's own, which already are a moving average. It raises for
    a checkpoint that holds none.
    4-D parameters are stored channels_last, the layout the card's bf16
    convolutions are fastest in; the serving path feeds NHWC images the
    same way."""
    if use_ema and not weights_path:
        raise ValueError("use_ema=True needs a checkpoint")
    template = model.state_dict()
    if weights_path:
        sd = _drop_train_only(load_state(weights_path), template, "entries")
    else:
        sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    if use_ema:
        ema = torch.load(weights_path, map_location="cpu",
                         weights_only=True).get("ema")
        if ema is None:
            raise ValueError(f"{weights_path} holds no EMA parameters "
                             "(trained without ema_decay)")
        ema = _drop_train_only(ema, template, "EMA entries")
        extra = model.load_state_dict(ema, strict=False).unexpected_keys
        if extra:
            raise ValueError(f"{weights_path}: EMA entries the model lacks: "
                             f"{extra}")
    model = model.to(torch.device(device), memory_format=torch.channels_last)
    return model.eval()
