"""Weights between the JAX package and the port (numpy only).

The port's modules are named like the flax tree (`backbone.stem.conv`,
`backbone.layer1_block0.conv1.bn`, `aspp.atrous0`, `cls_conv`, ...), so the
mapping is by name: conv kernels go HWIO -> OIHW, BN scale/bias/mean/var
become weight/bias/running_mean/running_var. `state_dict_from_jax` is the
same mapping as the JAX package's `utils/port_torch.export_torch_state_dict`
(tests hold the two equal), written without jax so that a GPU host without
jax can run it. `load_state` reads the `{'model': state_dict}` `.pt` files that
`save_torch_checkpoint` (and `port_weights.py --reverse`) write.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "load_state", "seeded_state_dict"]


def _conv_oihw(kernel) -> np.ndarray:
    """HWIO (depthwise (kh,kw,1,C)) -> OIHW ((C,1,kh,kw))."""
    return np.ascontiguousarray(
        np.transpose(np.asarray(kernel), (3, 2, 0, 1))).astype(np.float32)


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """Nested numpy param / batch-stat trees of the JAX package -> the
    port's flat state_dict of numpy arrays (with the int64
    `num_batches_tracked` a strict torch BN load needs)."""
    sd: dict = {}

    def walk_params(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk_params(v, path)
                continue
            parts = path.split(".")
            leaf = parts[-1]
            parent = parts[-2] if len(parts) >= 2 else ""
            base = ".".join(parts[:-1])
            if parent == "bn" and leaf in ("scale", "bias"):
                name = "weight" if leaf == "scale" else "bias"
                sd[f"{base}.{name}"] = np.asarray(v, np.float32)
            elif leaf == "kernel":
                sd[f"{base}.weight"] = _conv_oihw(v)
            elif leaf == "bias":
                sd[f"{base}.bias"] = np.asarray(v, np.float32)
            else:
                raise ValueError(f"unmapped param leaf {path!r}")

    def walk_stats(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk_stats(v, path)
                continue
            parts = path.split(".")
            if parts[-1] not in ("mean", "var"):
                raise ValueError(f"unmapped batch-stat leaf {path!r}")
            base = ".".join(parts[:-1])
            sd[f"{base}.running_{parts[-1]}"] = np.asarray(v, np.float32)
            sd.setdefault(f"{base}.num_batches_tracked",
                          np.zeros((), np.int64))

    walk_params(params, "")
    walk_stats(batch_stats, "")
    return sd


def load_state(path: str) -> dict:
    """Read a `{'model': state_dict}` `.pt` file -> state_dict of CPU
    tensors (tensors only: nothing in the file is executed)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(f"{path}: expected a {{'model': state_dict}} "
                         "checkpoint")
    return dict(ckpt["model"])


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Random weights for `model` made with numpy from `seed`, the same on
    every device: conv kernels He-normal over fan-out (the JAX package's
    conv init), conv biases small normal; BN affines and running statistics
    non-trivial (weight 0.5..1.5, bias N(0, 0.1), mean N(0, 0.1),
    var 0.5..1.5), so eval-mode BN is exercised."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        parts = name.split(".")
        leaf = parts[-1]
        is_bn = len(parts) > 1 and parts[-2] == "bn"
        if leaf == "num_batches_tracked":
            v = np.zeros((), np.int64)
        elif is_bn and leaf == "weight":
            v = rng.uniform(0.5, 1.5, shape)
        elif is_bn and leaf in ("bias", "running_mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "weight":  # conv OIHW
            fan_out = shape[0] * int(np.prod(shape[2:]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        elif leaf == "bias":
            v = 0.01 * rng.standard_normal(shape)
        else:
            raise ValueError(f"no seeded init for {name!r}")
        sd[name] = torch.from_numpy(np.asarray(
            v, np.int64 if leaf == "num_batches_tracked" else np.float32))
    return sd
