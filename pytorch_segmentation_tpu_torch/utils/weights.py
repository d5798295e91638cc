"""Weights between the JAX package and the port (numpy only).

The port's modules are named like the flax tree (`backbone.stem.conv`,
`backbone.layer1_block0.conv1.bn`, `aspp.atrous0`, `cls_conv`,
`backbone.block1_0.attn.q`, ...), so the mapping is by name, and by the
leaf's rank and its siblings where a name is not enough:

  - a conv `kernel` (4-D, HWIO) <-> `weight` OIHW;
  - a Dense `kernel` (2-D, (in, out)) <-> `nn.Linear.weight` (out, in);
  - a BatchNorm's scale/bias/mean/var <-> weight/bias/running_mean/
    running_var (a ConvNormAct's `bn`, or a lone BatchNorm such as
    BiSeNetV2's `ce_bn` and SegNeXt's `norm1`: the module that has
    running statistics);
  - a LayerNorm's or GroupNorm's `scale` (a `scale` beside a `bias` and no
    `kernel`) <-> the port's 1-D `weight` outside a BN;
  - a learned scale alone in its module (`<module>.scale`, DANet's residual
    gates, SegNeXt's layer scales) keeps its name;
  - a bare parameter (`BARE_PARAMS`: ConvNeXt's layer scale `gamma` (C,),
    Swin's relative-position bias table `rpb` ((2ws-1)^2, heads), the ViT's
    `class_token` (1, 1, C) and `pos_embedding` (1, 1+g^2, C), Segmenter's
    class embeddings `cls_emb` (1, K, C)) keeps its name and its layout
    both ways: a 1-D `gamma` is no LayerNorm scale, a 2-D `rpb` no Dense
    kernel.

`state_dict_from_jax` is the JAX package's
`utils/port_torch.export_torch_state_dict` where that export maps every
leaf (it has no Dense or LayerNorm leaves and no lone `scale`; tests hold
the two equal there, and the inverse against the JAX `convert_named`
elsewhere), written without jax so that a GPU host without jax can run it;
`jax_trees_from_state_dict` is its inverse. `load_state` reads the `.pt`
files whose `'model'` entry is a state_dict: those that
`save_torch_checkpoint` (and `port_weights.py --reverse`) write, and the
port's own trainer checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BARE_PARAMS", "SCALE_INITS", "state_dict_from_jax", "jax_trees_from_state_dict",
           "load_state", "seeded_state_dict"]

# parameters that are neither a kernel, a bias nor a norm's scale: carried
# verbatim under their own names
BARE_PARAMS = ("gamma", "rpb", "class_token", "pos_embedding", "cls_emb")
# the JAX inits of the lone learned scales that do not start at 0, by module
# name (SegNeXt's layer scales)
SCALE_INITS = {"layer_scale_1": 1e-2, "layer_scale_2": 1e-2}


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
            if leaf in BARE_PARAMS:
                sd[path] = np.asarray(v, np.float32)
            elif parent == "bn" and leaf in ("scale", "bias"):
                name = "weight" if leaf == "scale" else "bias"
                sd[f"{base}.{name}"] = np.asarray(v, np.float32)
            elif leaf == "kernel" and np.ndim(v) == 2:  # Dense (in, out)
                sd[f"{base}.weight"] = np.ascontiguousarray(
                    np.asarray(v, np.float32).T)
            elif leaf == "kernel":
                sd[f"{base}.weight"] = _conv_oihw(v)
            elif leaf == "scale" and "bias" in node and "kernel" not in node:
                sd[f"{base}.weight"] = np.asarray(v, np.float32)  # LayerNorm
            elif leaf in ("bias", "scale"):
                sd[path] = np.asarray(v, np.float32)
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


def jax_trees_from_state_dict(sd: dict) -> tuple[dict, dict]:
    """The inverse of `state_dict_from_jax`: the port's flat state_dict
    (tensors or numpy arrays) -> nested numpy `(params, batch_stats)` trees
    in the JAX package's layout (conv kernels OIHW -> HWIO, BN weight ->
    scale, running_mean/var -> mean/var, Linear weight (out, in) -> Dense
    kernel (in, out), a 1-D weight outside a BN -> LayerNorm scale,
    `BARE_PARAMS` as they are; `num_batches_tracked` has no counterpart and
    is dropped)."""
    params: dict = {}
    batch_stats: dict = {}

    def put(tree, parts, leaf, value):
        for part in parts:
            tree = tree.setdefault(part, {})
        tree[leaf] = value

    for name, value in sd.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value)
        *parts, leaf = name.split(".")
        is_bn = bool(parts) and parts[-1] == "bn"
        if leaf == "num_batches_tracked":
            continue
        if leaf in BARE_PARAMS:
            put(params, parts, leaf, value.astype(np.float32))
        elif leaf in ("running_mean", "running_var"):
            put(batch_stats, parts, leaf[len("running_"):],
                value.astype(np.float32))
        elif is_bn and leaf == "weight" or leaf == "weight" and \
                value.ndim == 1:  # BatchNorm, LayerNorm
            put(params, parts, "scale", value.astype(np.float32))
        elif leaf == "weight" and value.ndim == 2:  # Linear (out, in)
            put(params, parts, "kernel",
                np.ascontiguousarray(value.T).astype(np.float32))
        elif leaf == "weight":  # OIHW -> HWIO
            put(params, parts, "kernel", np.ascontiguousarray(
                np.transpose(value, (2, 3, 1, 0))).astype(np.float32))
        elif leaf in ("bias", "scale"):
            put(params, parts, leaf, value.astype(np.float32))
        else:
            raise ValueError(f"unmapped state_dict entry {name!r}")
    return params, batch_stats


def load_state(path: str) -> dict:
    """Read a `{'model': state_dict}` `.pt` file -> state_dict of CPU
    tensors (tensors only: nothing in the file is executed)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(f"{path}: expected a {{'model': state_dict}} "
                         "checkpoint")
    return dict(ckpt["model"])


def seeded_state_dict(model: torch.nn.Module, seed: int,
                      init: str = "serve") -> dict:
    """Random weights for `model` made with numpy from `seed`, the same on
    every device. `init` names one of three starts:

    'serve': conv kernels He-normal over fan-out (the JAX package's conv
    init), Linear weights lecun-normal over fan-in (flax `Dense`'s), conv
    and Linear biases small normal; BN affines and running statistics
    non-trivial (weight 0.5..1.5, bias N(0, 0.1), mean N(0, 0.1),
    var 0.5..1.5), so eval-mode BN is exercised; LayerNorm weight 0.5..1.5,
    bias N(0, 0.1) (a GroupNorm's too); a lone BatchNorm (a module with
    running statistics, not named `bn`) as a ConvNormAct's; a learned scale
    outside a BN (DANet's residual gates) 0.5..1.5, so the branch it gates
    counts, and one with a JAX init in `SCALE_INITS` (SegNeXt's layer
    scales) that init times 0.5..1.5: at 0.5..1.5 the MSCA gate, which
    multiplies its input by a function of it, grows a residual stream of
    12 blocks (SegNeXt-B's stage 3) past bf16's range; the bare parameters
    (`BARE_PARAMS`) of order 0.1-1: ConvNeXt's `gamma` 0.5..1.5, the others
    N(0, 0.5^2), so a ConvNeXt block's body, the relative-position bias and
    the position grid all count.

    'train': the JAX package's own start of training: the same kind of conv
    and Linear weights, but their biases 0, BN and LayerNorm weight 1, bias
    0, running mean 0 and variance 1, learned scales 0 (SegNeXt's layer
    scales 1e-2: `SCALE_INITS`), ConvNeXt's `gamma`
    1e-6, the ViT's `class_token` 0 and the other bare parameters 0.02
    times a standard normal clipped to +-2 (the JAX inits: a constant, zeros
    and truncated normals of scale 0.02).

    'uniform': as 'serve', but the conv and Linear weights uniform in
    +-1/sqrt(fan_in), torch's default init, and every learned scale
    0.5..1.5 (the small test models' block bodies count in full). Small f32 models whose deep
    stages normalize a few dozen values per channel train from it with
    well-conditioned gradients; under the He kernels two f32 runs that sum
    in another order part by 10% in single gradients within a step, which
    leaves nothing to hold a second device or package against."""
    if init not in ("serve", "train", "uniform"):
        raise ValueError(f"init must be 'serve', 'train' or 'uniform', not "
                         f"{init!r}")
    rng = np.random.default_rng(seed)
    sd = {}
    state = model.state_dict()
    for name, t in state.items():
        shape = tuple(t.shape)
        parts = name.split(".")
        leaf = parts[-1]
        is_bn = len(parts) > 1 and (
            parts[-2] == "bn"
            or ".".join(parts[:-1] + ["running_mean"]) in state)
        # a LayerNorm: a 1-D weight outside a BN, and its bias
        sibling = state.get(".".join(parts[:-1] + ["weight"]))
        is_ln = (not is_bn and leaf in ("weight", "bias")
                 and sibling is not None and sibling.dim() == 1)
        if leaf == "num_batches_tracked":
            v = np.zeros((), np.int64)
        elif leaf in BARE_PARAMS and init == "train":
            v = (np.full(shape, 1e-6) if leaf == "gamma"
                 else np.zeros(shape) if leaf == "class_token"
                 else 0.02 * np.clip(rng.standard_normal(shape), -2.0, 2.0))
        elif leaf == "gamma":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in BARE_PARAMS:
            v = 0.5 * rng.standard_normal(shape)
        elif is_ln and leaf == "weight":
            v = (np.ones(shape) if init == "train"
                 else rng.uniform(0.5, 1.5, shape))
        elif is_ln:
            v = (np.zeros(shape) if init == "train"
                 else 0.1 * rng.standard_normal(shape))
        elif leaf == "scale" and init == "train":
            v = np.full(shape, SCALE_INITS.get(parts[-2], 0.0))
        elif init == "train" and (is_bn or leaf != "weight"):
            v = (np.ones if leaf in ("weight", "running_var")
                 else np.zeros)(shape)
        elif is_bn and leaf == "weight":
            v = rng.uniform(0.5, 1.5, shape)
        elif is_bn and leaf in ("bias", "running_mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif leaf in ("running_var", "scale"):
            v = rng.uniform(0.5, 1.5, shape)
            if leaf == "scale" and init == "serve":
                v = v * SCALE_INITS.get(parts[-2], 1.0)
        elif leaf == "weight" and init == "uniform":  # conv OIHW, Linear
            bound = 1.0 / np.sqrt(int(np.prod(shape[1:])))
            v = rng.uniform(-bound, bound, shape)
        elif leaf == "weight" and len(shape) == 2:  # Linear (out, in)
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[1])
        elif leaf == "weight":
            fan_out = shape[0] * int(np.prod(shape[2:]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        elif leaf == "bias":
            v = 0.01 * rng.standard_normal(shape)
        else:
            raise ValueError(f"no seeded init for {name!r}")
        sd[name] = torch.from_numpy(np.asarray(
            v, np.int64 if leaf == "num_batches_tracked" else np.float32))
    return sd
