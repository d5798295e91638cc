"""Training CLI of the port (port of the root train.py).

    python -m pytorch_segmentation_tpu_torch.train data/coco \\
        --model deeplabv3plus --dataset coco -s 513 513 -bs 32 -a 1 -mp \\
        --epochs 2 --num-workers 4
    python -m pytorch_segmentation_tpu_torch.train data/coco  # unet, 320^2

The same flags, names and defaults as the root CLI. Files are read from
disk by the port's datasets (PNG and JPEG images; COCO JSON, or the segimg
/ idimg layouts) at `-s W H` (any W and H), batches are mixed (`--cutmix` /
`--mosaic`, `data/mix.py`) and augmented on the card
(`PostFetch(make_augment_fn(), mix_fn=...)`; `--fast-augment` takes the
axis-aligned warp, `AugmentConfig(fast_geometric=True)`) and
trained by `Trainer` on the loss of `--loss` (`ops/loss.build_loss`; its CE
term takes `--class-weights`, `--label-smoothing`, `--ohem` /
`--ohem-thresh` and `--ignore-index`), plus, under `--distill CKPT`, the
distillation term of a frozen teacher (`--distill-model`,
`--distill-variant`, a `.pt` checkpoint of the port). After each epoch the
validation set is evaluated (`engine.test`), `<log_dir>/log.jsonl` gets the
val mIoU, and
`weights/last.pt` (and `weights/best.pt` when the mIoU rose) is written.
`--qat` trains quantization-aware (`Trainer(qat=True)`, quant.py), and the
epoch's eval, which picks best.pt, then runs the int8 forward. `--remat`
recomputes the backbone's blocks in the backward (`nn.blocks.checkpoint`)
for the families of the JAX CLI's list (`REMAT_FAMILIES`; another exits
with its message); `--bn-subsample S` takes train-mode BatchNorm statistics
from every S-th pixel (`nn.blocks.set_bn_stat_subsample`) and
`--debug-nans` makes the train and eval steps raise a `FloatingPointError`
at the first NaN (`utils/runtime.set_debug_nans`), both for the run of
`train()`.
Prints the per-epoch images/s and loss, the eval table and
`save best, miou: ...`.

A flag whose machinery is not ported yet exits with status 2 and names its
ROADMAP item. `--model` takes every name of the root CLI: unet, the
default, bisenetv2, danet, deeplabv3, deeplabv3plus, fastfcn, fcn, fpn,
hrnet, lraspp, maskformer, ocrnet, pspnet, segformer, segmenter, segnext
and upernet (UNet, BiSeNetV2, HRNet, OCRNet, FPN, MaskFormer, SegFormer,
SegNeXt and UPerNet take sizes that are multiples of 32). MaskFormer
trains on its set-prediction criterion (`make_maskformer_loss`, the
query-to-class matcher of `--matcher`: sinkhorn on the card, or
hungarian, scipy's on the host); `--loss` other than ce exits there, and
`--ignore-index` then counts in the eval only, as in the root CLI (labels
of K and above are left out of the criterion anyway). `--scan-blocks`
builds segformer's stacked block stages; another family exits with status
2.
`--aux-loss W` builds pspnet, fastfcn, upernet, bisenetv2, ocrnet, fcn,
deeplabv3 or danet with its auxiliary heads (danet's two branch
classifiers, bisenetv2's four booster heads, ocrnet's soft-region head) and
adds W times each head's loss; any other family exits with the JAX CLI's
message. `--variant` takes a family's size variant (fpn: r50, r34; fcn,
deeplabv3, danet: r50, r101; ocrnet: w18, w32, w48; segnext: tiny, t, s,
b; segformer: b0..b5, tiny, tiny-d4; segmenter: pico, b16, l16;
maskformer: r50, tiny; upernet: r50, r34, mit-b0..mit-b5, mit-tiny, cn-*,
swin-*, vit-*). Runs on the card
(`require_cuda`);
`train(..., device="cpu")` runs the same on the CPU.

Data parallelism, one process per card, as the reference's DDP:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m pytorch_segmentation_tpu_torch.train data/coco --model deeplabv3plus

Under torchrun the process group is the mesh (`parallel.
initialize_distributed`, NCCL; gloo with `device="cpu"`): each rank loads
its shard of the train and val sets (`-bs` images a rank: the global batch
is `-bs` times the rank count), the step's BatchNorm statistics, loss and
gradients span every rank, the epoch's eval is global, and rank 0 prints
and writes the checkpoints. `--zero` shards the optimizer state over the
ranks (`parallel/zero.py`; with one rank it is the plain path).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

import torch
import torch.distributed as dist

from .data import (AugmentConfig, CocoDataset, CocoInstance, DataLoader,
                   Fetcher, IdImgDataset, PostFetch, SegImgDataset,
                   make_augment_fn, make_mix_fn, repeat_factors)
from .data.resize_host import multi_scale_sizes
from .engine import Trainer, load_model_bundle, test
from .engine.steps import nhwc_forward
from .models import (MODEL_REGISTRY, apply_scan_blocks, build_model,
                     make_maskformer_loss, variant_kwargs,
                     without_default_init)
from .nn.blocks import bn_stat_subsample
from .ops.loss import build_loss
from .parallel import initialize_distributed, make_mesh
from .utils.cli import refuse_unported, unported_options
from .utils.runtime import debug_nans as debug_nans_scope
from .utils.runtime import require_cuda

__all__ = ["DATASETS", "UNPORTED", "REMAT_FAMILIES", "parse_class_weights",
           "train",
           "build_parser", "parse_args", "main"]

DATASETS = {
    "cocoinstance": (CocoInstance, "train.json", "val.json"),
    "coco": (CocoDataset, "train.json", "val.json"),
    "segimg": (SegImgDataset, "train.txt", "val.txt"),
    "idimg": (IdImgDataset, "train.txt", "val.txt"),
}

# the JAX CLI's families with an auxiliary head (--aux-loss), all ported
AUX_LOSS_FAMILIES = ("pspnet", "fastfcn", "upernet", "bisenetv2", "ocrnet",
                     "fcn", "deeplabv3", "danet")
# the JAX CLI's families that take --remat
REMAT_FAMILIES = ("deeplabv3plus", "pspnet", "fpn", "fastfcn", "segformer",
                  "bisenetv2", "fcn", "deeplabv3", "segnext", "segmenter",
                  "upernet", "danet")

# options whose machinery is not ported: name -> (default, ROADMAP queue 1
# item). `train()` raises for them; the CLI exits with status 2.
UNPORTED = {
    "tp": (1, 10), "pp": (1, 10), "ep": (1, 10), "spatial": (1, 10),
    "moe": (0, 10),
}


def parse_class_weights(spec: str, num_classes: int):
    """--class-weights: 'w1,w2,...' (C floats) or a JSON file holding a list
    (or {'weights': [...]}). Returns a float list of length C, or None for
    an empty spec; exits when the count is not the dataset's."""
    if not spec:
        return None
    if osp.exists(spec):
        with open(spec) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data["weights"]
        weights = [float(v) for v in data]
    else:
        weights = [float(v) for v in spec.split(",")]
    if len(weights) != num_classes:
        raise SystemExit(f"--class-weights has {len(weights)} entries, "
                         f"dataset has {num_classes} classes")
    return weights


def train(data_dir, model_name, epochs, img_size, batch_size, accumulate, lr,
          adam, resume, weights, num_workers, multi_scale, rect,
          mixed_precision, notest, nosave, seed=0, profile=False,
          dataset="cocoinstance", remat=False, lr_schedule="constant",
          warmup_steps=0, fast_augment=False, precompile=False, qat=False,
          ema=0.0, loss="ce", cache_images=False, momentum=0.9,
          weight_decay=0.0, clip_grad=0.0, patience=0, aux_loss=0.0, tp=1,
          variant="", pp=1, pp_microbatches=0, scan_blocks=False,
          distill="", distill_model="", distill_variant="",
          distill_weight=1.0, distill_temp=2.0, class_weights="",
          label_smoothing=0.0, ohem=0.0, ohem_thresh=0.7, zero=False,
          moe=0, moe_top_k=2, ep=1, spatial=1, ignore_index=None,
          cutmix=0.0, mosaic=0.0, balance=0.0, matcher="sinkhorn",
          bn_subsample=1, debug_nans=False, device=None):
    """The root `train()` on `device` (None: the card). Writes weights/ and
    runs/ under the working directory; returns the Trainer. Under an
    initialized process group the group is the mesh (the module
    docstring)."""
    unported = unported_options(locals(), UNPORTED)
    if unported:
        raise NotImplementedError("; ".join(unported))
    model_kw = variant_kwargs(model_name, variant)
    if remat:
        if model_name not in REMAT_FAMILIES:
            raise SystemExit(f"--remat is not supported for {model_name} "
                             "(no remat-capable block stages)")
        model_kw["remat"] = True
    if aux_loss > 0:
        if model_name not in AUX_LOSS_FAMILIES:
            raise SystemExit("--aux-loss is only supported by the "
                             + "/".join(AUX_LOSS_FAMILIES) + " families")
        model_kw["aux"] = True
    apply_scan_blocks(model_name, model_kw, scan_blocks)
    device = require_cuda() if device is None else torch.device(device)
    mesh = make_mesh((device,)) if dist.is_initialized() else None
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    ds_cls, train_file, val_file = DATASETS[dataset]
    train_data = ds_cls(osp.join(data_dir, train_file), img_size=img_size,
                        multi_scale=multi_scale, rect=rect,
                        cache_images=cache_images)
    rf = None
    if balance > 0:
        # LVIS repeat-factor oversampling of rare-class images
        presence = train_data.class_presence()
        if presence is None:
            raise SystemExit(f"--balance: dataset {dataset!r} cannot "
                             "report per-image class presence")
        rf = repeat_factors(presence, len(train_data), balance)
        print(f"balance: t={balance}, mean repeat {rf.mean():.3f}, "
              f"max {rf.max():.2f} "
              f"({int((rf > 1).sum())}/{len(rf)} images oversampled)")
    train_loader = DataLoader(train_data, batch_size=batch_size, shuffle=True,
                              drop_last=True, num_workers=num_workers,
                              seed=seed, rank=rank, world_size=world,
                              repeat_factors=rf)
    h, w = img_size[1], img_size[0]
    # bf16 feed when the model computes bf16: its first convolution casts
    # the input anyway
    feed_dtype = torch.bfloat16 if mixed_precision else torch.float32
    # --fast-augment: the axis-aligned warp by matrix products
    augment_fn = make_augment_fn(
        AugmentConfig(fast_geometric=True) if fast_augment else None)
    train_fetcher = Fetcher(train_loader, PostFetch(
        augment_fn=augment_fn, multi_scale=multi_scale,
        base_hw=(h, w), seed=seed, dtype=feed_dtype,
        mix_fn=make_mix_fn(cutmix_p=cutmix, mosaic_p=mosaic), device=device))

    if not notest:
        val_data = ds_cls(osp.join(data_dir, val_file), img_size=img_size,
                          augments=False, rect=rect,
                          cache_images=cache_images)
        val_loader = DataLoader(val_data, batch_size=batch_size,
                                shuffle=False, num_workers=num_workers,
                                rank=rank, world_size=world)
        val_fetcher = Fetcher(val_loader, PostFetch(device=device))

    if patience and notest:
        raise SystemExit("--patience keys off per-epoch val mIoU; it can't "
                         "work with --notest")
    # the Trainer seeds or loads every entry
    with without_default_init():
        model = build_model(model_name, num_classes=len(train_data.classes),
                            dtype=feed_dtype, **model_kw)

    distill_fn = None
    if distill:
        # a frozen teacher of any family, in eval mode on the device; its
        # logits stay at its own stride, as the student's do under the
        # deferred upsample (distill_loss resizes a grid that differs)
        tname = distill_model or model_name
        with without_default_init():
            teacher = build_model(tname, num_classes=len(train_data.classes),
                                  dtype=feed_dtype, full_res_output=False,
                                  **variant_kwargs(tname, distill_variant))
        teacher = load_model_bundle(teacher, distill, device)
        distill_fn = nhwc_forward(teacher)

    cw = parse_class_weights(class_weights, len(train_data.classes))
    if model_name == "maskformer":
        # mask classification trains on the set-prediction criterion
        if loss != "ce":
            raise SystemExit("--loss is fixed to the set-prediction "
                             "criterion for --model maskformer")
        loss_fn = make_maskformer_loss(len(train_data.classes),
                                       matcher=matcher)
    else:
        loss_fn = build_loss(loss, align_corners=getattr(
            model, "up_align_corners", True), class_weights=cw,
            label_smoothing=label_smoothing, ohem_frac=ohem,
            ohem_thresh=ohem_thresh, ignore_index=ignore_index)
    trainer = Trainer(model, train_fetcher, loss_fn=loss_fn,
                      workdir="weights", accumulate=accumulate, adam=adam,
                      lr=lr, weights=weights, resume=resume,
                      mixed_precision=mixed_precision, seed=seed,
                      momentum=momentum, weight_decay=weight_decay,
                      clip_grad=clip_grad, profile=profile,
                      defer_upsample=True, lr_schedule=lr_schedule,
                      warmup_steps=warmup_steps,
                      # optimizer updates: one per `accumulate` batches
                      total_steps=epochs * len(train_loader)
                      // max(1, accumulate),
                      ema_decay=ema, aux_weight=aux_loss,
                      distill_fn=distill_fn, distill_weight=distill_weight,
                      distill_temp=distill_temp, qat=qat, mesh=mesh,
                      zero=zero, device=device)
    # --bn-subsample and --debug-nans hold for this run's steps
    with bn_stat_subsample(bn_subsample), debug_nans_scope(debug_nans):
        if precompile:
            sizes = multi_scale_sizes((h, w)) if multi_scale else [(h, w)]
            trainer.warmup(sizes, batch_size)
        epochs_since_best = 0
        while trainer.epoch < epochs:
            trainer.step()
            best = False
            if not notest:
                # under --qat the deployment target is the int8 forward, so
                # the eval (and the choice of best.pt) runs it; under --ema
                # the deployment weights are the averaged ones
                eval_model = trainer.ema_model if ema > 0 else trainer.model
                metrics = test(eval_model, val_fetcher, mesh=mesh, int8=qat,
                               ignore_index=ignore_index, device=device)
                trainer.log_record(epoch=trainer.epoch - 1, val_miou=metrics)
                if metrics > trainer.metrics:
                    best = True
                    if rank == 0:
                        print("save best, miou: %g" % metrics)
                    trainer.metrics = metrics
                    epochs_since_best = 0
                else:
                    epochs_since_best += 1
            if not nosave:
                trainer.save(best)
            if patience and epochs_since_best >= patience:
                if rank == 0:
                    print("early stop: no val mIoU improvement in %d epochs "
                          "(best %g)" % (patience, trainer.metrics))
                break
    return trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("data", type=str, default="data/voc")
    p.add_argument("--model", type=str, default="unet",
                   choices=sorted(MODEL_REGISTRY))
    p.add_argument("--dataset", type=str, default="cocoinstance",
                   choices=sorted(DATASETS))
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("-s", "--img_size", type=int, nargs=2, default=[320, 320])
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-a", "--accumulate", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--adam", action="store_true")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="coupled L2 decay added to the gradients")
    p.add_argument("--clip-grad", type=float, default=0.0, metavar="NORM")
    p.add_argument("--resume", action="store_true",
                   help="continue from weights/last.pt")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--rect", action="store_true")
    p.add_argument("-mp", "--mix_precision", action="store_true",
                   help="bf16 compute over f32 parameters")
    p.add_argument("--notest", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--aux-loss", type=float, default=0.0, metavar="W")
    p.add_argument("--patience", type=int, default=0, metavar="N")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of first-epoch steps -> "
                        "runs/profile")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--lr-schedule", type=str, default="constant",
                   choices=["constant", "cosine", "poly"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--bn-subsample", type=int, default=1)
    p.add_argument("--fast-augment", action="store_true")
    p.add_argument("--cutmix", type=float, default=0.0, metavar="P")
    p.add_argument("--mosaic", type=float, default=0.0, metavar="P")
    p.add_argument("--balance", type=float, default=0.0, metavar="T",
                   help="repeat-factor oversampling of rare-class images")
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--precompile", action="store_true",
                   help="one step per input size before the first epoch")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware training: fake-quant every "
                        "int8-eligible conv (STE); the epoch's eval runs "
                        "the int8 forward")
    p.add_argument("--cache-images", action="store_true")
    p.add_argument("--matcher", type=str, default="sinkhorn",
                   choices=["sinkhorn", "hungarian"])
    p.add_argument("--loss", type=str, default="ce",
                   choices=["ce", "lovasz", "ce+lovasz", "focal", "ce+rect",
                            "dice", "ce+dice"])
    p.add_argument("--class-weights", type=str, default="")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--ohem", type=float, default=0.0, metavar="FRAC")
    p.add_argument("--ohem-thresh", type=float, default=0.7)
    p.add_argument("--moe", type=int, default=0, metavar="E")
    p.add_argument("--moe-top-k", type=int, default=2, metavar="K")
    p.add_argument("--ep", type=int, default=1, metavar="N")
    p.add_argument("--ignore-index", type=int, default=None, metavar="ID",
                   help="label id excluded from the loss and the eval counts")
    p.add_argument("--spatial", type=int, default=1, metavar="N")
    p.add_argument("--zero", action="store_true")
    p.add_argument("--variant", type=str, default="")
    p.add_argument("--tp", type=int, default=1, metavar="N")
    p.add_argument("--pp", type=int, default=1, metavar="N")
    p.add_argument("--pp-microbatches", type=int, default=0, metavar="M")
    p.add_argument("--scan-blocks", action="store_true")
    p.add_argument("--distill", type=str, default="", metavar="CKPT")
    p.add_argument("--distill-model", type=str, default="")
    p.add_argument("--distill-variant", type=str, default="")
    p.add_argument("--distill-weight", type=float, default=1.0, metavar="W")
    p.add_argument("--distill-temp", type=float, default=2.0, metavar="T")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="keep an EMA of the weights; val and 'best' use it")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    opt = parser.parse_args(argv)
    refuse_unported(parser, opt, UNPORTED)
    return opt


def main(argv=None, device=None):
    """Parse `argv` and train on `device` (None: the card); returns the
    Trainer. Under torchrun the process group is set up first and taken
    down at the end."""
    opt = parse_args(argv)
    print(opt)
    rank_device = initialize_distributed(device=device)
    try:
        return train(data_dir=opt.data, model_name=opt.model, epochs=opt.epochs,
              img_size=opt.img_size, batch_size=opt.batch_size,
              accumulate=opt.accumulate, lr=opt.lr, adam=opt.adam,
              resume=opt.resume, weights=opt.weights,
              num_workers=opt.num_workers, multi_scale=opt.multi_scale,
              rect=opt.rect, mixed_precision=opt.mix_precision,
              notest=opt.notest, nosave=opt.nosave, seed=opt.seed,
              profile=opt.profile, dataset=opt.dataset, remat=opt.remat,
              lr_schedule=opt.lr_schedule, warmup_steps=opt.warmup_steps,
              fast_augment=opt.fast_augment, precompile=opt.precompile,
              qat=opt.qat, ema=opt.ema, loss=opt.loss,
              cache_images=opt.cache_images, momentum=opt.momentum,
              weight_decay=opt.weight_decay, clip_grad=opt.clip_grad,
              patience=opt.patience, aux_loss=opt.aux_loss, tp=opt.tp,
              matcher=opt.matcher,
              variant=opt.variant, pp=opt.pp,
              pp_microbatches=opt.pp_microbatches,
              scan_blocks=opt.scan_blocks, distill=opt.distill,
              distill_model=opt.distill_model,
              distill_variant=opt.distill_variant,
              distill_weight=opt.distill_weight,
              distill_temp=opt.distill_temp, class_weights=opt.class_weights,
              label_smoothing=opt.label_smoothing, ohem=opt.ohem,
              ohem_thresh=opt.ohem_thresh, zero=opt.zero, moe=opt.moe,
              moe_top_k=opt.moe_top_k, ep=opt.ep, spatial=opt.spatial,
              ignore_index=opt.ignore_index, cutmix=opt.cutmix,
              mosaic=opt.mosaic, balance=opt.balance,
              bn_subsample=opt.bn_subsample, debug_nans=opt.debug_nans,
              device=device if rank_device is None else rank_device)
    finally:
        if rank_device is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
