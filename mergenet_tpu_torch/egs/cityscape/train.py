"""Cityscapes instance-segmentation training on the port
(`egs/cityscape/local/train.py` is the reference; the same flags, plus
`--device`).

    python -m mergenet_tpu_torch.egs.cityscape.train DIR [flags]
    torchrun --nproc_per_node N -m mergenet_tpu_torch.egs.cityscape.train \\
        DIR [flags]

Under `torchrun` the steps run data-parallel over the ranks
(`parallel.make_mesh`, one card each; the batch must divide by their
count): each rank loads and crops only its slice of every batch, and
rank 0 writes the logs; without it, on one card.  Checkpoints are the port's
(`utils/checkpoint.py`, the offsets in `.meta.json`); `--pretrain`
loads a local torch checkpoint through `utils/weight_import.py`.
`--input-pipeline grain` is the port's compact pipeline
(`data/pipeline.py`).  The training crops draw from `--seed` (the
reference's loader crops are unseeded)."""

import argparse
import os

import torch

from ... import resolve_device
from ...data import AllDataset, ClassDataset, DataLoader, OffsetDataset
from ...models import get_model, param_count
from ...ops.losses import get_loss_fn
from ...parallel import (build_eval_step, build_train_step,
                         build_train_step_compact, create_train_state,
                         make_optimizer)
from ...utils import generate_offsets, sample, train, validate
from ...utils import logging as tb
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from ..common import (add_device_flag, compute_dtype, finish_distributed,
                      float32_convs, is_primary, rank_seed, rank_shard,
                      recipe_mesh)

parser = argparse.ArgumentParser(
    description="cityscape instance segmentation setup (PyTorch port)")
parser.add_argument("dir", type=str,
                    help="directory of output models and logs")
parser.add_argument("--epochs", default=10, type=int)
parser.add_argument("--start-epoch", default=0, type=int)
parser.add_argument("--resume", default="", type=str,
                    help="path to latest checkpoint (default: none)")
parser.add_argument("--print-freq", "-p", default=10, type=int)
parser.add_argument("--log-freq", default=1000, type=int)
parser.add_argument("--visual-freq", default=0, type=int)
parser.add_argument("-b", "--batch-size", default=16, type=int)
parser.add_argument("--mode", default="all", type=str,
                    choices=["all", "class", "offset"])
parser.add_argument("--crop-size", default=None, type=int)
parser.add_argument("--scale", default=1, type=int)
parser.add_argument("--loss", default="bce", type=str,
                    choices=["bce", "mbce", "dice", "ce"])
parser.add_argument("--alpha", default=1, type=float,
                    help="weight of offset losses")
parser.add_argument("--aux-weight", default=0.0, type=float,
                    help="deep-supervision weight for aux-head models "
                         "(pspnet)")
parser.add_argument("--lr", "--learning-rate", default=0.01, type=float)
parser.add_argument("--momentum", default=0.9, type=float)
parser.add_argument("--milestones", default=None, nargs="+", type=int)
parser.add_argument("--arch", default="pspfpnet", type=str)
parser.add_argument("--num-classes", default=9, type=int)
parser.add_argument("--num-offsets", default=10, type=int)
parser.add_argument("--nesterov", default=True, type=bool)
parser.add_argument("--weight-decay", "--wd", default=1e-4, type=float)
parser.add_argument("--train-img", default="data/train", type=str)
parser.add_argument("--val-img", default="data/val", type=str)
parser.add_argument(
    "--train-ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_train.json")
parser.add_argument(
    "--val-ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_val.json")
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--val-limits", default=None, type=int,
                    help="cap the validation set independently of "
                         "--limits")
parser.add_argument("--input-pipeline", default="loader", type=str,
                    choices=["loader", "grain"],
                    help="'loader' = host-built float32 targets through "
                         "DataLoader; 'grain' = the compact pipeline "
                         "(data/pipeline.py): uint8 images, instance masks "
                         "and class tables, targets built on the card")
parser.add_argument("--remat", action="store_true",
                    help="recompute each block's forward in the backward "
                         "(activation memory for FLOPs)")
parser.add_argument("--bf16", action="store_true",
                    help="mixed precision: bfloat16 compute, float32 "
                         "params, BN statistics, logits and loss")
parser.add_argument("--tensorboard", action="store_true")
parser.add_argument("--pretrain", action="store_true")
parser.add_argument("--crop", action="store_true")
parser.add_argument("--score", action="store_true")
parser.add_argument("--seed", default=0, type=int,
                    help="training seed: model init, crops, per-epoch "
                         "step generator and pipeline shuffle/crop seeds")
add_device_flag(parser)


def _check_catids(train_ids, val_ids):
    """Train targets use the train json's category order, val metrics
    the val json's: a mismatch would misalign class channels."""
    if train_ids != val_ids:
        parser.error(
            "--train-ann and --val-ann disagree on category ids/order "
            "({} vs {}): training targets and val metrics would use "
            "different class channels".format(train_ids, val_ids))


def build_datasets(args, num_classes, num_offsets, use_grain, mesh=None):
    """(trainset, valset, class names, offset list) for `args.mode`;
    the training crops draw from this rank's seed."""
    from ...data.pipeline import CocoInstanceSource
    offset_list = None if args.mode == "class" else \
        generate_offsets(80 / args.scale, num_offsets)
    if args.mode == "offset":
        print("offsets are: {}".format(offset_list))
    crop = dict(scale=args.scale, crop=args.crop, crop_size=args.crop_size,
                limits=args.limits, seed=rank_seed(args.seed, mesh))
    val = dict(scale=args.scale, mode="train",
               limits=args.val_limits or args.limits)
    if use_grain:
        trainset = CocoInstanceSource(args.train_img, args.train_ann,
                                      scale=args.scale, limits=args.limits)
    elif args.mode == "all":
        trainset = AllDataset(args.train_img, args.train_ann, num_classes,
                              offset_list, **crop)
    elif args.mode == "class":
        trainset = ClassDataset(args.train_img, args.train_ann, **crop)
    else:
        trainset = OffsetDataset(args.train_img, args.train_ann,
                                 offset_list, **crop)
    if args.mode == "all":
        valset = AllDataset(args.val_img, args.val_ann, num_classes,
                            offset_list, **val)
    elif args.mode == "class":
        valset = ClassDataset(args.val_img, args.val_ann, **val)
    else:
        valset = OffsetDataset(args.val_img, args.val_ann, offset_list,
                               **val)
    class_nms = None
    if args.mode != "offset":
        class_nms = valset.catNms
        _check_catids(trainset.catIds, valset.catIds)
    return trainset, valset, class_nms, offset_list


def main(argv=None):
    args = parser.parse_args(argv)
    float32_convs()
    best_iou = float("-inf")
    dev = resolve_device(args.device)

    num_classes = 0 if args.mode == "offset" else args.num_classes
    num_offsets = 0 if args.mode == "class" else args.num_offsets
    use_grain = args.input_pipeline == "grain"
    if use_grain and not args.crop_size:
        # the compact pipeline batches fixed-size random crops
        parser.error("--input-pipeline grain requires --crop-size")
    mesh, dp = recipe_mesh(args.batch_size, args.device)
    if mesh is not None:
        dev = mesh.device
    shard = rank_shard(mesh)
    if args.tensorboard and is_primary(mesh):
        print("Using tensorboard")
        tb.configure(args.dir)

    model = get_model(num_classes, num_offsets, args.arch,
                      dtype=compute_dtype(args.bf16))
    trainset, valset, class_nms, offset_list = build_datasets(
        args, num_classes, num_offsets, use_grain, mesh)
    trainloader = None if use_grain else DataLoader(
        trainset, batch_size=args.batch_size, shuffle=True, drop_last=True,
        seed=args.seed, shard=shard)
    valloader = DataLoader(valset, batch_size=min(4, args.batch_size))
    print("Training samples: {0}\nValidation samples: {1}".format(
        len(trainset), len(valset)))

    steps_per_epoch = max(1, len(trainset) // args.batch_size)
    tx = make_optimizer(lr=args.lr, momentum=args.momentum,
                        nesterov=args.nesterov,
                        weight_decay=args.weight_decay,
                        milestones=args.milestones, gamma=0.2,
                        steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, tx, seed=args.seed, device=dev)
    print("Number of model parameters: {}".format(param_count(state.model)))

    if args.pretrain:
        # the backbone from a local torch checkpoint (./pretrained or
        # $MERGENET_PRETRAINED_DIR); nothing is downloaded
        from ...utils.weight_import import (load_pretrained,
                                            resolve_pretrained_path)
        ppath = resolve_pretrained_path(args.arch, args.pretrain)
        if ppath:
            load_pretrained(state.model, ppath, args.arch)
        else:
            print("WARNING: --pretrain given but no local weights found "
                  "(./pretrained or $MERGENET_PRETRAINED_DIR); "
                  "training from scratch")

    if args.resume:
        state, meta = load_checkpoint(args.resume, state)
        args.start_epoch = meta.get("epoch", args.start_epoch) or 0
        best_iou = meta.get("best_iou") or float("-inf")
        if meta.get("offsets"):
            offset_list = meta["offsets"]
            print("offsets are: {}".format(offset_list))
        print("=> loaded checkpoint '{}' (epoch {})".format(
            args.resume, args.start_epoch))

    loss_fn = get_loss_fn(args.loss)
    losses = dict(alpha=args.alpha,
                  criterion_cls=get_loss_fn("bce") if num_classes else None,
                  criterion_ofs=loss_fn if num_offsets else None)
    aux = args.aux_weight if args.arch == "pspnet" else 0.0
    if use_grain:
        train_step = build_train_step_compact(
            num_classes,
            tuple(tuple(o) for o in offset_list) if num_offsets else (),
            mesh=mesh, remat=args.remat, aux_weight=aux,
            local_batch=shard is not None, **losses)
    else:
        train_step = build_train_step(num_classes, num_offsets, mesh=mesh,
                                      remat=args.remat, aux_weight=aux,
                                      local_batch=shard is not None,
                                      **losses)
    eval_step = build_eval_step(num_classes, num_offsets, mesh=mesh,
                                **losses)
    # --score on the training batches: this rank's shard
    score_step = build_eval_step(num_classes, num_offsets, mesh=mesh,
                                 local_batch=shard is not None, **losses)

    iterations = args.start_epoch * steps_per_epoch
    for epoch in range(args.start_epoch, args.epochs):
        if use_grain:
            from ...data.pipeline import make_train_pipeline
            from ...utils.train_utils import train_compact
            batches, _ = make_train_pipeline(
                args.train_img, args.train_ann, batch_size=args.batch_size,
                crop_size=args.crop_size, scale=args.scale,
                limits=args.limits, seed=args.seed * 10007 + epoch,
                source=trainset, shard=shard)
            state, iterations = train_compact(
                batches, state, train_step, args.batch_size, epoch,
                iterations, print_freq=args.print_freq,
                log_freq=args.log_freq, tensorboard=args.tensorboard,
                rng=torch.Generator(dev).manual_seed(args.seed * 131
                                                     + epoch))
        else:
            state, iterations = train(
                trainloader, state, train_step, args.batch_size, epoch,
                iterations, num_classes=num_classes, class_nms=class_nms,
                offset_list=offset_list, print_freq=args.print_freq,
                log_freq=args.log_freq, tensorboard=args.tensorboard,
                score=args.score, eval_step=score_step)
        val_iou = validate(
            valloader, state, eval_step, args.batch_size, epoch, iterations,
            num_classes=num_classes, class_nms=class_nms,
            offset_list=offset_list, print_freq=args.print_freq,
            log_freq=args.log_freq, tensorboard=args.tensorboard,
            score=args.score, pad_to=dp)
        if args.visual_freq > 0 and epoch % args.visual_freq == 0:
            outdir = "{}/imgs/{}".format(args.dir, epoch)
            os.makedirs(outdir, exist_ok=True)
            sample(state, eval_step, valloader, outdir, num_classes,
                   num_offsets, pad_to=dp)
        is_best = val_iou > best_iou
        best_iou = max(val_iou, best_iou)
        save_checkpoint(args.dir, state, is_best, epoch=epoch + 1,
                        best_iou=float(best_iou),
                        offsets=offset_list if args.mode != "class"
                        else None)
    print("Best validation mean iou: ", best_iou)
    finish_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
