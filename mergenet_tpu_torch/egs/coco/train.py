"""COCO-2017 instance-segmentation training of the port
(`egs/coco/local/train.py` is the reference; the same flags, plus
`--device` and `--seed`).  Defaults follow the coco recipe: crop 384,
scale 2.  Under `torchrun` the steps run data-parallel over the ranks,
as the cityscape recipe's do.

    python -m mergenet_tpu_torch.egs.coco.train DIR [flags]"""

import argparse

from ... import resolve_device
from ...data import COCODataset, DataLoader
from ...models import get_model, param_count
from ...ops.losses import get_loss_fn
from ...parallel import (build_eval_step, build_train_step,
                         create_train_state, make_optimizer)
from ...utils import generate_offsets, train, validate
from ...utils import logging as tb
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from ..common import (add_device_flag, compute_dtype, finish_distributed,
                      float32_convs, is_primary, rank_seed, rank_shard,
                      recipe_mesh)

parser = argparse.ArgumentParser(description="coco setup (PyTorch port)")
parser.add_argument("dir", type=str)
parser.add_argument("--epochs", default=10, type=int)
parser.add_argument("--start-epoch", default=0, type=int)
parser.add_argument("--resume", default="", type=str)
parser.add_argument("--print-freq", "-p", default=10, type=int)
parser.add_argument("--log-freq", default=1000, type=int)
parser.add_argument("-b", "--batch-size", default=16, type=int)
parser.add_argument("--crop-size", default=384, type=int)
parser.add_argument("--scale", default=2, type=int)
parser.add_argument("--loss", default="bce", type=str,
                    choices=["bce", "mbce", "dice", "ce"])
parser.add_argument("--alpha", default=1, type=float)
parser.add_argument("--lr", default=0.01, type=float)
parser.add_argument("--momentum", default=0.9, type=float)
parser.add_argument("--milestones", default=None, nargs="+", type=int)
parser.add_argument("--arch", default="pspfpnet", type=str)
parser.add_argument("--num-classes", default=81, type=int)
parser.add_argument("--num-offsets", default=10, type=int)
parser.add_argument("--weight-decay", default=1e-4, type=float)
parser.add_argument("--train-img", default="data/train2017", type=str)
parser.add_argument("--val-img", default="data/val2017", type=str)
parser.add_argument("--train-ann", type=str,
                    default="data/annotations/instances_train2017.json")
parser.add_argument("--val-ann", type=str,
                    default="data/annotations/instances_val2017.json")
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--bf16", action="store_true",
                    help="mixed precision: bfloat16 compute, float32 "
                         "params/stats/loss")
parser.add_argument("--tensorboard", action="store_true")
parser.add_argument("--pretrain", action="store_true")
parser.add_argument("--score", action="store_true")
parser.add_argument("--seed", default=0, type=int,
                    help="model init and crop seed")
add_device_flag(parser)


def main(argv=None):
    args = parser.parse_args(argv)
    float32_convs()
    dev = resolve_device(args.device)

    num_classes = args.num_classes
    num_offsets = args.num_offsets
    offset_list = generate_offsets(80 / args.scale, num_offsets)
    print("offsets are: {}".format(offset_list))
    mesh, dp = recipe_mesh(args.batch_size, args.device)
    if mesh is not None:
        dev = mesh.device
    shard = rank_shard(mesh)
    if args.tensorboard and is_primary(mesh):
        tb.configure(args.dir)

    model = get_model(num_classes, num_offsets, args.arch,
                      dtype=compute_dtype(args.bf16))
    trainset = COCODataset(args.train_img, args.train_ann, num_classes,
                           offset_list, scale=args.scale, crop=True,
                           crop_size=args.crop_size, limits=args.limits,
                           seed=rank_seed(args.seed, mesh))
    valset = COCODataset(args.val_img, args.val_ann, num_classes,
                         offset_list, scale=args.scale, mode="train",
                         limits=args.limits)
    trainloader = DataLoader(trainset, batch_size=args.batch_size,
                             shuffle=True, drop_last=True, seed=args.seed,
                             shard=shard)
    valloader = DataLoader(valset, batch_size=min(4, args.batch_size))
    print("Training samples: {0}\nValidation samples: {1}".format(
        len(trainset), len(valset)))

    steps_per_epoch = max(1, len(trainset) // args.batch_size)
    tx = make_optimizer(lr=args.lr, momentum=args.momentum,
                        weight_decay=args.weight_decay,
                        milestones=args.milestones, gamma=0.2,
                        steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, tx, seed=args.seed, device=dev)
    print("Number of model parameters: {}".format(param_count(state.model)))

    if args.pretrain:
        from ...utils.weight_import import (load_pretrained,
                                            resolve_pretrained_path)
        ppath = resolve_pretrained_path(args.arch, args.pretrain)
        if ppath:
            load_pretrained(state.model, ppath, args.arch)
        else:
            print("WARNING: --pretrain given but no local weights found; "
                  "training from scratch")

    best_iou = float("-inf")
    if args.resume:
        state, meta = load_checkpoint(args.resume, state)
        args.start_epoch = meta.get("epoch", 0) or 0
        best_iou = meta.get("best_iou") or float("-inf")
        if meta.get("offsets"):
            offset_list = meta["offsets"]

    loss_fn = get_loss_fn(args.loss)
    local = shard is not None
    train_step = build_train_step(num_classes, num_offsets, alpha=args.alpha,
                                  criterion_ofs=loss_fn, mesh=mesh,
                                  local_batch=local)
    eval_step = build_eval_step(num_classes, num_offsets, alpha=args.alpha,
                                criterion_ofs=loss_fn, mesh=mesh)
    score_step = build_eval_step(num_classes, num_offsets, alpha=args.alpha,
                                 criterion_ofs=loss_fn, mesh=mesh,
                                 local_batch=local)

    iterations = args.start_epoch * steps_per_epoch
    for epoch in range(args.start_epoch, args.epochs):
        state, iterations = train(
            trainloader, state, train_step, args.batch_size, epoch,
            iterations, num_classes=num_classes,
            class_nms=trainset.catNms, offset_list=offset_list,
            print_freq=args.print_freq, log_freq=args.log_freq,
            tensorboard=args.tensorboard, score=args.score,
            eval_step=score_step)
        val_iou = validate(
            valloader, state, eval_step, args.batch_size, epoch,
            iterations, num_classes=num_classes,
            class_nms=trainset.catNms, offset_list=offset_list,
            print_freq=args.print_freq, tensorboard=args.tensorboard,
            score=args.score, pad_to=dp)
        is_best = val_iou > best_iou
        best_iou = max(val_iou, best_iou)
        save_checkpoint(args.dir, state, is_best, epoch=epoch + 1,
                        best_iou=float(best_iou), offsets=offset_list)
    print("Best validation mean iou: ", best_iou)
    finish_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
