"""What the recipes share: the device flag, the process group under
`torchrun`, building a model and loading its checkpoint, the decoder
dispatch, COCO results and their evaluation."""

import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ..data import rle as maskUtils
from ..data.coco import COCO
from ..data.cocoeval import COCOeval
from ..models import get_model
from ..parallel import (create_train_state, data_axis_for_batch,
                        make_mesh, make_optimizer)
from ..utils.checkpoint import load_checkpoint


def add_device_flag(parser):
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (default cuda; "
                             "'cpu' to run without a GPU)")


def compute_dtype(bf16):
    return torch.bfloat16 if bf16 else None


def float32_convs():
    """float32 arithmetic in every matmul and convolution (TF32 off, as
    the reference computes float32): a recipe's maps and losses do not
    depend on the card's TF32 default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_distributed(device):
    """Join the process group `torchrun` describes in the environment
    (NCCL on the card, gloo on the CPU); returns whether there is one."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo")
    return True


def finish_distributed():
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def recipe_mesh(batch_size, device):
    """(mesh, data axis) of a training recipe: under `torchrun` the data
    mesh over every rank, whose count must divide the batch (the
    reference's `data_axis_for_batch` sub-mesh idles the devices it
    leaves out; here every rank is a process that must take a shard);
    without it no mesh."""
    if not init_distributed(device):
        return None, 1
    world = dist.get_world_size()
    dp = data_axis_for_batch(batch_size, world)
    if dp != world:
        raise SystemExit("--batch-size %d does not divide over %d ranks: "
                         "launch %d processes" % (batch_size, world, dp))
    dev = None if torch.device(device).type == "cuda" else device
    return make_mesh(data=dp, device=dev), dp


def rank_shard(mesh):
    """The training loaders' shard of this rank, `(rank, world)`: each
    rank loads only its slice of every global batch and the steps take
    it as it is (`local_batch`); None without a mesh."""
    return None if mesh is None else (mesh.rank, mesh.world)


def rank_seed(seed, mesh):
    """The crop seed of this rank's training set: `seed` on rank 0 and
    without a mesh, a stream of its own on every other rank (ranks that
    crop in step must not draw the same crops)."""
    return seed if mesh is None else seed + 1000003 * mesh.rank


def is_primary(mesh):
    """Whether this process writes the run's logs: rank 0, or the only
    process."""
    return mesh is None or mesh.rank == 0


def load_model(num_classes, num_offsets, arch, checkpoint, device,
               bf16=False):
    """The `arch` model holding `checkpoint` (a port checkpoint file or
    experiment directory) on `device`; returns (state, meta)."""
    float32_convs()
    model = get_model(num_classes, num_offsets, arch,
                      dtype=compute_dtype(bf16))
    state = create_train_state(model, make_optimizer(), device=device)
    if checkpoint is None:
        return state, {}
    return load_checkpoint(checkpoint, state)


def write_offsets(exp_dir, offsets):
    """Record the offset net's `offsets` beside its maps in
    `exp_dir`/npy, where `read_offsets` finds them."""
    os.makedirs(os.path.join(exp_dir, "npy"), exist_ok=True)
    with open(os.path.join(exp_dir, "npy", "offsets.json"), "w") as f:
        json.dump({"offsets": [list(o) for o in offsets]}, f)


def read_offsets(exp_dir):
    """The offsets `write_offsets` recorded in `exp_dir`/npy."""
    path = os.path.join(exp_dir, "npy", "offsets.json")
    if not os.path.isfile(path):
        raise SystemExit("%s is missing: the offset maps come from the "
                         "port's offset_infer, which records the offsets "
                         "of the net that made them" % path)
    with open(path) as f:
        return [tuple(o) for o in json.load(f)["offsets"]]


def decode(decoder, class_mask, bound_mask, num_classes, offset_list,
           same_different_bias, object_merge_factor, merge_logprob_bias,
           device, prune_threshold=None):
    """Decode (C, H, W) class and (O, H, W) sameness maps with `decoder`
    ('device', 'device-exact', 'cpp', 'python'); returns (mask,
    object_class).  A `prune_threshold` is the COCO recipe's setting:
    pruning on, and the Python greedy's product denominators and 'ge'
    remerges; without one, the Cityscapes recipe's (no pruning)."""
    kw = dict(same_different_bias=same_different_bias,
              object_merge_factor=object_merge_factor,
              merge_logprob_bias=merge_logprob_bias)
    prune = {} if prune_threshold is None else dict(
        do_prune=True, prune_threshold=prune_threshold)
    if decoder in ("device", "device-exact"):
        from ..decoder.device import run_segmentation_device
        mask, classes = run_segmentation_device(
            class_mask, bound_mask, num_classes, offset_list, **kw,
            **prune, mode="hier" if decoder == "device" else "exact",
            device=device)
        return np.asarray(mask), classes
    if decoder == "cpp":
        from ..decoder import csegment
        return csegment.run_segmentation(class_mask, bound_mask,
                                         num_classes, offset_list, **kw,
                                         **prune)
    from ..decoder import ObjectSegmenter, SegmenterOptions
    opts = (SegmenterOptions(**kw, do_prune=False) if prune_threshold is None
            else SegmenterOptions(**kw, den_mode="product",
                                  remerge_mode="ge",
                                  prune_threshold=prune_threshold))
    seg = ObjectSegmenter(class_mask, bound_mask, num_classes, offset_list,
                          opts)
    return seg.run_segmentation()


def convert_to_coco_result(mask, object_class, image_id, catIds):
    """Instance mask -> list of COCO result dicts (RLE-encoded)."""
    results = []
    for i in range(1, int(mask.max()) + 1):
        b_mask = (mask == i).astype("uint8")
        results.append({
            "image_id": image_id,
            "score": 1,
            "category_id": catIds[object_class[i - 1]],
            "segmentation": maskUtils.encode(np.asfortranarray(b_mask)),
        })
    return results


def read_results(segment_dir, imgid=None):
    """The result dicts of every `<id>.pkl` under `segment_dir`/pkl (or
    of `imgid` only), empty segments dropped."""
    pkl_dir = os.path.join(segment_dir, "pkl")
    results = []
    for fname in sorted(os.listdir(pkl_dir)):
        if not fname.endswith(".pkl"):
            continue
        if imgid is not None and fname != "{}.pkl".format(imgid):
            continue
        with open(os.path.join(pkl_dir, fname), "rb") as fh:
            for ann in pickle.load(fh):
                if maskUtils.area(ann["segmentation"]) == 0:
                    continue
                results.append(ann)
    return results


def evaluate(coco, segment_dir, catIds=None, imgid=None):
    """COCO-style mask AP of the results under `segment_dir` (printed);
    returns the summary stats."""
    results = read_results(segment_dir, imgid)
    print("Evaluating {} detections".format(len(results)))
    E = COCOeval(coco, coco.loadRes(results), "segm")
    if catIds:
        E.params.catIds = catIds
    if imgid is not None:
        E.params.imgIds = [imgid]
    E.evaluate()
    E.accumulate()
    E.summarize()
    return E.stats


__all__ = ["COCO", "add_device_flag", "compute_dtype", "float32_convs",
           "init_distributed", "finish_distributed",
           "recipe_mesh", "rank_shard", "rank_seed", "is_primary",
           "load_model", "write_offsets", "read_offsets",
           "decode", "convert_to_coco_result",
           "read_results", "evaluate"]
