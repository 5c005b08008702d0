"""Scoring metrics (`mergenet_tpu.ops.metrics` is the reference): the
semantic-segmentation confusion-matrix scores and the per-offset
sameness IoU.  Updates take channel-last (..., H, W, C) numpy arrays or
tensors; the counting runs where the tensor lies, and only the n x n
confusion counts and the O-long IoU sums come to the host."""

import numpy as np
import torch


class runningScore:
    """Confusion-matrix semantic-seg metrics (overall/mean acc, mean IU,
    fwavacc).  update() takes (..., H, W, C) prob/one-hot planes."""

    def __init__(self, n_classes, class_nms=None):
        self.n_classes = n_classes
        self.class_nms = (class_nms if class_nms is not None
                          else [str(i) for i in range(n_classes)])
        self.confusion_matrix = np.zeros((n_classes, n_classes),
                                         dtype=np.int64)

    def update(self, label_preds, label_truths):
        """The class decision is the channel argmax over the first
        n_classes channels."""
        n = self.n_classes
        pred = torch.as_tensor(label_preds)[..., :n].argmax(-1)
        gt = torch.as_tensor(label_truths, device=pred.device)[..., :n]
        idx = gt.argmax(-1).reshape(-1) * n + pred.reshape(-1)
        self.confusion_matrix += torch.bincount(
            idx, minlength=n * n).reshape(n, n).cpu().numpy()

    def get_scores(self):
        hist = self.confusion_matrix.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                                  - np.diag(hist))
            mean_iu = np.nanmean(iu)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        cls_iu = dict(zip(self.class_nms, iu))
        return {"overall_acc": acc, "mean_acc": acc_cls,
                "freq_acc": fwavacc, "mean_IU": mean_iu}, cls_iu

    def reset(self):
        self.confusion_matrix = np.zeros(
            (self.n_classes, self.n_classes), dtype=np.int64)

    def print_stat(self):
        score, class_iou = self.get_scores()
        print("class\t IoU")
        for class_nm in self.class_nms:
            print("{}\t{}".format(class_nm, class_iou[class_nm]))
        print("mean IoU\t{}".format(score["mean_IU"]))
        print("pixel acc\t{}".format(score["overall_acc"]))


class offsetIoU:
    """IoU of the complemented sameness planes, per offset: how well the
    model finds the 'different' (boundary) pixels."""

    def __init__(self, offset_list):
        self.offset_list = list(offset_list)
        self.num_offsets = len(self.offset_list)
        self.reset()

    def update(self, pred, gt):
        """pred/gt: (..., H, W, O) sameness prob planes (last O channels)."""
        O = self.num_offsets
        p = 1.0 - torch.as_tensor(pred)[..., -O:].double().reshape(-1, O)
        g = 1.0 - torch.as_tensor(gt, device=p.device)[..., -O:].double(
        ).reshape(-1, O)
        intersection = (p * g).sum(0)
        self.intersection += intersection.cpu().numpy()
        self.union += (p.sum(0) + g.sum(0) - intersection).cpu().numpy()

    def reset(self):
        self.intersection = np.zeros(self.num_offsets)
        self.union = np.zeros(self.num_offsets)
        self.iou = np.zeros(self.num_offsets)

    def get_scores(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            self.iou = self.intersection / self.union
        return self.iou, self.iou.mean()

    def print_stat(self):
        iou, miou = self.get_scores()
        print("offset\t IoU")
        for i, offset in enumerate(self.offset_list):
            print("{}\t{}".format(offset, iou[i]))
        print("mean IoU\t {}".format(miou))
