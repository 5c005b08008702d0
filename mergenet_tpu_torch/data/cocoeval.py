"""COCO-style evaluation (mask AP; a copy of
`mergenet_tpu/data/cocoeval.py`) — a from-scratch implementation of the
`COCOeval(..., 'segm')` machinery the evaluate recipes use (reference
`egs/cityscape/local/evaluate.py:67-73`): per-image/category greedy
matching over 10 IoU thresholds, 101-point precision interpolation, and the
standard AP / AP50 / AP75 / APs/m/l / AR summary table.
"""

import copy
import datetime
import time

import numpy as np

from . import rle as maskUtils


class Params:
    def __init__(self, iouType="segm"):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                        [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


class COCOeval:
    def __init__(self, cocoGt=None, cocoDt=None, iouType="segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.evalImgs = {}
        self.eval = {}
        self.stats = []
        self.ious = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # -- per-image preparation ------------------------------------------

    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            if "area" not in gt:
                gt["area"] = maskUtils.area(self.cocoGt.annToRLE(gt))
        self._gts = {}
        self._dts = {}
        for gt in gts:
            self._gts.setdefault(
                (gt["image_id"], gt["category_id"]), []).append(gt)
        for dt in dts:
            self._dts.setdefault(
                (dt["image_id"], dt["category_id"]), []).append(dt)

    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._gts.get((imgId, catId), [])
        dt = self._dts.get((imgId, catId), [])
        if len(gt) == 0 or len(dt) == 0:
            return []
        inds = np.argsort([-d.get("score", 1.0) for d in dt],
                          kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[:p.maxDets[-1]]
        g = [self.cocoGt.annToRLE(o) for o in gt]
        d = [self.cocoDt.annToRLE(o) for o in dt]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        return maskUtils.iou(d, g, iscrowd)

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        gt = self._gts.get((imgId, catId), [])
        dt = self._dts.get((imgId, catId), [])
        if len(gt) == 0 and len(dt) == 0:
            return None
        p = self.params
        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0]
                                 or g["area"] > aRng[1]) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d.get("score", 1.0) for d in dt],
                           kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        ious = self.ious[(imgId, catId)]
        ious = (ious[:, gtind] if len(ious) > 0 else ious)

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) != 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou_best = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if (m > -1 and gtIg[m] == 0 and gtIg[gind] == 1):
                            break
                        if ious[dind, gind] < iou_best:
                            continue
                        iou_best = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape((1, len(dt)))
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId, "category_id": catId, "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm, "gtMatches": gtm,
            "dtScores": [d.get("score", 1.0) for d in dt],
            "gtIgnore": gtIg, "dtIgnore": dtIg,
        }

    def evaluate(self):
        tic = time.time()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {(imgId, catId): self.computeIoU(imgId, catId)
                     for imgId in p.imgIds for catId in catIds}
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds]
        self._paramsEval = copy.deepcopy(self.params)
        print("DONE (t={:0.2f}s).".format(time.time() - tic))

    def accumulate(self, p=None):
        tic = time.time()
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        setK = [k for k in _pe.catIds]
        setA = list(map(tuple, _pe.areaRng))
        setM = _pe.maxDets
        setI = _pe.imgIds
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [n for n, a in enumerate(map(tuple, p.areaRng))
                  if a in setA]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(dtype=np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        tp = np.array(tp)
                        fp = np.array(fp)
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        if nd:
                            recall[t, k, a, m] = rc[-1]
                        else:
                            recall[t, k, a, m] = 0
                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds2 = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds2):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        print("DONE (t={:0.2f}s).".format(time.time() - tic))

    def summarize(self):
        def _summarize(ap=1, iouThr=None, areaRng="all", maxDets=100):
            p = self.params
            iStr = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | "
                    "maxDets={:>3d} ] = {:0.3f}")
            titleStr = "Average Precision" if ap == 1 else "Average Recall"
            typeStr = "(AP)" if ap == 1 else "(AR)"
            iouStr = ("{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                      if iouThr is None else "{:0.2f}".format(iouThr))
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            if ap == 1:
                s = self.eval["precision"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, :, aind, mind]
            else:
                s = self.eval["recall"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, aind, mind]
            if len(s[s > -1]) == 0:
                mean_s = -1
            else:
                mean_s = np.mean(s[s > -1])
            print(iStr.format(titleStr, typeStr, iouStr, areaRng, maxDets,
                              mean_s))
            return mean_s

        p = self.params
        self.stats = np.array([
            _summarize(1),
            _summarize(1, iouThr=0.5, maxDets=p.maxDets[2]),
            _summarize(1, iouThr=0.75, maxDets=p.maxDets[2]),
            _summarize(1, areaRng="small", maxDets=p.maxDets[2]),
            _summarize(1, areaRng="medium", maxDets=p.maxDets[2]),
            _summarize(1, areaRng="large", maxDets=p.maxDets[2]),
            _summarize(0, maxDets=p.maxDets[0]),
            _summarize(0, maxDets=p.maxDets[1]),
            _summarize(0, maxDets=p.maxDets[2]),
            _summarize(0, areaRng="small", maxDets=p.maxDets[2]),
            _summarize(0, areaRng="medium", maxDets=p.maxDets[2]),
            _summarize(0, areaRng="large", maxDets=p.maxDets[2]),
        ])

    def __str__(self):
        self.summarize()
        return ""
