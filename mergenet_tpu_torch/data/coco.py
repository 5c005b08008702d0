"""COCO-json dataset API (a copy of `mergenet_tpu/data/coco.py`) — a
pycocotools-free reimplementation of the subset of `pycocotools.coco.COCO`
the pipeline uses (the environment has no pycocotools).  JSON format and
query semantics follow the COCO spec.
"""

import json
import time
from collections import defaultdict

import numpy as np

from . import rle as maskUtils


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            t0 = time.time()
            with open(annotation_file) as f:
                dataset = json.load(f)
            assert isinstance(dataset, dict), \
                "annotation file format {} not supported".format(
                    type(dataset))
            print("Done loading annotations (t={:0.2f}s)".format(
                time.time() - t0))
            self.dataset = dataset
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns = anns
        self.imgs = imgs
        self.cats = cats
        self.imgToAnns = imgToAnns
        self.catToImgs = catToImgs

    # -- queries ---------------------------------------------------------

    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                lists = [self.imgToAnns[i] for i in imgIds
                         if i in self.imgToAnns]
                anns = [a for sub in lists for a in sub]
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                anns = [a for a in anns if a["category_id"] in catIds]
            if len(areaRng) > 0:
                anns = [a for a in anns
                        if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        catNms = catNms if isinstance(catNms, (list, tuple)) else [catNms]
        supNms = supNms if isinstance(supNms, (list, tuple)) else [supNms]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        cats = self.dataset.get("categories", [])
        if len(catNms) > 0:
            cats = [c for c in cats if c["name"] in catNms]
        if len(supNms) > 0:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if len(catIds) > 0:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if len(imgIds) == len(catIds) == 0:
            return list(self.imgs.keys())
        ids = set(imgIds)
        for i, catId in enumerate(catIds):
            if i == 0 and len(ids) == 0:
                ids = set(self.catToImgs[catId])
            else:
                ids &= set(self.catToImgs[catId])
        return list(ids)

    def loadAnns(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.imgs[i] for i in ids]

    # -- results ---------------------------------------------------------

    def loadRes(self, resFile):
        """Load result anns (list of dicts or a json path) into a new COCO
        object sharing this one's images/categories."""
        res = COCO()
        res.dataset["images"] = [img for img in
                                 self.dataset.get("images", [])]
        res.dataset["categories"] = [c for c in
                                     self.dataset.get("categories", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = list(resFile)
        assert isinstance(anns, list)
        for i, ann in enumerate(anns):
            if "segmentation" in ann and "area" not in ann:
                ann["area"] = maskUtils.area(ann["segmentation"])
            if "iscrowd" not in ann:
                ann["iscrowd"] = 0
            ann["id"] = i + 1
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    # -- masks -----------------------------------------------------------

    def annToRLE(self, ann):
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = maskUtils.frPyObjects(segm, h, w)
            return maskUtils.merge(rles)
        if isinstance(segm.get("counts"), list):
            return maskUtils.frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann):
        return maskUtils.decode(self.annToRLE(ann))
