"""Greedy agglomerative merge decoder (host, pure Python/numpy; a copy of
`mergenet_tpu/decoder/segmenter.py`).

Decodes a dense prediction — per-pixel class probabilities `(C, H, W)` and
per-(pixel, offset) sameness probabilities `(O, H, W)` — into an instance
mask by greedily merging the pixel-pair whose merge most improves the total
image log-likelihood:

    total = sum_obj class_logprob(obj)
          + object_merge_factor * ( sum_{same-object (p,o) pairs} log b_{p,o}
                                  + sum_{cross-object pairs} log(1 - b_{p,o}) )

This is a ground-up re-design of the reference decoder
(`utils/segmenter.py:225-578` and `utils/csegment/segment.cc:153-739`): the
reference keeps per-object Python pixel *sets* and hash-map object graphs;
here objects live in flat numpy arrays indexed by a union-find root, so a
merge moves O(1) pixels and the final mask is produced by one `find` pass.
Initialization is fully vectorized.

Priority semantics differ between the two reference implementations (see
SURVEY.md section 2.1); both are supported via `SegmenterOptions`:

  * `den_mode='sum'` (default; matches `segment.cc:145-150`, what the
    Cityscapes recipe runs):
        priority = (oml * object_merge_factor + cdl) / (n1 + n2) + bias
    and a popped record merges only when its recomputed priority equals the
    popped one (`segment.cc:561`).
  * `den_mode='product'` (matches `segmenter.py:189-193`):
        priority = (oml * object_merge_factor + cdl + bias) / (n1 * n2)
    and a popped record merges when recomputed priority >= popped
    (`segmenter.py:470`).
"""

from collections import namedtuple
from heapq import heappush, heappop

import numpy as np

_SegmenterOptionsBase = namedtuple(
    "SegmenterOptions",
    ["same_different_bias", "object_merge_factor", "merge_logprob_bias",
     "den_mode", "remerge_mode", "prune_threshold", "do_prune"])


class SegmenterOptions(_SegmenterOptionsBase):
    """Options for the merge decoder.

    same_different_bias: added to the sameness logit before decoding.
    object_merge_factor: weight on the sameness/differentness term.
    merge_logprob_bias:  constant added to each merge priority.
    den_mode:            'sum' (n1+n2, bias outside the division; the C++
                         recipe behavior) or 'product' (n1*n2, bias inside;
                         the Python reference behavior).
    remerge_mode:        'eq' merge only when recomputed priority == popped
                         ('sum' recipe) or 'ge' when >= popped.
    prune_threshold:     objects whose best-class advantage over background
                         is below this are merged into the background.
    do_prune:            whether to run the prune pass at all (the C++
                         reference does not; the Python reference does).
    """

    def __new__(cls, same_different_bias=0.0, object_merge_factor=1.0,
                merge_logprob_bias=0.0, den_mode="sum", remerge_mode="eq",
                prune_threshold=200.0, do_prune=True):
        assert den_mode in ("sum", "product")
        assert remerge_mode in ("eq", "ge")
        return super().__new__(cls, same_different_bias, object_merge_factor,
                               merge_logprob_bias, den_mode, remerge_mode,
                               prune_threshold, do_prune)


class ObjectSegmenter:
    """Union-find greedy merge decoder.

    Args:
        nnet_class_probs: float array (num_classes, H, W), sigmoid outputs.
        nnet_sameness_probs: float array (num_offsets, H, W).
        num_classes: number of classes including background (class 0).
        offsets: list of (di, dj) integer tuples.
        opts: SegmenterOptions (or None for defaults).
    """

    #: sentinel priority marking a record as dead in the queue
    _TOMBSTONE = -1.0e9

    def __init__(self, nnet_class_probs, nnet_sameness_probs, num_classes,
                 offsets, opts=None, verbose=0):
        self.opts = opts if opts is not None else SegmenterOptions()
        self.verbose = verbose
        eps = float(np.finfo(np.float32).eps)
        class_probs = np.asarray(
            nnet_class_probs, dtype=np.float64).clip(eps, 1.0 - eps)
        sameness = np.asarray(
            nnet_sameness_probs, dtype=np.float64).clip(eps, 1.0 - eps)
        if self.opts.same_different_bias != 0.0:
            logit = (np.log(sameness) - np.log1p(-sameness)
                     + self.opts.same_different_bias)
            sameness = (1.0 / (1.0 + np.exp(-logit))).clip(eps, 1.0 - eps)

        self.num_classes = num_classes
        self.offsets = list(offsets)
        C, H, W = class_probs.shape
        O = sameness.shape[0]
        assert C == num_classes, (C, num_classes)
        assert O == len(self.offsets)
        assert sameness.shape[1:] == (H, W)
        self.H, self.W = H, W
        N = H * W

        # --- flat per-pixel log-probs ---------------------------------
        # (N, C) class logprobs; (O, N) same / different logprobs
        self.pixel_class_logprobs = np.log(class_probs).reshape(C, N).T.copy()
        self.log_same = np.log(sameness).reshape(O, N)
        self.log_diff = np.log1p(-sameness).reshape(O, N)

        # --- union-find over pixels ------------------------------------
        self.parent = np.arange(N, dtype=np.int64)
        self.n_alive = N

        # --- per-root object stats (dense arrays indexed by root) ------
        self.obj_size = np.ones(N, dtype=np.int64)
        self.obj_class_logprobs = self.pixel_class_logprobs.copy()
        self.obj_class = np.argmax(self.obj_class_logprobs, axis=1)
        self.obj_best_logprob = self.obj_class_logprobs[
            np.arange(N), self.obj_class]
        self.obj_sameness = np.zeros(N, dtype=np.float64)  # internal edges

        # --- adjacency records ------------------------------------------
        # records[key] = [oml, sameness_lp, differentness_lp, priority]
        # key = (root_a, root_b) with root_a < root_b
        self.records = {}
        # nbrs[root] = set of neighbor roots
        self.nbrs = [set() for _ in range(N)]
        self.queue = []  # heap of (-priority, key)

        self._init_records()

    # -- vectorized initialization ------------------------------------

    def _init_records(self):
        H, W, N = self.H, self.W, self.H * self.W
        rows = np.arange(H)[:, None]
        cols = np.arange(W)[None, :]
        cls_lp = self.pixel_class_logprobs  # (N, C)
        best = self.obj_best_logprob  # (N,)
        for oi, (di, dj) in enumerate(self.offsets):
            r2 = rows + di
            c2 = cols + dj
            valid = ((r2 >= 0) & (r2 < H) & (c2 >= 0) & (c2 < W))
            src = (rows * W + cols)[valid]  # pixel p
            dst = (r2 * W + c2)[valid]      # pixel p + o
            ls = self.log_same[oi].reshape(H, W)[valid]
            ld = self.log_diff[oi].reshape(H, W)[valid]
            oml = ls - ld
            # class delta: max_c(lp_a + lp_b) - best_a - best_b
            joint = cls_lp[src] + cls_lp[dst]
            cdl = joint.max(axis=1) - best[src] - best[dst]
            pri = self._priority_vec(oml, cdl, 1, 1)
            a = np.minimum(src, dst)
            b = np.maximum(src, dst)
            for k in range(src.shape[0]):
                key = (int(a[k]), int(b[k]))
                # offsets are unique & never negated-pairs, so each unordered
                # pixel pair appears at most once across all offsets
                rec = [float(oml[k]), float(ls[k]), float(ld[k]),
                       float(pri[k])]
                self.records[key] = rec
                self.nbrs[key[0]].add(key[1])
                self.nbrs[key[1]].add(key[0])
                if rec[3] >= 0:
                    heappush(self.queue, (-rec[3], key))

    # -- priority -------------------------------------------------------

    def _priority_vec(self, oml, cdl, n1, n2):
        f = self.opts.object_merge_factor
        bias = self.opts.merge_logprob_bias
        if self.opts.den_mode == "sum":
            return (oml * f + cdl) / (n1 + n2) + bias
        return (oml * f + cdl + bias) / (n1 * n2)

    def _compute_priority(self, key):
        """Recompute class_delta_logprob + merge priority for a record.

        Returns (priority, merged_class)."""
        a, b = key
        rec = self.records[key]
        ca, cb = self.obj_class[a], self.obj_class[b]
        if ca == cb:
            cdl, merged_class = 0.0, int(ca)
        else:
            joint = self.obj_class_logprobs[a] + self.obj_class_logprobs[b]
            merged_class = int(np.argmax(joint))
            cdl = (joint[merged_class]
                   - self.obj_best_logprob[a] - self.obj_best_logprob[b])
        pri = float(self._priority_vec(
            rec[0], cdl, int(self.obj_size[a]), int(self.obj_size[b])))
        return pri, merged_class

    # -- union-find -----------------------------------------------------

    def find(self, x):
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    # -- main loop -------------------------------------------------------

    def run_segmentation(self):
        """Run the greedy merge; returns (mask, object_class).

        mask: (H, W) int array with instance ids 1..K (0 = background).
        object_class: list of length K; object_class[k-1] is the class of
        instance k.
        """
        merge_on_ge = self.opts.remerge_mode == "ge"
        queue, records = self.queue, self.records
        n = 0
        while queue:
            neg_pri, key = heappop(queue)
            popped_pri = -neg_pri
            rec = records.get(key)
            if rec is None or rec[3] != popped_pri:
                continue  # stale entry; the live one is elsewhere in the heap
            n += 1
            new_pri, merged_class = self._compute_priority(key)
            rec[3] = new_pri
            do_merge = (new_pri >= popped_pri) if merge_on_ge \
                else (new_pri == popped_pri)
            if do_merge:
                self._merge(key, merged_class)
            elif new_pri >= 0:
                heappush(queue, (-new_pri, key))
        if self.verbose >= 1:
            print("Finished. Queue is empty after {} pops; {} objects "
                  "remain.".format(n, self.n_alive))
        if self.opts.do_prune:
            self.prune(self.opts.prune_threshold)
        return self.output_mask()

    def _merge(self, key, merged_class):
        a, b = key
        # assimilate the smaller object into the larger
        if self.obj_size[b] > self.obj_size[a]:
            a, b = b, a
        rec = self.records.pop(key)
        self.nbrs[a].discard(b)
        self.nbrs[b].discard(a)

        # update stats on the surviving root `a`
        self.obj_class[a] = merged_class
        self.obj_size[a] += self.obj_size[b]
        self.obj_class_logprobs[a] += self.obj_class_logprobs[b]
        self.obj_best_logprob[a] = self.obj_class_logprobs[a][merged_class]
        self.obj_sameness[a] += rec[1] + self.obj_sameness[b]
        self.parent[b] = a
        self.n_alive -= 1

        # re-point b's adjacency records at a, coalescing duplicates
        for c in self.nbrs[b]:
            old_key = (b, c) if b < c else (c, b)
            old_rec = self.records.pop(old_key)
            self.nbrs[c].discard(b)
            new_key = (a, c) if a < c else (c, a)
            existing = self.records.get(new_key)
            if existing is not None:
                # coalesce: sum the logprob accumulators
                existing[0] += old_rec[0]
                existing[1] += old_rec[1]
                existing[2] += old_rec[2]
                rec_now = existing
            else:
                self.records[new_key] = old_rec
                self.nbrs[a].add(c)
                self.nbrs[c].add(a)
                rec_now = old_rec
            new_pri, _ = self._compute_priority(new_key)
            rec_now[3] = new_pri
            if new_pri >= 0:
                heappush(self.queue, (-new_pri, new_key))
        self.nbrs[b] = set()

    # -- post-processing --------------------------------------------------

    def _alive_roots(self):
        N = self.H * self.W
        return [i for i in range(N) if self.parent[i] == i]

    def prune(self, threshold=200.0):
        """Merge weak objects into the biggest background object: any object
        whose best-class logprob advantage over background (class 0) is
        below `threshold` becomes background."""
        roots = self._alive_roots()
        bg = None
        bg_size = -1
        for r in roots:
            if self.obj_class[r] == 0 and self.obj_size[r] > bg_size:
                bg, bg_size = r, int(self.obj_size[r])
        if bg is None:
            return
        pruned = 0
        for r in roots:
            if r == bg:
                continue
            advantage = (self.obj_best_logprob[r]
                         - self.obj_class_logprobs[r][0])
            if advantage < threshold:
                self.parent[r] = bg
                self.obj_size[bg] += self.obj_size[r]
                self.n_alive -= 1
                pruned += 1
        if self.verbose >= 1:
            print("Pruned {} objects (merged into background). Final "
                  "objects: {}".format(pruned, self.n_alive))

    def output_mask(self):
        """Label alive non-background objects 1..K; return (mask, classes)."""
        N = self.H * self.W
        # full path-compression pass, vectorized-ish
        root = np.empty(N, dtype=np.int64)
        for i in range(N):
            root[i] = self.find(i)
        ids = np.zeros(N, dtype=np.int64)  # root -> instance id
        object_class = []
        k = 1
        for r in range(N):
            if self.parent[r] == r and self.obj_class[r] != 0:
                ids[r] = k
                object_class.append(int(self.obj_class[r]))
                k += 1
        mask = ids[root].reshape(self.H, self.W).astype(int)
        return mask, object_class

    # -- debugging ---------------------------------------------------------

    def show_stats(self):
        """Print object/record/queue statistics (reference
        segmenter.py:297-310)."""
        print("Total logprob: {:.3f}".format(self.compute_total_logprob()))
        print("Total number of objects: {}".format(self.n_alive))
        print("Total number of adjacency records: {}".format(
            len(self.records)))
        print("Total number of records in the queue: {}".format(
            len(self.queue)))
        sizes = sorted((int(self.obj_size[r]) for r in self._alive_roots()),
                       reverse=True)
        print("Top 10 biggest objs (#pixels): {}".format(sizes[:10]))
        adj = sorted((len(self.nbrs[r]) for r in self._alive_roots()),
                     reverse=True)
        print("Top 10 biggest objs (adj_list size): {}".format(adj[:10]))

    def compute_total_logprob(self):
        """Total objective from incrementally-maintained stats."""
        roots = self._alive_roots()
        tot_class = sum(float(self.obj_best_logprob[r]) for r in roots)
        tot_same = sum(float(self.obj_sameness[r]) for r in roots)
        tot_diff = sum(rec[2] for rec in self.records.values())
        return tot_class + (tot_same + tot_diff) * \
            self.opts.object_merge_factor

    def compute_total_logprob_from_scratch(self):
        """Total objective recomputed from the label map — checks the
        incremental bookkeeping (reference `segmenter.py:312-349`)."""
        N = self.H * self.W
        root = np.empty(N, dtype=np.int64)
        for i in range(N):
            root[i] = self.find(i)
        tot_class = 0.0
        for r in self._alive_roots():
            member = np.flatnonzero(root == r)
            tot_class += float(
                self.pixel_class_logprobs[member, self.obj_class[r]].sum())
        lbl = root.reshape(self.H, self.W)
        tot_same = tot_diff = 0.0
        H, W = self.H, self.W
        for oi, (di, dj) in enumerate(self.offsets):
            rows = np.arange(H)[:, None]
            cols = np.arange(W)[None, :]
            r2, c2 = rows + di, cols + dj
            valid = (r2 >= 0) & (r2 < H) & (c2 >= 0) & (c2 < W)
            src = (rows * W + cols)[valid]
            dst = (r2 * W + c2)[valid]
            same = root[src] == root[dst]
            ls = self.log_same[oi][src]
            ld = self.log_diff[oi][src]
            tot_same += float(ls[same].sum())
            tot_diff += float(ld[~same].sum())
        return tot_class + (tot_same + tot_diff) * \
            self.opts.object_merge_factor

    def debug(self):
        """Invariant checks: adjacency symmetry + sampled oml recompute."""
        # adjacency symmetry
        tot = sum(len(s) for s in self.nbrs)
        assert tot == 2 * len(self.records), (tot, len(self.records))
        # every record endpoint is an alive root
        for (a, b) in self.records:
            assert self.parent[a] == a and self.parent[b] == b
        # recompute a sample of omls from scratch
        N = self.H * self.W
        root = np.empty(N, dtype=np.int64)
        for i in range(N):
            root[i] = self.find(i)
        keys = list(self.records.keys())
        if not keys:
            return True
        rng = np.random.RandomState(0)
        sample = [keys[i] for i in
                  rng.choice(len(keys), size=min(16, len(keys)),
                             replace=False)]
        H, W = self.H, self.W
        for key in sample:
            a, b = key
            oml = 0.0
            for oi, (di, dj) in enumerate(self.offsets):
                rows = np.arange(H)[:, None]
                cols = np.arange(W)[None, :]
                r2, c2 = rows + di, cols + dj
                valid = (r2 >= 0) & (r2 < H) & (c2 >= 0) & (c2 < W)
                src = (rows * W + cols)[valid]
                dst = (r2 * W + c2)[valid]
                hit = (((root[src] == a) & (root[dst] == b)) |
                       ((root[src] == b) & (root[dst] == a)))
                oml += float((self.log_same[oi][src][hit]
                              - self.log_diff[oi][src][hit]).sum())
            assert abs(oml - self.records[key][0]) < 1e-3, \
                (key, oml, self.records[key][0])
        return True
