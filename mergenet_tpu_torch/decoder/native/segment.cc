// mergenet_tpu native merge decoder.
//
// Greedy agglomerative instance-segmentation decode: start from per-pixel
// objects, repeatedly merge the object pair with the best (non-negative)
// log-likelihood-gain priority until none remains.
//
// This is a ground-up re-design of the reference decoder
// (reference: utils/csegment/segment.{h,cc}).  Differences in engineering
// (same algorithm/objective):
//   * pixels are tracked by a union-find array, not per-object hash sets;
//     a merge moves O(1) pixel state and the output mask is one find() pass.
//   * objects live in flat arrays indexed by union-find root (size, class
//     logprobs, best class) — no per-object heap allocations.
//   * adjacency is IMPLICIT for the initial offset grid: the record for
//     pixel pair (p, p+offset_o) lives at the fixed slot o*N + p, so init
//     performs ZERO hash-map operations (the per-pixel unordered_map design
//     cost ~10M emplaces at 512x1024 and dominated the old decode time).
//     Only records REKEYED by merges enter a single global open-addressing
//     (pair -> record) table; each root keeps a plain vector of such mapped
//     neighbors.  Stale/duplicate list entries are skipped via the map.
//   * the priority queue stores (priority, record_index); staleness is
//     detected by comparing the popped priority to the record's current
//     priority (exact float equality, as in the reference).
//
// Both reference priority semantics are supported (see segmenter.py /
// SURVEY.md section 2.1): den_mode 0 = 'sum' (priority = (oml*f + cdl)/
// (n1+n2) + bias; merge on recompute == popped) matching segment.cc:145-150,
// and den_mode 1 = 'product' ((oml*f + cdl + bias)/(n1*n2); merge on
// recompute >= popped) matching segmenter.py:189-193.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC segment.cc -o libmergenet_segment.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <limits>
#include <thread>
#include <vector>

namespace {

using std::size_t;

struct Options {
  float same_different_bias = 0.0f;
  float object_merge_factor = 1.0f;
  float merge_logprob_bias = 0.0f;
  int den_mode = 0;      // 0 = sum (+bias outside), 1 = product (bias inside)
  int remerge_mode = 0;  // 0 = merge on ==, 1 = merge on >=
  int do_prune = 1;
  float prune_threshold = 200.0f;
};

// Record state is split SoA-style: the 16-byte hot part is touched on
// every queue pop (the staleness check dominates pop-path memory
// traffic), the 24-byte accumulators only on recompute/merge.
struct RecHot {
  double pri;    // current merge priority
  int32_t a, b;  // live roots (a < b), or -1 when dead
};

struct RecAcc {
  double oml;   // sum over linking (pixel,offset) pairs of log(b/(1-b))
  double same;  // sum of log(b)
  double diff;  // sum of log(1-b)
};

// Open-addressing hash map from a packed (a < b) root pair to a record
// index.  Linear probing with backward-shift deletion (no tombstones).
class PairMap {
 public:
  explicit PairMap(size_t initial_pow2 = 1 << 16) { rehash(initial_pow2); }

  static inline uint64_t pack(int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
  }

  int32_t find(uint64_t key) const {
    size_t i = slot(key);
    while (keys_[i] != kEmpty) {
      if (keys_[i] == key) return vals_[i];
      i = (i + 1) & mask_;
    }
    return -1;
  }

  void insert(uint64_t key, int32_t val) {
    if ((size_ + 1) * 10 >= (mask_ + 1) * 6) rehash((mask_ + 1) * 2);
    size_t i = slot(key);
    while (keys_[i] != kEmpty) {
      if (keys_[i] == key) { vals_[i] = val; return; }
      i = (i + 1) & mask_;
    }
    keys_[i] = key;
    vals_[i] = val;
    ++size_;
  }

  void erase(uint64_t key) {
    size_t i = slot(key);
    while (keys_[i] != kEmpty) {
      if (keys_[i] == key) break;
      i = (i + 1) & mask_;
    }
    if (keys_[i] == kEmpty) return;
    // backward-shift deletion keeps probe chains intact without tombstones
    size_t hole = i;
    size_t j = (i + 1) & mask_;
    while (keys_[j] != kEmpty) {
      size_t home = slot(keys_[j]);
      // can keys_[j] legally move into the hole?  yes iff the hole lies
      // cyclically within [home, j]
      bool movable = ((j - home) & mask_) >= ((j - hole) & mask_);
      if (movable) {
        keys_[hole] = keys_[j];
        vals_[hole] = vals_[j];
        hole = j;
      }
      j = (j + 1) & mask_;
    }
    keys_[hole] = kEmpty;
    --size_;
  }

 private:
  static constexpr uint64_t kEmpty = ~uint64_t{0};

  inline size_t slot(uint64_t k) const {
    // splitmix64 finalizer
    k ^= k >> 30;
    k *= 0xbf58476d1ce4e5b9ULL;
    k ^= k >> 27;
    k *= 0x94d049bb133111ebULL;
    k ^= k >> 31;
    return static_cast<size_t>(k) & mask_;
  }

  void rehash(size_t cap) {
    std::vector<uint64_t> old_keys = std::move(keys_);
    std::vector<int32_t> old_vals = std::move(vals_);
    keys_.assign(cap, kEmpty);
    vals_.assign(cap, -1);
    mask_ = cap - 1;
    size_ = 0;
    for (size_t i = 0; i < old_keys.size(); ++i)
      if (old_keys[i] != kEmpty) insert(old_keys[i], old_vals[i]);
  }

  std::vector<uint64_t> keys_;
  std::vector<int32_t> vals_;
  size_t mask_ = 0;
  size_t size_ = 0;
};


// 4-ary max-heap of (priority, record) — fewer sift levels and better
// cache behavior than the binary std::priority_queue under this
// workload's push-heavy churn (~40% of decode time in heap sifts).
class MergeQueue {
 public:
  using Entry = std::pair<double, int32_t>;

  void build(std::vector<Entry>&& v) {
    h_ = std::move(v);
    if (h_.size() > 1)
      for (int64_t i = (static_cast<int64_t>(h_.size()) - 2) / 4; i >= 0;
           --i)
        sift_down(static_cast<size_t>(i));
  }

  bool empty() const { return h_.empty(); }
  const Entry& top() const { return h_.front(); }

  void push(Entry e) {
    h_.push_back(e);
    size_t i = h_.size() - 1;
    while (i > 0) {
      size_t parent = (i - 1) / 4;
      if (h_[parent] < h_[i]) {
        std::swap(h_[parent], h_[i]);
        i = parent;
      } else {
        break;
      }
    }
  }

  void pop() {
    h_.front() = h_.back();
    h_.pop_back();
    if (!h_.empty()) sift_down(0);
  }

 private:
  void sift_down(size_t i) {
    const size_t n = h_.size();
    for (;;) {
      const size_t c0 = 4 * i + 1;
      if (c0 >= n) return;
      size_t best = c0;
      const size_t c_end = std::min(c0 + 4, n);
      for (size_t c = c0 + 1; c < c_end; ++c)
        if (h_[best] < h_[c]) best = c;
      if (h_[i] < h_[best]) {
        std::swap(h_[i], h_[best]);
        i = best;
      } else {
        return;
      }
    }
  }

  std::vector<Entry> h_;
};

class Segmenter {
 public:
  Segmenter(const float* class_probs, int num_classes,
            const float* sameness_probs, int num_offsets,
            int height, int width, const int* offsets, const Options& opts)
      : C_(num_classes), O_(num_offsets), H_(height), W_(width),
        N_(static_cast<int64_t>(height) * width), opts_(opts) {
    offsets_.assign(offsets, offsets + 2 * num_offsets);
    // |pixel-id delta| of each offset.  NOT necessarily unique: distinct
    // valid offsets can alias to the same |di*W + dj| at small widths
    // (production CoreConfig offsets with |dj| <= 80 never alias at
    // W >= 512).  Aliased offsets tile COMPLEMENTARY column windows, so
    // init still creates each pixel pair at most once; find_record scans
    // every aliased slot.
    for (int o = 0; o < O_; ++o) {
      int64_t d = static_cast<int64_t>(offsets_[2 * o]) * W_ +
                  offsets_[2 * o + 1];
      deltas_.push_back(d);
    }

    const double eps = 1.1920929e-07;  // float32 machine epsilon
    // per-pixel class logprobs, (N, C) layout for cache-friendly row access
    cls_lp_.resize(N_ * C_);
    for (int c = 0; c < C_; ++c) {
      const float* src = class_probs + static_cast<int64_t>(c) * N_;
      for (int64_t p = 0; p < N_; ++p) {
        double v = src[p];
        v = std::min(std::max(v, eps), 1.0 - eps);
        cls_lp_[p * C_ + c] = std::log(v);
      }
    }

    parent_.resize(N_);
    for (int64_t i = 0; i < N_; ++i) parent_[i] = static_cast<int32_t>(i);
    obj_size_.assign(N_, 1);
    obj_cls_lp_ = cls_lp_;  // per-root accumulators start as per-pixel
    obj_class_.resize(N_);
    obj_best_.resize(N_);
    for (int64_t p = 0; p < N_; ++p) {
      const double* row = &obj_cls_lp_[p * C_];
      int best = 0;
      for (int c = 1; c < C_; ++c)
        if (row[c] > row[best]) best = c;
      obj_class_[p] = best;
      obj_best_[p] = row[best];
    }
    mapped_nbrs_.resize(N_);
    obj_sameness_.assign(N_, 0.0);
    n_alive_ = N_;

    init_records(sameness_probs, eps);
  }

  void run() {
    while (!queue_.empty()) {
      auto top = queue_.top();
      queue_.pop();
      double popped = top.first;
      int32_t ri = top.second;
      RecHot& r = hot_[ri];
      if (r.a < 0 || r.pri != popped) continue;  // dead or stale
      int merged_class;
      double new_pri = compute_priority(r.a, r.b, acc_[ri].oml,
                                        &merged_class);
      r.pri = new_pri;
      bool do_merge = opts_.remerge_mode == 0 ? (new_pri == popped)
                                              : (new_pri >= popped);
      if (do_merge) {
        merge(ri, merged_class);
      } else if (new_pri >= 0.0) {
        queue_.push({new_pri, ri});
      }
    }
    if (opts_.do_prune) prune(opts_.prune_threshold);
  }

  // Writes instance ids 1..K into mask (H*W int32, 0 = background) and the
  // per-instance class into object_class (terminated by -1; when all H*W
  // pixels end as instance roots the buffer is exactly full and no
  // terminator is written — the ctypes bridge prefills the buffer with -1
  // and also stops at its end, csegment.py:101,114-117).
  void output(int32_t* mask, int32_t* object_class) {
    std::vector<int32_t> inst(N_, 0);
    int32_t k = 1;
    for (int64_t r = 0; r < N_; ++r) {
      if (parent_[r] == r && obj_class_[r] != 0) {
        inst[r] = k;
        object_class[k - 1] = obj_class_[r];
        ++k;
      }
    }
    if (k - 1 < N_) object_class[k - 1] = -1;
    for (int64_t p = 0; p < N_; ++p) mask[p] = inst[find(static_cast<int32_t>(p))];
  }

  double total_logprob() {
    double tot_class = 0.0, tot_same = 0.0, tot_diff = 0.0;
    for (int64_t r = 0; r < N_; ++r) {
      if (parent_[r] != r) continue;
      tot_class += obj_best_[r];
      tot_same += obj_sameness_[r];
    }
    for (size_t i = 0; i < hot_.size(); ++i)
      if (hot_[i].a >= 0) tot_diff += acc_[i].diff;
    return tot_class + (tot_same + tot_diff) * opts_.object_merge_factor;
  }

 private:
  void init_records(const float* sameness_probs, double eps) {
    // Fixed-slot layout: the record for (pixel p, offset o) lives at
    // o*N + p; out-of-bounds slots stay dead (a = -1).  Each unordered
    // pixel pair appears at most one slot: offsets are distinct and
    // never negated pairs (CoreConfig validation), and same-|delta|
    // aliases (small-W only, see ctor) cover complementary column
    // windows.  No adjacency structure is built: a singleton's
    // neighbors are enumerated from the offset grid on demand.
    RecHot dead_h;
    dead_h.pri = 0.0;
    dead_h.a = dead_h.b = -1;
    hot_.assign(static_cast<size_t>(N_) * O_, dead_h);
    acc_.assign(static_cast<size_t>(N_) * O_, RecAcc{0.0, 0.0, 0.0});

    std::vector<std::pair<double, int32_t>> heap_init;
    heap_init.reserve(static_cast<size_t>(N_) * O_ / 2);
    const double sdb = opts_.same_different_bias;
    for (int o = 0; o < O_; ++o) {
      const int di = offsets_[2 * o], dj = offsets_[2 * o + 1];
      const float* src = sameness_probs + static_cast<int64_t>(o) * N_;
      RecHot* slab_h = hot_.data() + static_cast<int64_t>(o) * N_;
      RecAcc* slab_a = acc_.data() + static_cast<int64_t>(o) * N_;
      for (int row = 0; row < H_; ++row) {
        const int r2 = row + di;
        if (r2 < 0 || r2 >= H_) continue;
        const int c_lo = std::max(0, -dj), c_hi = std::min(W_, W_ - dj);
        for (int col = c_lo; col < c_hi; ++col) {
          const int32_t p = row * W_ + col;
          const int32_t q = r2 * W_ + (col + dj);
          double v = src[p];
          v = std::min(std::max(v, eps), 1.0 - eps);
          if (sdb != 0.0) {
            double logit = std::log(v) - std::log1p(-v) + sdb;
            v = 1.0 / (1.0 + std::exp(-logit));
            v = std::min(std::max(v, eps), 1.0 - eps);
          }
          RecAcc& ra = slab_a[p];
          RecHot& rh = slab_h[p];
          ra.same = std::log(v);
          ra.diff = std::log1p(-v);
          ra.oml = ra.same - ra.diff;
          rh.a = std::min(p, q);
          rh.b = std::max(p, q);
          int merged_class;
          rh.pri = compute_priority(rh.a, rh.b, ra.oml, &merged_class);
          if (rh.pri >= 0.0)
            heap_init.push_back(
                {rh.pri, static_cast<int32_t>(o * N_ + p)});
        }
      }
    }
    // O(E) heapify instead of E pushes
    queue_.build(std::move(heap_init));
  }

  inline int32_t find(int32_t x) {
    int32_t root = x;
    while (parent_[root] != root) root = parent_[root];
    while (parent_[x] != root) {
      int32_t next = parent_[x];
      parent_[x] = root;
      x = next;
    }
    return root;
  }

  // Record index currently keyed to live pair (a < b), or -1.  Checks the
  // implicit offset-grid slot first (valid whether the slot still holds
  // its original raw pair or was rekeyed to exactly this pair), then the
  // global map of rekeyed records.
  inline int32_t find_record(int32_t a, int32_t b) const {
    const int64_t d = static_cast<int64_t>(b) - a;
    // check EVERY offset whose flattened delta matches: distinct valid
    // offsets can alias to the same |di*W + dj| at small widths (e.g.
    // W=64, (0,-30) vs (1,-34)), so the live record may sit in any of
    // their implicit slots — no early break on a dead slot
    for (int o = 0; o < O_; ++o) {
      if (deltas_[o] == d || deltas_[o] == -d) {
        const int32_t p = deltas_[o] > 0 ? a : b;
        const int32_t ri = static_cast<int32_t>(o * N_ + p);
        const RecHot& rec = hot_[ri];
        if (rec.a == a && rec.b == b) return ri;
      }
    }
    const int32_t ri = map_.find(PairMap::pack(a, b));
    if (ri >= 0 && (hot_[ri].a != a || hot_[ri].b != b)) return -1;
    return ri;
  }

  double compute_priority(int32_t a, int32_t b, double oml,
                          int* merged_class) {
    double cdl;
    if (obj_class_[a] == obj_class_[b]) {
      cdl = 0.0;
      *merged_class = obj_class_[a];
    } else {
      const double* ra = &obj_cls_lp_[static_cast<int64_t>(a) * C_];
      const double* rb = &obj_cls_lp_[static_cast<int64_t>(b) * C_];
      int best = 0;
      double best_v = ra[0] + rb[0];
      for (int c = 1; c < C_; ++c) {
        double v = ra[c] + rb[c];
        if (v > best_v) { best_v = v; best = c; }
      }
      *merged_class = best;
      cdl = best_v - obj_best_[a] - obj_best_[b];
    }
    const double f = opts_.object_merge_factor;
    const double bias = opts_.merge_logprob_bias;
    const double n1 = static_cast<double>(obj_size_[a]);
    const double n2 = static_cast<double>(obj_size_[b]);
    if (opts_.den_mode == 0) return (oml * f + cdl) / (n1 + n2) + bias;
    return (oml * f + cdl + bias) / (n1 * n2);
  }

  // Enumerate b's live neighbor records into nbr_scratch_ as (c, ri).
  void collect_neighbors(int32_t b) {
    nbr_scratch_.clear();
    // implicit offset-grid records still keyed to a raw pair containing b
    const int row = b / W_, col = b % W_;
    for (int o = 0; o < O_; ++o) {
      const int di = offsets_[2 * o], dj = offsets_[2 * o + 1];
      // forward: record (b, b+delta) at slot o*N + b
      int r2 = row + di, c2 = col + dj;
      if (r2 >= 0 && r2 < H_ && c2 >= 0 && c2 < W_) {
        const int32_t q = r2 * W_ + c2;
        const RecHot& rec = hot_[o * N_ + b];
        if (rec.a == std::min(b, q) && rec.b == std::max(b, q)) {
          // the slot may hold a REKEYED record whose new pair happens to
          // equal (b, q) — then a map entry exists too; erase it so the
          // list pass cannot collect the same record twice
          map_.erase(PairMap::pack(rec.a, rec.b));
          nbr_scratch_.push_back({q, static_cast<int32_t>(o * N_ + b)});
        }
      }
      // backward: record (b-delta, b) at slot o*N + (b-delta)
      r2 = row - di;
      c2 = col - dj;
      if (r2 >= 0 && r2 < H_ && c2 >= 0 && c2 < W_) {
        const int32_t p = r2 * W_ + c2;
        const RecHot& rec = hot_[o * N_ + p];
        if (rec.a == std::min(b, p) && rec.b == std::max(b, p)) {
          map_.erase(PairMap::pack(rec.a, rec.b));
          nbr_scratch_.push_back({p, static_cast<int32_t>(o * N_ + p)});
        }
      }
    }
    // rekeyed records (stale/duplicate list entries skip via map lookup;
    // erase as we collect so duplicates cannot process twice)
    for (int32_t c : mapped_nbrs_[b]) {
      const uint64_t key = PairMap::pack(std::min(b, c), std::max(b, c));
      const int32_t ri = map_.find(key);
      if (ri < 0 || hot_[ri].a != std::min(b, c) ||
          hot_[ri].b != std::max(b, c))
        continue;
      map_.erase(key);
      nbr_scratch_.push_back({c, ri});
    }
  }

  void merge(int32_t ri, int merged_class) {
    RecHot rec = hot_[ri];
    const double rec_same = acc_[ri].same;
    int32_t a = rec.a, b = rec.b;
    if (obj_size_[b] > obj_size_[a]) std::swap(a, b);  // b dies

    hot_[ri].a = hot_[ri].b = -1;  // kill the merging record
    map_.erase(PairMap::pack(rec.a, rec.b));  // no-op if it was implicit

    obj_class_[a] = merged_class;
    obj_size_[a] += obj_size_[b];
    {
      double* ra = &obj_cls_lp_[static_cast<int64_t>(a) * C_];
      const double* rb = &obj_cls_lp_[static_cast<int64_t>(b) * C_];
      for (int c = 0; c < C_; ++c) ra[c] += rb[c];
      obj_best_[a] = ra[merged_class];
    }
    obj_sameness_[a] += rec_same + obj_sameness_[b];
    parent_[b] = a;
    --n_alive_;

    // re-point b's records at a, coalescing with existing (a, c) records
    collect_neighbors(b);
    for (const auto& nc : nbr_scratch_) {
      const int32_t c = nc.first;
      const int32_t old_ri = nc.second;
      if (c == a) continue;  // the merging record, already killed
      RecHot& old_rec = hot_[old_ri];
      const int32_t na = std::min(a, c), nb = std::max(a, c);
      int32_t live_ri = find_record(na, nb);
      if (live_ri >= 0) {
        RecAcc& keep = acc_[live_ri];
        const RecAcc& old_acc = acc_[old_ri];
        keep.oml += old_acc.oml;
        keep.same += old_acc.same;
        keep.diff += old_acc.diff;
        old_rec.a = old_rec.b = -1;  // tombstone
      } else {
        old_rec.a = na;
        old_rec.b = nb;
        map_.insert(PairMap::pack(na, nb), old_ri);
        mapped_nbrs_[a].push_back(c);
        mapped_nbrs_[c].push_back(a);
        live_ri = old_ri;
      }
      RecHot& live = hot_[live_ri];
      int mc;
      live.pri = compute_priority(live.a, live.b, acc_[live_ri].oml, &mc);
      if (live.pri >= 0.0) queue_.push({live.pri, live_ri});
    }
    std::vector<int32_t>().swap(mapped_nbrs_[b]);
  }

  void prune(float threshold) {
    int32_t bg = -1;
    int64_t bg_size = -1;
    for (int64_t r = 0; r < N_; ++r) {
      if (parent_[r] != r) continue;
      if (obj_class_[r] == 0 && obj_size_[r] > bg_size) {
        bg = static_cast<int32_t>(r);
        bg_size = obj_size_[r];
      }
    }
    if (bg < 0) return;
    for (int64_t r = 0; r < N_; ++r) {
      if (parent_[r] != r || r == bg) continue;
      double advantage = obj_best_[r] - obj_cls_lp_[r * C_ + 0];
      if (advantage < threshold) {
        parent_[r] = bg;
        obj_size_[bg] += obj_size_[r];
        --n_alive_;
      }
    }
  }

  const int C_, O_, H_, W_;
  const int64_t N_;
  const Options opts_;
  std::vector<int> offsets_;
  std::vector<int64_t> deltas_;

  std::vector<double> cls_lp_;       // (N, C)

  std::vector<int32_t> parent_;      // union-find
  std::vector<int64_t> obj_size_;
  std::vector<double> obj_cls_lp_;   // (N, C) per-root accumulators
  std::vector<int> obj_class_;
  std::vector<double> obj_best_;
  std::vector<double> obj_sameness_;
  int64_t n_alive_;

  std::vector<RecHot> hot_;          // (O, N) fixed implicit slots
  std::vector<RecAcc> acc_;          // accumulators, same indexing
  PairMap map_;                      // rekeyed records only
  std::vector<std::vector<int32_t>> mapped_nbrs_;
  std::vector<std::pair<int32_t, int32_t>> nbr_scratch_;
  MergeQueue queue_;
};

void run_one(const float* class_pred, int num_classes,
             const float* adj_pred, int num_offsets,
             int height, int width, const int* offset_list,
             int32_t* mask_out, int32_t* object_class_out,
             const Options& opts) {
  Segmenter seg(class_pred, num_classes, adj_pred, num_offsets,
                height, width, offset_list, opts);
  seg.run();
  seg.output(mask_out, object_class_out);
}

}  // namespace

extern "C" {

// Extended entry point with full option control.
void mn_run_segmentation(const float* class_pred, int num_classes,
                         const float* adj_pred, int num_offsets,
                         int height, int width, const int* offset_list,
                         int32_t* mask_out, int32_t* object_class_out,
                         float same_different_bias, float object_merge_factor,
                         float merge_logprob_bias, int den_mode,
                         int remerge_mode, int do_prune,
                         float prune_threshold) {
  Options opts;
  opts.same_different_bias = same_different_bias;
  opts.object_merge_factor = object_merge_factor;
  opts.merge_logprob_bias = merge_logprob_bias;
  opts.den_mode = den_mode;
  opts.remerge_mode = remerge_mode;
  opts.do_prune = do_prune;
  opts.prune_threshold = prune_threshold;
  run_one(class_pred, num_classes, adj_pred, num_offsets, height, width,
          offset_list, mask_out, object_class_out, opts);
}

// Batched decode: arrays have a leading batch dimension; each image decodes
// on its own thread (throughput path for multi-core hosts).
void mn_run_segmentation_batch(const float* class_pred, int num_classes,
                               const float* adj_pred, int num_offsets,
                               int batch, int height, int width,
                               const int* offset_list, int32_t* mask_out,
                               int32_t* object_class_out,
                               float same_different_bias,
                               float object_merge_factor,
                               float merge_logprob_bias, int den_mode,
                               int remerge_mode, int do_prune,
                               float prune_threshold, int num_threads) {
  Options opts;
  opts.same_different_bias = same_different_bias;
  opts.object_merge_factor = object_merge_factor;
  opts.merge_logprob_bias = merge_logprob_bias;
  opts.den_mode = den_mode;
  opts.remerge_mode = remerge_mode;
  opts.do_prune = do_prune;
  opts.prune_threshold = prune_threshold;

  const int64_t hw = static_cast<int64_t>(height) * width;
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  num_threads = std::max(1, std::min(num_threads, batch));

  std::vector<std::thread> pool;
  // static partition: thread t handles images t, t+T, t+2T, ...
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < batch; i += num_threads) {
        run_one(class_pred + i * hw * num_classes, num_classes,
                adj_pred + i * hw * num_offsets, num_offsets, height, width,
                offset_list, mask_out + i * hw, object_class_out + i * hw,
                opts);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
