// Native host sampler — the C++ performance path for negative sampling.
//
// This codebase's equivalent of the reference's native core (SURVEY.md §2.2):
//   base/Base.cpp::sampling  — pthread fan-out, disjoint output slices
//   base/Corrupt.h           — filtered corruption via the complement
//                              "offset trick" (binary search, no rejection)
//   base/Random.h            — deterministic per-thread RNG streams
// (reconstructed citations; the reference mount was empty — see SURVEY.md
// "Provenance").
//
// Redesign notes (not a translation):
//  - The reader/indexing half of base/Reader.h lives in Python
//    (data/index.py) where it is shared with the on-device sampler and
//    fully unit-tested; this library receives the prebuilt CSR arrays and
//    owns copies of them. One source of truth for the data structures,
//    native speed for the hot loop.
//  - Threads are std::thread over disjoint batch ranges (same
//    design-by-disjointness as Base.cpp — no locks, no sharing).
//  - RNG is splitmix64 seeded per (call seed, thread id): deterministic
//    and reproducible regardless of thread scheduling, unlike the
//    reference's global LCG state carried across calls.
//  - Output is the reference buffer layout: slot j < B = positive j,
//    slots j + B*(1+k) = k-th negative of positive j, y = +1 / −1
//    (Model.py slot convention, SURVEY.md §2.1).
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC -pthread).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Store {
  int32_t n_ent = 0;
  int32_t n_rel = 0;
  int64_t n_train = 0;
  int32_t n_threads = 1;
  std::vector<int32_t> h, t, r;                // [n_train]
  std::vector<int32_t> hr_off, hr_cnt;         // per-triple (h,r)->tails win
  std::vector<int32_t> tr_off, tr_cnt;         // per-triple (t,r)->heads win
  std::vector<int32_t> ht_off, ht_cnt;         // per-triple (h,t)->rels win
  std::vector<int32_t> ent_adj;                // concat windows (tr pre-shifted)
  std::vector<int32_t> rel_adj;
  std::vector<float> p_corrupt_head;           // [n_rel]
};

// splitmix64: tiny, fast, passes BigCrush-level smoke — per-thread stream.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, bound) — modulo reduction, matching the reference's
  // rand() % x (Random.h::rand_max); bias is negligible at KG scale.
  int64_t below(int64_t bound) {
    return bound <= 1 ? 0 : (int64_t)(next() % (uint64_t)bound);
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

// #{i in [0,cnt): adj[off+i] <= x} — upper_bound over the strictly
// increasing complement-adjustment window (Corrupt.h's search).
inline int32_t upper_bound(const int32_t* adj, int32_t off, int32_t cnt,
                           int64_t x) {
  int32_t lo = 0, hi = cnt;
  while (lo < hi) {
    int32_t mid = (lo + hi) >> 1;
    if ((int64_t)adj[off + mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// uniform over [0, n_vals) \ window; empty complement falls back to
// "anything but `avoid`" (see sampling/device.py::_complement_sample —
// both samplers share this degenerate-case contract).
inline int32_t complement_sample(Rng& rng, const int32_t* adj, int32_t off,
                                 int32_t cnt, int32_t n_vals, int32_t avoid) {
  if (cnt >= n_vals) {
    int64_t x = rng.below(n_vals > 1 ? n_vals - 1 : 1);
    return (int32_t)(x + (x >= avoid ? 1 : 0));
  }
  int64_t x = rng.below((int64_t)n_vals - cnt);
  return (int32_t)(x + upper_bound(adj, off, cnt, x));
}

void fill_range(const Store& st, uint64_t seed, int tid, int64_t lo,
                int64_t hi, int32_t batch, int32_t neg_ent, int32_t neg_rel,
                bool bern, int64_t part_start, int64_t part_size,
                int32_t* out_h, int32_t* out_t, int32_t* out_r,
                float* out_y) {
  Rng rng(seed * 0x2545F4914F6CDD1DULL + 0x9E3779B9ULL * (uint64_t)(tid + 1));
  const int64_t span = part_size > 0 ? part_size : st.n_train;
  const int64_t base = part_size > 0 ? part_start : 0;
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t i = base + rng.below(span);
    const int32_t h = st.h[i], t = st.t[i], r = st.r[i];
    out_h[j] = h; out_t[j] = t; out_r[j] = r; out_y[j] = 1.0f;
    for (int32_t k = 0; k < neg_ent; ++k) {
      const double p = bern ? st.p_corrupt_head[r] : 0.5;
      const int64_t o = j + (int64_t)batch * (1 + k);
      if (rng.uniform() < p) {   // corrupt head: complement of heads(t,r)
        out_h[o] = complement_sample(rng, st.ent_adj.data(), st.tr_off[i],
                                     st.tr_cnt[i], st.n_ent, h);
        out_t[o] = t;
      } else {                   // corrupt tail: complement of tails(h,r)
        out_h[o] = h;
        out_t[o] = complement_sample(rng, st.ent_adj.data(), st.hr_off[i],
                                     st.hr_cnt[i], st.n_ent, t);
      }
      out_r[o] = r; out_y[o] = -1.0f;
    }
    for (int32_t k = 0; k < neg_rel; ++k) {
      const int64_t o = j + (int64_t)batch * (1 + neg_ent + k);
      out_h[o] = h; out_t[o] = t;
      out_r[o] = complement_sample(rng, st.rel_adj.data(), st.ht_off[i],
                                   st.ht_cnt[i], st.n_rel, r);
      out_y[o] = -1.0f;
    }
  }
}

}  // namespace

extern "C" {

// Create a sampler over caller-provided arrays (copied; caller may free).
// Returns an opaque handle (never null on success).
void* okst_create(const int32_t* h, const int32_t* t, const int32_t* r,
                  int64_t n_train,
                  const int32_t* hr_off, const int32_t* hr_cnt,
                  const int32_t* tr_off, const int32_t* tr_cnt,
                  const int32_t* ht_off, const int32_t* ht_cnt,
                  const int32_t* ent_adj, int64_t ent_adj_len,
                  const int32_t* rel_adj, int64_t rel_adj_len,
                  const float* p_corrupt_head,
                  int32_t n_ent, int32_t n_rel, int32_t n_threads) {
  auto* st = new Store();
  st->n_ent = n_ent; st->n_rel = n_rel; st->n_train = n_train;
  st->n_threads = n_threads > 0 ? n_threads : 1;
  st->h.assign(h, h + n_train);
  st->t.assign(t, t + n_train);
  st->r.assign(r, r + n_train);
  st->hr_off.assign(hr_off, hr_off + n_train);
  st->hr_cnt.assign(hr_cnt, hr_cnt + n_train);
  st->tr_off.assign(tr_off, tr_off + n_train);
  st->tr_cnt.assign(tr_cnt, tr_cnt + n_train);
  st->ht_off.assign(ht_off, ht_off + n_train);
  st->ht_cnt.assign(ht_cnt, ht_cnt + n_train);
  st->ent_adj.assign(ent_adj, ent_adj + ent_adj_len);
  st->rel_adj.assign(rel_adj, rel_adj + rel_adj_len);
  st->p_corrupt_head.assign(p_corrupt_head, p_corrupt_head + n_rel);
  return st;
}

void okst_destroy(void* handle) { delete static_cast<Store*>(handle); }

// Fill the reference-layout buffers (length batch*(1+neg_ent+neg_rel)).
// part_size > 0 restricts positive draws to [part_start, part_start+size).
// Deterministic in (seed, batch, negs, partition) — thread count does not
// change the result (each slot's stream depends only on its thread's
// range, which is derived from n_threads; pass the same n_threads for
// reproducibility).
void okst_sample(void* handle, uint64_t seed, int32_t batch,
                 int32_t neg_ent, int32_t neg_rel, int32_t bern,
                 int64_t part_start, int64_t part_size,
                 int32_t* out_h, int32_t* out_t, int32_t* out_r,
                 float* out_y) {
  const auto& st = *static_cast<Store*>(handle);
  const int nt = (int)std::min<int64_t>(st.n_threads, batch);
  if (nt <= 1) {
    fill_range(st, seed, 0, 0, batch, batch, neg_ent, neg_rel, bern != 0,
               part_start, part_size, out_h, out_t, out_r, out_y);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t per = (batch + nt - 1) / nt;
  for (int tid = 0; tid < nt; ++tid) {
    const int64_t lo = (int64_t)tid * per;
    const int64_t hi = std::min<int64_t>(lo + per, batch);
    if (lo >= hi) break;
    threads.emplace_back(fill_range, std::cref(st), seed, tid, lo, hi,
                         batch, neg_ent, neg_rel, bern != 0, part_start,
                         part_size, out_h, out_t, out_r, out_y);
  }
  for (auto& th : threads) th.join();
}

int32_t okst_version() { return 1; }

}  // extern "C"
