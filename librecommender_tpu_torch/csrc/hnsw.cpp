// hnsw.cpp — HNSW approximate nearest-neighbour index, host C++.
//
// The port's own copy of the JAX package's librecommender_tpu/native/hnsw.cpp:
// the same algorithm, C interface and blob layout, so that a graph built or
// saved by either package loads and searches alike in the other. The
// Malkov-Yashunin algorithm over inner-product similarity (callers
// pre-normalize for cosine): hierarchical layers with geometric level
// assignment, greedy descent through upper layers, best-first ef-bounded
// search at each layer, and simple top-M neighbor selection with list
// shrinking. Single-threaded build (insertion order is part of the
// index's determinism contract); OpenMP-parallel batched search.
//
// C ABI for the ctypes loader (ops/_build.py build_host, retrieval/hnsw.py).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct HnswIndex {
  int64_t n = 0, d = 0;
  int M = 16, M0 = 32, ef_c = 200;
  int max_level = -1;
  int32_t entry = -1;
  std::vector<float> vecs;                          // (n, d), owned copy
  std::vector<int> levels;                          // per node
  // links[node][level] = neighbor ids (level <= levels[node])
  std::vector<std::vector<std::vector<int32_t>>> links;

  float sim(int64_t a, const float* q) const {
    const float* va = vecs.data() + a * d;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int64_t i = 0;
    for (; i + 4 <= d; i += 4)
      for (int j = 0; j < 4; ++j) acc[j] += va[i + j] * q[i + j];
    float tail = 0.f;
    for (; i < d; ++i) tail += va[i] * q[i];
    return (acc[0] + acc[1]) + (acc[2] + acc[3]) + tail;
  }
};

// best-first search at one layer: returns up to ef (sim, id) pairs,
// highest-similarity candidates retained.
void search_layer(const HnswIndex& ix, const float* q, int level, int ef,
                  std::vector<std::pair<float, int32_t>>* inout_entries,
                  std::vector<uint8_t>* visited, std::vector<int32_t>* vlist) {
  // visited is an n-sized byte map reset lazily via vlist
  auto& entries = *inout_entries;
  // max-heap of candidates to expand; min-heap of current best (size<=ef)
  std::priority_queue<std::pair<float, int32_t>> cand;
  std::priority_queue<std::pair<float, int32_t>,
                      std::vector<std::pair<float, int32_t>>,
                      std::greater<>> best;
  for (const auto& e : entries) {
    if (!(*visited)[e.second]) {
      (*visited)[e.second] = 1;
      vlist->push_back(e.second);
      cand.push(e);
      best.push(e);
      if ((int)best.size() > ef) best.pop();
    }
  }
  while (!cand.empty()) {
    const auto top = cand.top();
    cand.pop();
    if ((int)best.size() >= ef && top.first < best.top().first) break;
    const auto& nbrs = ix.links[top.second][level];
    for (const int32_t nb : nbrs) {
      if ((*visited)[nb]) continue;
      (*visited)[nb] = 1;
      vlist->push_back(nb);
      const float s = ix.sim(nb, q);
      if ((int)best.size() < ef || s > best.top().first) {
        cand.push({s, nb});
        best.push({s, nb});
        if ((int)best.size() > ef) best.pop();
      }
    }
  }
  entries.clear();
  while (!best.empty()) {
    entries.push_back(best.top());
    best.pop();
  }
  std::sort(entries.begin(), entries.end(),
            [](const auto& a, const auto& b) { return a.first > b.first; });
}

void insert_node(HnswIndex* ix, int32_t node, int level, std::mt19937*) {
  const float* q = ix->vecs.data() + (int64_t)node * ix->d;
  ix->levels[node] = level;
  ix->links[node].assign(level + 1, {});
  if (ix->entry < 0) {
    ix->entry = node;
    ix->max_level = level;
    return;
  }
  std::vector<uint8_t> visited(ix->n, 0);
  std::vector<int32_t> vlist;
  std::vector<std::pair<float, int32_t>> entries{
      {ix->sim(ix->entry, q), ix->entry}};
  // greedy descent through layers above the node's level
  for (int lev = ix->max_level; lev > level; --lev) {
    bool moved = true;
    while (moved) {
      moved = false;
      const auto& nbrs = ix->links[entries[0].second][lev];
      for (const int32_t nb : nbrs) {
        const float s = ix->sim(nb, q);
        if (s > entries[0].first) {
          entries[0] = {s, nb};
          moved = true;
        }
      }
    }
  }
  // connect at each layer from min(level, max_level) down to 0
  for (int lev = std::min(level, ix->max_level); lev >= 0; --lev) {
    for (const int32_t v : vlist) visited[v] = 0;
    vlist.clear();
    search_layer(*ix, q, lev, ix->ef_c, &entries, &visited, &vlist);
    const int cap = lev == 0 ? ix->M0 : ix->M;
    const int take = std::min<int>(ix->M, entries.size());
    for (int t = 0; t < take; ++t) {
      const int32_t nb = entries[t].second;
      ix->links[node][lev].push_back(nb);
      auto& back = ix->links[nb][lev];
      back.push_back(node);
      if ((int)back.size() > cap) {
        // shrink: keep the `cap` most similar to nb
        const float* vnb = ix->vecs.data() + (int64_t)nb * ix->d;
        std::vector<std::pair<float, int32_t>> scored;
        scored.reserve(back.size());
        for (const int32_t b : back) scored.push_back({ix->sim(b, vnb), b});
        std::partial_sort(scored.begin(), scored.begin() + cap, scored.end(),
                          [](const auto& a, const auto& b) {
                            return a.first > b.first;
                          });
        back.clear();
        for (int c = 0; c < cap; ++c) back.push_back(scored[c].second);
      }
    }
  }
  if (level > ix->max_level) {
    ix->max_level = level;
    ix->entry = node;
  }
}

void knn_search(const HnswIndex& ix, const float* q, int k, int ef,
                int32_t* out_ids, float* out_scores) {
  if (ix.entry < 0) {
    for (int t = 0; t < k; ++t) { out_ids[t] = -1; out_scores[t] = 0.f; }
    return;
  }
  std::vector<uint8_t> visited(ix.n, 0);
  std::vector<int32_t> vlist;
  std::vector<std::pair<float, int32_t>> entries{
      {ix.sim(ix.entry, q), ix.entry}};
  for (int lev = ix.max_level; lev > 0; --lev) {
    bool moved = true;
    while (moved) {
      moved = false;
      for (const int32_t nb : ix.links[entries[0].second][lev]) {
        const float s = ix.sim(nb, q);
        if (s > entries[0].first) {
          entries[0] = {s, nb};
          moved = true;
        }
      }
    }
  }
  search_layer(ix, q, 0, std::max(ef, k), &entries, &visited, &vlist);
  for (int t = 0; t < k; ++t) {
    if (t < (int)entries.size()) {
      out_ids[t] = entries[t].second;
      out_scores[t] = entries[t].first;
    } else {
      out_ids[t] = -1;
      out_scores[t] = 0.f;
    }
  }
}

}  // namespace

extern "C" {

void* hnsw_build(const float* vecs, int64_t n, int64_t d, int M, int ef_c,
                 uint64_t seed) {
  auto* ix = new HnswIndex();
  ix->n = n;
  ix->d = d;
  ix->M = M;
  ix->M0 = 2 * M;
  ix->ef_c = ef_c;
  ix->vecs.assign(vecs, vecs + n * d);
  ix->levels.assign(n, 0);
  ix->links.resize(n);
  std::mt19937 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  const double mult = 1.0 / std::log(std::max(2, M));
  for (int64_t i = 0; i < n; ++i) {
    const double u = std::max(uni(rng), 1e-12);
    const int level = (int)(-std::log(u) * mult);
    insert_node(ix, (int32_t)i, level, &rng);
  }
  return ix;
}

void hnsw_search(const void* idx, const float* queries, int64_t nq,
                 int64_t dq, int k, int ef, int32_t* out_ids,
                 float* out_scores) {
  const auto* ix = static_cast<const HnswIndex*>(idx);
  if (dq != ix->d) {  // dim mismatch: fail safe with pad results, no OOB reads
    for (int64_t i = 0; i < nq * k; ++i) {
      out_ids[i] = -1;
      out_scores[i] = -std::numeric_limits<float>::infinity();
    }
    return;
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
  for (int64_t r = 0; r < nq; ++r) {
    knn_search(*ix, queries + r * ix->d, k, ef, out_ids + r * k,
               out_scores + r * k);
  }
}

// flat serialization: header + levels + per-node per-level link lists
int64_t hnsw_blob_size(const void* idx) {
  const auto* ix = static_cast<const HnswIndex*>(idx);
  int64_t sz = 6 * 8;  // n, d, M, ef_c, max_level, entry as int64
  sz += ix->n * 4;     // levels
  for (int64_t i = 0; i < ix->n; ++i)
    for (const auto& lv : ix->links[i]) sz += 4 + lv.size() * 4;
  return sz;
}

void hnsw_serialize(const void* idx, char* buf) {
  const auto* ix = static_cast<const HnswIndex*>(idx);
  auto w64 = [&buf](int64_t v) { std::memcpy(buf, &v, 8); buf += 8; };
  w64(ix->n); w64(ix->d); w64(ix->M); w64(ix->ef_c);
  w64(ix->max_level); w64(ix->entry);
  for (int64_t i = 0; i < ix->n; ++i) {
    const int32_t lv = ix->levels[i];
    std::memcpy(buf, &lv, 4); buf += 4;
  }
  for (int64_t i = 0; i < ix->n; ++i) {
    for (const auto& nb : ix->links[i]) {
      const int32_t cnt = (int32_t)nb.size();
      std::memcpy(buf, &cnt, 4); buf += 4;
      std::memcpy(buf, nb.data(), cnt * 4); buf += (int64_t)cnt * 4;
    }
  }
}

void* hnsw_deserialize(const float* vecs, const char* buf, int64_t len) {
  (void)len;
  auto* ix = new HnswIndex();
  auto r64 = [&buf]() { int64_t v; std::memcpy(&v, buf, 8); buf += 8; return v; };
  ix->n = r64(); ix->d = r64(); ix->M = (int)r64(); ix->ef_c = (int)r64();
  ix->max_level = (int)r64(); ix->entry = (int32_t)r64();
  ix->M0 = 2 * ix->M;
  ix->vecs.assign(vecs, vecs + ix->n * ix->d);
  ix->levels.resize(ix->n);
  for (int64_t i = 0; i < ix->n; ++i) {
    int32_t lv; std::memcpy(&lv, buf, 4); buf += 4;
    ix->levels[i] = lv;
  }
  ix->links.resize(ix->n);
  for (int64_t i = 0; i < ix->n; ++i) {
    ix->links[i].resize(ix->levels[i] + 1);
    for (auto& nb : ix->links[i]) {
      int32_t cnt; std::memcpy(&cnt, buf, 4); buf += 4;
      nb.resize(cnt);
      std::memcpy(nb.data(), buf, (int64_t)cnt * 4); buf += (int64_t)cnt * 4;
    }
  }
  return ix;
}

void hnsw_free(void* idx) { delete static_cast<HnswIndex*>(idx); }

}  // extern "C"
