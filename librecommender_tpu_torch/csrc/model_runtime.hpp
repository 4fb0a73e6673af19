// model_runtime.hpp — endpoint-level model/online scoring on top of the
// jaxpr interpreter (jaxpr_interp.hpp).
//
// The port's copy of the JAX package's
// librecommender_tpu/serving/native_server/model_runtime.hpp, kept in step
// with it: programs of either package run in either copy.
//
// Loads the artifacts written by serving/native_program.py
// (export_native_programs): the score_all / score_dyn / user_repr
// programs, user feature rows, the raw-value -> flat-index feature maps
// and (dyn family) the item matrix + stored recent histories. Assembles
// request-time override rows exactly like the Python
// FeatureTables.build_user_sparse_row / _convert_request_seq, runs the
// program in-process and returns raw catalog scores — the C++ analog of
// the reference's online_deploy feature assembly + TF Serving scoring hop
// (reference libserving/sanic_serving/online_deploy.py:25,
// actix_serving/src/online_deploy_grpc.rs:38), with the network hop
// removed.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <functional>
#include <mutex>
#include <optional>
#include <thread>

#include "jaxpr_interp.hpp"

namespace jxi {

// Shared worker pool for tiled catalog scoring. Tiles are coarse tasks
// (one program execution over ~512 items), so pool scheduling overhead is
// negligible — unlike the measured-and-rejected per-GEMM OpenMP regions.
// Callers submit their tiles and then help drain the queue, so a single
// request parallelizes across idle cores at low load while concurrent
// requests interleave tiles without oversubscription at high load.
class TilePool {
 public:
  static TilePool& instance() {
    static TilePool pool;
    return pool;
  }

  void ensure_started() {
    std::call_once(once_, [&] {
      int n = 0;
      if (const char* env = std::getenv("NATIVE_TILE_THREADS"))
        n = std::atoi(env);
      if (n <= 0)  // hw/2: epoll threads share the cores; measured sweep
        n = std::max(1u, std::thread::hardware_concurrency() / 2);
      for (int i = 0; i < n; ++i)
        workers_.emplace_back([this] { loop(); });
    });
  }

  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> l(mu_);
      q_.push_back(std::move(f));
    }
    cv_.notify_one();
  }

  bool try_run_one() {
    std::function<void()> f;
    {
      std::lock_guard<std::mutex> l(mu_);
      if (q_.empty()) return false;
      f = std::move(q_.front());
      q_.pop_front();
    }
    f();
    return true;
  }

  ~TilePool() {
    {
      std::lock_guard<std::mutex> l(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> l(mu_);
        cv_.wait(l, [&] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop_front();
      }
      f();
    }
  }

  std::once_flag once_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

struct FeatCol {
  int pos = 0;
  int64_t oov = 0;
  std::map<std::string, int64_t> values;  // raw value (string form) -> idx
};

struct ModelRuntime {
  bool loaded = false;
  std::string kind;                     // "feat" | "dyn"
  std::vector<std::string> inputs;      // program input order
  int64_t n_users = 0, n_items = 0, pad_id = 0;
  int64_t max_seq_len = 0, long_max_len = 0;
  bool has_bias = false;
  int64_t tile = 0;        // feat family: tiled-scorer width (0 = absent)
  int64_t dyn_batch = 0;   // dyn families: coalesced tower width

  std::optional<Program> score_all, score_dyn, user_repr;
  std::optional<Program> score_tile_prog, user_repr_b;
  // (n_users + 1, F) stored user feature rows
  std::vector<int32_t> user_sparse_rows;
  int64_t n_sparse_cols = 0;
  std::vector<float> user_dense_rows;
  int64_t n_dense_cols = 0;
  std::map<std::string, FeatCol> sparse_map;
  std::map<std::string, int> dense_map;
  // dyn family
  std::vector<float> item_repr;
  int64_t item_dim = 0;
  std::vector<int32_t> recent_seq;      // (n_users + 1, L)
  std::map<int64_t, int32_t> item2id;   // raw item -> inner id
  // feat family: precomputed (n_users + 1, static_k) sorted item ids for
  // /model/recommend (the reference's TfBase default_recs analog — static
  // stored-feature requests are deterministic given the artifact)
  std::vector<int32_t> static_topk;
  int64_t static_k = 0;

  static std::string slurp(const std::string& p) {
    std::ifstream f(p, std::ios::binary);
    if (!f) return "";
    return std::string((std::istreambuf_iterator<char>(f)),
                       std::istreambuf_iterator<char>());
  }

  template <typename T>
  static std::vector<T> bin(const std::string& p) {
    const std::string raw = slurp(p);
    std::vector<T> out(raw.size() / sizeof(T));
    std::memcpy(out.data(), raw.data(), out.size() * sizeof(T));
    return out;
  }

  bool load(const std::string& dir,
            const std::vector<int64_t>& id2item_ints) {
    const std::string meta_text = slurp(dir + "/runtime_meta.json");
    if (meta_text.empty()) return false;
    JV meta = JsonParser(meta_text).parse();
    kind = meta.at("kind").str;
    for (const auto& v : meta.at("inputs").arr) inputs.push_back(v.str);
    n_users = meta.at("n_users").asi();
    n_items = meta.at("n_items").asi();
    pad_id = meta.at("pad_id").asi();
    if (meta.find("max_seq_len")) max_seq_len = meta.at("max_seq_len").asi();
    if (meta.find("long_max_len")) long_max_len = meta.at("long_max_len").asi();
    if (meta.find("has_bias")) has_bias = meta.at("has_bias").boo;

    auto try_load = [&](const char* name) -> std::optional<Program> {
      const std::string pj = dir + "/" + name + ".program.json";
      if (slurp(pj).empty()) return std::nullopt;
      return load_program(pj, dir + "/" + std::string(name) + ".blob.bin");
    };
    score_all = try_load("score_all");
    score_dyn = try_load("score_dyn");
    user_repr = try_load("user_repr");
    score_tile_prog = try_load("score_tile");
    user_repr_b = try_load("user_repr_b");
    if (meta.find("tile")) tile = meta.at("tile").asi();
    if (meta.find("dyn_batch")) dyn_batch = meta.at("dyn_batch").asi();
    if (meta.find("static_topk")) {
      static_k = meta.at("static_topk").asi();
      static_topk = bin<int32_t>(dir + "/static_topk.bin");
      if (int64_t(static_topk.size()) != (n_users + 1) * static_k)
        static_k = 0;  // malformed/absent table: live scoring only
    }

    const auto sshape = bin<int64_t>(dir + "/user_sparse_rows_shape.bin");
    if (sshape.size() == 2) {
      user_sparse_rows = bin<int32_t>(dir + "/user_sparse_rows.bin");
      n_sparse_cols = sshape[1];
    }
    const auto dshape = bin<int64_t>(dir + "/user_dense_rows_shape.bin");
    if (dshape.size() == 2) {
      user_dense_rows = bin<float>(dir + "/user_dense_rows.bin");
      n_dense_cols = dshape[1];
    }
    const std::string fm = slurp(dir + "/feat_map.json");
    if (!fm.empty()) {
      JV fmap = JsonParser(fm).parse();
      for (const auto& kv : fmap.at("sparse").obj) {
        FeatCol col;
        col.pos = int(kv.second.at("pos").asi());
        col.oov = kv.second.at("oov").asi();
        for (const auto& vv : kv.second.at("values").obj)
          col.values[vv.first] = vv.second.asi();
        sparse_map[kv.first] = std::move(col);
      }
      for (const auto& kv : fmap.at("dense").obj)
        dense_map[kv.first] = int(kv.second.asi());
    }
    if (kind == "dyn") {
      const auto ishape = bin<int64_t>(dir + "/item_repr_shape.bin");
      if (ishape.size() != 2) return false;
      item_repr = bin<float>(dir + "/item_repr.bin");
      item_dim = ishape[1];
      recent_seq = bin<int32_t>(dir + "/recent_seq.bin");
    } else if (kind == "dyn_feats") {
      // TwoTower family: scores = tower(u, feats) . item_embeds rows
      // (the embed-family export; includes a trailing OOV row)
      const auto ishape = bin<int64_t>(dir + "/item_embed_shape.bin");
      if (ishape.size() != 2) return false;
      item_repr = bin<float>(dir + "/item_embed.bin");
      item_dim = ishape[1];
    } else {
      stored_short_rows = bin<int32_t>(dir + "/recent_seq.bin");
      stored_long_rows = bin<int32_t>(dir + "/recent_long.bin");
    }
    for (size_t i = 0; i < id2item_ints.size(); ++i)
      item2id[id2item_ints[i]] = int32_t(i);
    loaded = (kind == "feat" && score_all.has_value()) ||
             ((kind == "dyn" || kind == "dyn_feats") &&
              user_repr.has_value());
    return loaded;
  }

  static Tensor users_tensor(int64_t uid) {
    Tensor t;
    t.dt = DT::I32;
    t.shape = {1};
    t.i = {uid};
    return t;
  }

  // ---- feature-row assembly (FeatureTables.build_user_*_row analog)
  Tensor sparse_row_for(int64_t uid, const JV* feats) const {
    Tensor t;
    t.dt = DT::I32;
    t.shape = {1, n_sparse_cols};
    t.i.resize(n_sparse_cols);
    const int64_t row = std::min<int64_t>(uid, n_users);
    for (int64_t j = 0; j < n_sparse_cols; ++j)
      t.i[j] = user_sparse_rows[row * n_sparse_cols + j];
    if (feats) {
      for (const auto& kv : feats->obj) {
        auto it = sparse_map.find(kv.first);
        if (it == sparse_map.end()) continue;
        const FeatCol& col = it->second;
        std::string key;
        if (kv.second.t == JV::STR) {
          key = kv.second.str;
        } else if (kv.second.t == JV::NUM) {
          // integer-valued numbers print without a decimal point, matching
          // Python's str() of the original raw value
          const double v = kv.second.num;
          if (v == int64_t(v)) key = std::to_string(int64_t(v));
          else { char b[64]; std::snprintf(b, 64, "%g", v); key = b; }
        } else if (kv.second.t == JV::BOO) {
          key = kv.second.boo ? "True" : "False";
        }
        auto vit = col.values.find(key);
        t.i[col.pos] = vit == col.values.end() ? col.oov : vit->second;
      }
    }
    return t;
  }

  Tensor dense_row_for(int64_t uid, const JV* feats) const {
    Tensor t;
    t.dt = DT::F32;
    t.shape = {1, n_dense_cols};
    t.f.resize(n_dense_cols);
    const int64_t row = std::min<int64_t>(uid, n_users);
    for (int64_t j = 0; j < n_dense_cols; ++j)
      t.f[j] = user_dense_rows[row * n_dense_cols + j];
    if (feats) {
      for (const auto& kv : feats->obj) {
        auto it = dense_map.find(kv.first);
        if (it == dense_map.end() || kv.second.t != JV::NUM) continue;
        t.f[it->second] = float(kv.second.num);
      }
    }
    return t;
  }

  // raw request seq -> right-aligned padded inner ids (len L)
  Tensor seq_tensor(const std::vector<int64_t>& raw_seq, int64_t L) const {
    Tensor t;
    t.dt = DT::I32;
    t.shape = {1, L};
    t.i.assign(L, pad_id);
    std::vector<int64_t> inner;
    for (const auto r : raw_seq) {
      auto it = item2id.find(r);
      if (it != item2id.end()) inner.push_back(it->second);
    }
    const int64_t take = std::min<int64_t>(L, int64_t(inner.size()));
    for (int64_t j = 0; j < take; ++j)
      t.i[L - take + j] = inner[inner.size() - take + j];
    return t;
  }

  Tensor stored_seq(int64_t uid, const std::vector<int32_t>& table,
                    int64_t L) const {
    Tensor t;
    t.dt = DT::I32;
    t.shape = {1, L};
    t.i.assign(L, pad_id);
    const int64_t row = std::min<int64_t>(uid, n_users);
    if (!table.empty())
      for (int64_t j = 0; j < L; ++j) t.i[j] = table[row * L + j];
    return t;
  }

  // /model/recommend from the precomputed table: walk the user's sorted
  // list, drop consumed, return up to n_rec inner ids. Empty result =
  // table can't cover this request (caller falls back to live scoring).
  std::vector<int32_t> topk_from_table(
      int64_t uid, const std::vector<int32_t>& consumed,
      int64_t n_rec) const {
    std::vector<int32_t> out;
    if (static_k == 0 || n_rec + int64_t(consumed.size()) > static_k)
      return out;
    const int64_t row = std::min<int64_t>(uid, n_users);
    const int32_t* ids = static_topk.data() + row * static_k;
    std::vector<bool> is_consumed;  // consumed ids are inner, < n_items
    if (!consumed.empty()) {
      is_consumed.assign(size_t(n_items), false);
      for (int32_t c : consumed)
        if (c >= 0 && c < n_items) is_consumed[size_t(c)] = true;
    }
    out.reserve(size_t(n_rec));
    for (int64_t j = 0; j < static_k && int64_t(out.size()) < n_rec; ++j)
      if (is_consumed.empty() || !is_consumed[size_t(ids[j])])
        out.push_back(ids[j]);
    return out;
  }

  // ---- scoring entry points. uid == n_users means cold/OOV.
  // Returns (n_items,) raw scores.
  std::vector<float> scores_static(int64_t uid) const {
    if (kind == "dyn") return scores_dyn_family(uid, nullptr);
    if (kind == "dyn_feats") return scores_tower_feats(uid, nullptr);
    if (use_tiled()) return scores_feat_tiled(uid, nullptr, {});
    Executor ex(*score_all);
    auto outs = ex.run({users_tensor(uid)});
    return std::vector<float>(outs[0].f.begin(), outs[0].f.end());
  }

  // feats: parsed flat JSON object or nullptr; raw_seq: request item ids
  // (empty = use stored history).
  std::vector<float> scores_online(int64_t uid, const JV* feats,
                                   const std::vector<int64_t>& raw_seq) const {
    if (kind == "dyn")
      return scores_dyn_family(uid, raw_seq.empty() ? nullptr : &raw_seq);
    if (kind == "dyn_feats") return scores_tower_feats(uid, feats);
    if (use_tiled()) return scores_feat_tiled(uid, feats, raw_seq);
    if (!score_dyn.has_value()) return scores_static(uid);
    Executor ex(*score_dyn);
    auto outs = ex.run(feat_override_args(uid, feats, raw_seq));
    return std::vector<float>(outs[0].f.begin(), outs[0].f.end());
  }

  // ---- feat family: tiled catalog execution. The catalog splits into
  // `tile`-item program runs whose intermediates stay cache-resident;
  // tiles fan out over the shared TilePool (caller helps drain), so one
  // request parallelizes at low load and concurrent requests interleave
  // at high load. Large-catalog p50 AND throughput path.
  bool use_tiled() const {
    static const bool off = std::getenv("NATIVE_NO_TILING") != nullptr;
    return !off && score_tile_prog.has_value() && tile > 0 &&
           n_items > tile;
  }

  std::vector<Tensor> feat_override_args(
      int64_t uid, const JV* feats,
      const std::vector<int64_t>& raw_seq) const {
    std::vector<Tensor> args;
    for (const auto& name : inputs) {
      if (name == "users") {
        args.push_back(users_tensor(uid));
      } else if (name == "seq") {
        args.push_back(raw_seq.empty() ? stored_short_seq(uid)
                                       : seq_tensor(raw_seq, max_seq_len));
      } else if (name == "seq_long") {
        args.push_back(raw_seq.empty() ? stored_long_seq(uid)
                                       : seq_tensor(raw_seq, long_max_len));
      } else if (name == "user_sparse_row") {
        args.push_back(sparse_row_for(uid, feats));
      } else if (name == "user_dense_row") {
        args.push_back(dense_row_for(uid, feats));
      } else {
        throw std::runtime_error("unknown program input " + name);
      }
    }
    return args;
  }

  // Admission gate: bound the number of catalog scorings in flight
  // (NATIVE_SCORING_PERMITS, default cores/2 + 1). Unbounded interleaving
  // makes every concurrent request finish late (processor-sharing tail);
  // bounding keeps the tile pool a short pipeline. On the noisy shared
  // bench VM the default measures within noise of unbounded — the knob
  // exists for production hosts where steal time isn't the tail driver.
  struct Gate {
    std::mutex mu;
    std::condition_variable cv;
    int active = 0;
  };
  std::unique_ptr<Gate> gate_ = std::make_unique<Gate>();

  static int scoring_permits() {
    static const int n = [] {
      if (const char* env = std::getenv("NATIVE_SCORING_PERMITS")) {
        const int v = std::atoi(env);
        if (v > 0) return v;
      }
      return int(std::max(2u, std::thread::hardware_concurrency() / 2 + 1));
    }();
    return n;
  }

  std::vector<float> scores_feat_tiled(
      int64_t uid, const JV* feats,
      const std::vector<int64_t>& raw_seq) const {
    struct Admission {
      Gate& g;
      explicit Admission(Gate& gate) : g(gate) {
        std::unique_lock<std::mutex> l(g.mu);
        g.cv.wait(l, [&] { return g.active < scoring_permits(); });
        ++g.active;
      }
      ~Admission() {
        {
          std::lock_guard<std::mutex> l(g.mu);
          --g.active;
        }
        g.cv.notify_one();
      }
    } admission(*gate_);
    // per-request input rows assembled once; shared (copied) per tile.
    // program input order: users, items, then the override slots
    const std::vector<Tensor> base = feat_override_args(uid, feats, raw_seq);
    const int64_t T = tile;
    const int64_t n_tiles = (n_items + T - 1) / T;
    std::vector<float> scores(n_items);
    std::atomic<int64_t> remaining(n_tiles);
    std::mutex done_mu;
    std::condition_variable done_cv;

    std::atomic<bool> failed(false);
    auto run_tile = [&](int64_t t) {
      try {
        Tensor items;
        items.dt = DT::I32;
        items.shape = {T};
        items.i.resize(T);
        const int64_t lo = t * T, hi = std::min(n_items, lo + T);
        for (int64_t j = 0; j < T; ++j)
          items.i[j] = std::min(lo + j, n_items - 1);  // pad tail with a
                                                       // clamped id; dropped
        std::vector<Tensor> args;
        args.reserve(base.size() + 1);
        args.push_back(base[0]);
        args.push_back(std::move(items));
        for (size_t k = 1; k < base.size(); ++k) args.push_back(base[k]);
        Executor ex(*score_tile_prog);
        auto outs = ex.run(std::move(args));
        std::copy(outs[0].f.begin(), outs[0].f.begin() + (hi - lo),
                  scores.begin() + lo);
      } catch (...) {
        // the caller must still unblock and every tile must still count
        // down — a throw here would otherwise hang the request forever
        failed.store(true, std::memory_order_release);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> l(done_mu);
        done_cv.notify_all();
      }
    };

    auto& pool = TilePool::instance();
    pool.ensure_started();
    for (int64_t t = 1; t < n_tiles; ++t)
      pool.submit([&, t] { run_tile(t); });
    run_tile(0);
    // help drain (possibly other requests' tiles) until ours are done
    while (remaining.load(std::memory_order_acquire) > 0) {
      if (!pool.try_run_one()) {
        std::unique_lock<std::mutex> l(done_mu);
        done_cv.wait_for(l, std::chrono::microseconds(200),
                         [&] { return remaining.load() == 0; });
      }
    }
    if (failed.load(std::memory_order_acquire))
      throw std::runtime_error("tiled scoring failed");
    return scores;
  }

  // Stored short/long histories for the feat family come from the
  // program's baked tables only when the request has no seq — but the
  // score_dyn program takes seq as an INPUT, so the server must supply
  // the stored rows; they are exported per-family:
  std::vector<int32_t> stored_short_rows, stored_long_rows;

  Tensor stored_short_seq(int64_t uid) const {
    return stored_seq(uid, stored_short_rows, max_seq_len);
  }
  Tensor stored_long_seq(int64_t uid) const {
    return stored_seq(uid, stored_long_rows, long_max_len);
  }

  // TwoTower family: user tower with override rows, then dot with the
  // exported item-embedding matrix.
  std::vector<float> scores_tower_feats(int64_t uid, const JV* feats) const {
    std::vector<Tensor> args;
    for (const auto& name : inputs) {
      if (name == "users") args.push_back(users_tensor(uid));
      else if (name == "user_sparse_row") args.push_back(sparse_row_for(uid, feats));
      else if (name == "user_dense_row") args.push_back(dense_row_for(uid, feats));
      else throw std::runtime_error("unknown tower input " + name);
    }
    return scores_via_tower(std::move(args));
  }

  std::vector<float> scores_dyn_family(
      int64_t uid, const std::vector<int64_t>* raw_seq) const {
    Tensor seq = raw_seq ? seq_tensor(*raw_seq, max_seq_len)
                         : stored_seq(uid, recent_seq, max_seq_len);
    std::vector<Tensor> args;
    args.push_back(users_tensor(uid));
    args.push_back(std::move(seq));
    return scores_via_tower(std::move(args));
  }

  // ---- dyn-family request coalescing (the TF Serving batching trick,
  // reference libserving/actix_serving/src/tf_deploy.rs:1, with no added
  // latency window): the first request through becomes the LEADER and
  // executes immediately; requests arriving while it runs enqueue, and
  // the leader drains them in groups of `dyn_batch` — one user_repr_b
  // execution + one (B, D) x (D, n_items) GEMM whose item rows stream
  // once for all B requests instead of once per request.
  struct DynPending {
    std::vector<Tensor> args;
    std::vector<float>* out;
    bool done = false;
  };
  struct DynBatcher {
    std::mutex mu;
    std::condition_variable cv;
    std::deque<DynPending*> q;
    bool busy = false;
  };
  // heap-held so ModelRuntime stays movable (Artifacts returns by value)
  std::unique_ptr<DynBatcher> batcher_ = std::make_unique<DynBatcher>();

  std::vector<float> scores_via_tower(std::vector<Tensor> args) const {
    std::vector<float> scores(n_items);
    if (!user_repr_b.has_value() || dyn_batch <= 1) {
      run_tower_group({}, &args, &scores);  // no coalescing artifact
      return scores;
    }
    DynPending me{std::move(args), &scores};
    std::unique_lock<std::mutex> l(batcher_->mu);
    if (batcher_->busy) {
      batcher_->q.push_back(&me);
      // woken either scored (done) or promoted: a leader that hit its
      // batch cap hands leadership off so its own response isn't
      // withheld indefinitely under a sustained arrival stream
      batcher_->cv.wait(l, [&] { return me.done || !batcher_->busy; });
      if (me.done) return scores;
      auto it = std::find(batcher_->q.begin(), batcher_->q.end(), &me);
      if (it != batcher_->q.end()) batcher_->q.erase(it);
    }
    batcher_->busy = true;
    l.unlock();
    // on ANY throw the leader must release the gate and unblock waiters,
    // or every future dyn request deadlocks on `busy`. Waiters are NOT
    // failed with the leader: the popped group is requeued un-done, busy
    // clears, and a woken waiter promotes itself to leader and retries.
    // A promoted leader always executes SOLO first, so a deterministic
    // failure degrades to one 500 per owning request — no retry loop.
    // `group` is declared BEFORE Release so it outlives the unwinding
    // destructor that reads it.
    std::vector<DynPending*> group;
    struct Release {
      DynBatcher* b;
      std::vector<DynPending*>* grp;
      ~Release() {
        if (!b) return;
        {
          std::lock_guard<std::mutex> g(b->mu);
          if (grp)  // popped group the throw left unscored: requeue
            for (auto it = grp->rbegin(); it != grp->rend(); ++it)
              b->q.push_front(*it);
          b->busy = false;
        }
        b->cv.notify_all();
      }
    } release{batcher_.get(), nullptr};
    run_tower_group({}, &me.args, &scores);  // leader: solo, no wait
    // cap 4, then hand leadership off. A round-5 A/B also tried cap 1
    // (leader tail = 2 executions): the measured /online p99/p50 ratio
    // did NOT improve (1.29 -> 1.40 normalized against the py tier in
    // the same runs) — the tail is 4-deep queueing variance on the
    // shared 4-core host, not leader batching; 4 keeps fewer leadership
    // transitions per stream
    constexpr int kMaxLeaderBatches = 4;
    for (int b = 0; b < kMaxLeaderBatches; ++b) {
      l.lock();
      if (batcher_->q.empty()) {
        batcher_->busy = false;
        release.b = nullptr;
        return scores;
      }
      group.clear();
      while (!batcher_->q.empty() &&
             int64_t(group.size()) < dyn_batch) {
        group.push_back(batcher_->q.front());
        batcher_->q.pop_front();
      }
      l.unlock();
      release.grp = &group;
      run_tower_group(group, nullptr, nullptr);
      release.grp = nullptr;
      l.lock();
      for (DynPending* p : group) p->done = true;
      l.unlock();
      batcher_->cv.notify_all();
    }
    // cap reached with waiters left: release the gate; a woken waiter
    // promotes itself to leader and the stream keeps draining
    l.lock();
    batcher_->busy = false;
    release.b = nullptr;
    l.unlock();
    batcher_->cv.notify_all();
    return scores;
  }

  // Execute the tower for either one request (`solo_args`/`solo_out`) or
  // a coalesced group, then the catalog GEMM. Group runs pad the batched
  // program's fixed width with row 0.
  void run_tower_group(const std::vector<DynPending*>& group,
                       std::vector<Tensor>* solo_args,
                       std::vector<float>* solo_out) const {
    if (solo_args) {
      Executor ex(*user_repr);
      auto outs = ex.run(std::move(*solo_args));
      item_scores(outs[0].f.data(), int64_t(outs[0].f.size()),
                  solo_out->data());
      return;
    }
    const int64_t k = int64_t(group.size());
    if (k == 1) {
      Executor ex(*user_repr);
      auto outs = ex.run(std::move(group[0]->args));
      item_scores(outs[0].f.data(), int64_t(outs[0].f.size()),
                  group[0]->out->data());
      return;
    }
    // stack width-1 inputs to the batched width, padding with entry 0
    const size_t n_in = group[0]->args.size();
    std::vector<Tensor> args(n_in);
    for (size_t s = 0; s < n_in; ++s) {
      const Tensor& t0 = group[0]->args[s];
      Tensor& st = args[s];
      st.dt = t0.dt;
      st.shape = t0.shape;
      if (st.shape.empty() || st.shape[0] != 1)
        st.shape.insert(st.shape.begin(), dyn_batch);
      else
        st.shape[0] = dyn_batch;
      const int64_t row = t0.numel();
      if (st.isf()) {
        st.f.resize(row * dyn_batch);
        for (int64_t b = 0; b < dyn_batch; ++b) {
          const Tensor& src = group[std::min(b, k - 1)]->args[s];
          std::copy(src.f.begin(), src.f.end(), st.f.begin() + b * row);
        }
      } else {
        st.i.resize(row * dyn_batch);
        for (int64_t b = 0; b < dyn_batch; ++b) {
          const Tensor& src = group[std::min(b, k - 1)]->args[s];
          std::copy(src.i.begin(), src.i.end(), st.i.begin() + b * row);
        }
      }
    }
    Executor ex(*user_repr_b);
    auto outs = ex.run(std::move(args));
    const int64_t D = outs[0].shape.back();
    // one (k, D) x (D, n_items) GEMM with items outer: each item row is
    // loaded once from cache/RAM and reused by every coalesced request
    if ((has_bias ? D + 1 : D) != item_dim)
      throw std::runtime_error("user repr dim mismatch");
    std::vector<float> U(size_t(k) * item_dim);
    for (int64_t b = 0; b < k; ++b) {
      std::copy(outs[0].f.begin() + b * D, outs[0].f.begin() + (b + 1) * D,
                U.begin() + b * item_dim);
      if (has_bias) U[b * item_dim + item_dim - 1] = 1.0f;
    }
    for (int64_t i = 0; i < n_items; ++i) {
      const float* row = item_repr.data() + i * item_dim;
      for (int64_t b = 0; b < k; ++b) {
        const float* u = U.data() + b * item_dim;
        float acc = 0.f;
        for (int64_t d = 0; d < item_dim; ++d) acc += u[d] * row[d];
        (*group[b]->out)[i] = acc;
      }
    }
  }

  // u (D floats, + implicit bias column when has_bias) . item_repr rows
  void item_scores(const float* u_raw, int64_t d_raw, float* out) const {
    std::vector<float> u(u_raw, u_raw + d_raw);
    if (has_bias) u.push_back(1.0f);
    if (int64_t(u.size()) != item_dim)
      throw std::runtime_error("user repr dim mismatch");
    for (int64_t i = 0; i < n_items; ++i) {
      const float* row = item_repr.data() + i * item_dim;
      float acc[8] = {0.f};
      int64_t d = 0;
      for (; d + 8 <= item_dim; d += 8)
        for (int j = 0; j < 8; ++j) acc[j] += u[d + j] * row[d + j];
      float tail = 0.f;
      for (; d < item_dim; ++d) tail += u[d] * row[d];
      out[i] = ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
               ((acc[2] + acc[6]) + (acc[3] + acc[7])) + tail;
    }
  }
};

}  // namespace jxi
