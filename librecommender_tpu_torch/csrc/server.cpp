// Native recommendation server: multithreaded HTTP/1.1 over all four
// endpoint families (knn / embed / model / online).
//
// The port's copy of the JAX package's
// librecommender_tpu/serving/native_server/server.cpp, kept in step
// with it: it serves the artifacts of either package's export_native.
//
// C++ replacement for the reference's Rust serving tier
// (libserving/actix_serving/src/{main.rs:35, embed_deploy.rs, knn_deploy.rs,
// tf_deploy.rs, online_deploy.rs}): loads the flat binary artifacts exported
// by serving/serialization.py and answers POST /{knn,embed}/recommend
// in-process; POST /{model,online}/recommend execute the model's exported
// scoring program IN-PROCESS via the jaxpr interpreter (model_runtime.hpp)
// — where the reference's actix tier pays a network hop to TF Serving's
// C++ runtime (tf_deploy.rs), this server embeds the runtime, including
// online request-time user_feats/seq feature assembly. When no program
// artifacts are exported, those families fall back to delegating the
// forward to a backend scorer URL (the Python model app).
//
// Design: per-thread epoll event loops (EPOLLEXCLUSIVE-shared listen
// socket) with HTTP/1.1 keep-alive and pipelined request parsing;
// per-request work is a vectorized dot product over the item matrix (or
// an IVF probe when the index is exported) + partial_sort. No external
// dependencies: a ~60-line scanner handles the flat JSON bodies and a
// loopback POSIX-socket client talks to the backend.
//
// Usage: server <artifact_dir> <port> [n_threads] [backend_host backend_port]

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>

#include "model_runtime.hpp"

namespace {

struct Matrix {
  std::vector<float> data;
  int64_t rows = 0, cols = 0;
  const float* row(int64_t r) const { return data.data() + r * cols; }
};

struct Csr {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<float> data;
};

struct Artifacts {
  Matrix user_embed, item_embed;
  Matrix sim_vals;                       // (rows, k)
  std::vector<int32_t> sim_ids;          // (rows, k)
  int64_t sim_k = 0;
  std::string cf_mode;
  Csr interaction;
  std::unordered_map<std::string, int32_t> user2id;
  std::vector<std::string> id2item;
  std::vector<std::vector<int32_t>> consumed;
  int32_t n_items = 0;
  bool has_embed = false, has_knn = false;
  // IVF ANN index over item embeddings (reference: faiss-backed
  // embed_deploy.rs): coarse centroids + padded inverted lists
  Matrix ivf_centroids;
  std::vector<int32_t> ivf_lists;  // (C, L) padded with -1
  int64_t ivf_list_len = 0;
  int ivf_n_probe = 8;
  bool has_ivf = false;
  // in-process model/online scoring runtime (jaxpr interpreter over the
  // exported programs); when absent those families fall back to the
  // Python-backend hop
  jxi::ModelRuntime runtime;
};

template <typename T>
std::vector<T> read_bin(const std::string& path) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return {};
  const auto size = f.tellg();
  f.seekg(0);
  std::vector<T> out(size / sizeof(T));
  f.read(reinterpret_cast<char*>(out.data()), out.size() * sizeof(T));
  return out;
}

std::string read_text(const std::string& path) {
  std::ifstream f(path);
  std::stringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// --- tiny JSON helpers (flat objects / simple maps only) -------------------
std::string json_str(const std::string& body, const std::string& key) {
  const auto kq = "\"" + key + "\"";
  auto p = body.find(kq);
  if (p == std::string::npos) return "";
  p = body.find(':', p + kq.size());
  if (p == std::string::npos) return "";
  ++p;
  while (p < body.size() && isspace((unsigned char)body[p])) ++p;
  if (body[p] == '"') {
    const auto e = body.find('"', p + 1);
    return body.substr(p + 1, e - p - 1);
  }
  auto e = p;
  while (e < body.size() && (isdigit((unsigned char)body[e]) || body[e] == '-' ||
                             body[e] == '.'))
    ++e;
  return body.substr(p, e - p);
}

void parse_str_int_map(const std::string& text,
                       std::unordered_map<std::string, int32_t>* out) {
  size_t p = 0;
  while ((p = text.find('"', p)) != std::string::npos) {
    const auto e = text.find('"', p + 1);
    if (e == std::string::npos) break;
    const std::string key = text.substr(p + 1, e - p - 1);
    auto c = text.find(':', e);
    if (c == std::string::npos) break;
    ++c;
    while (c < text.size() && isspace((unsigned char)text[c])) ++c;
    auto v = c;
    while (v < text.size() && (isdigit((unsigned char)text[v]) || text[v] == '-'))
      ++v;
    if (v > c) (*out)[key] = std::stoi(text.substr(c, v - c));
    p = v;
  }
}

Artifacts load_artifacts(const std::string& dir) {
  Artifacts a;
  const auto meta = read_text(dir + "/native_meta.json");
  a.n_items = std::stoi(json_str(meta, "n_items"));
  // id maps
  parse_str_int_map(read_text(dir + "/user2id.json"), &a.user2id);
  std::vector<int64_t> id2item_ints;
  {
    id2item_ints = read_bin<int64_t>(dir + "/id2item_ints.bin");
    a.id2item.reserve(id2item_ints.size());
    for (const auto v : id2item_ints) a.id2item.push_back(std::to_string(v));
  }
  // consumed CSR
  {
    const auto indptr = read_bin<int64_t>(dir + "/consumed_indptr.bin");
    const auto ids = read_bin<int32_t>(dir + "/consumed_indices.bin");
    if (!indptr.empty()) {
      a.consumed.resize(indptr.size() - 1);
      for (size_t u = 0; u + 1 < indptr.size(); ++u)
        a.consumed[u].assign(ids.begin() + indptr[u], ids.begin() + indptr[u + 1]);
    }
  }
  // embed artifacts
  {
    const auto shape = read_bin<int64_t>(dir + "/user_embed_shape.bin");
    if (shape.size() == 2) {
      a.user_embed.rows = shape[0];
      a.user_embed.cols = shape[1];
      a.user_embed.data = read_bin<float>(dir + "/user_embed.bin");
      const auto ishape = read_bin<int64_t>(dir + "/item_embed_shape.bin");
      a.item_embed.rows = ishape[0];
      a.item_embed.cols = ishape[1];
      a.item_embed.data = read_bin<float>(dir + "/item_embed.bin");
      a.has_embed = true;
    }
  }
  // IVF artifacts (optional)
  {
    const auto cshape = read_bin<int64_t>(dir + "/ivf_centroids_shape.bin");
    const auto lshape = read_bin<int64_t>(dir + "/ivf_lists_shape.bin");
    if (cshape.size() == 2 && lshape.size() == 2) {
      a.ivf_centroids.rows = cshape[0];
      a.ivf_centroids.cols = cshape[1];
      a.ivf_centroids.data = read_bin<float>(dir + "/ivf_centroids.bin");
      a.ivf_lists = read_bin<int32_t>(dir + "/ivf_lists.bin");
      a.ivf_list_len = lshape[1];
      const auto np = json_str(meta, "ivf_n_probe");
      if (!np.empty()) a.ivf_n_probe = std::atoi(np.c_str());
      a.has_ivf = a.has_embed && !a.ivf_lists.empty();
    }
  }
  // native model/online scoring programs (optional)
  try {
    a.runtime.load(dir, id2item_ints);
  } catch (const std::exception& e) {
    std::cerr << "model runtime load failed: " << e.what() << std::endl;
  }
  // knn artifacts
  {
    const auto shape = read_bin<int64_t>(dir + "/sims_shape.bin");
    if (shape.size() == 2) {
      a.sim_k = shape[1];
      a.sim_ids = read_bin<int32_t>(dir + "/sim_ids.bin");
      a.sim_vals.rows = shape[0];
      a.sim_vals.cols = shape[1];
      a.sim_vals.data = read_bin<float>(dir + "/sim_vals.bin");
      a.cf_mode = json_str(meta, "cf_mode");
      a.interaction.indptr = read_bin<int64_t>(dir + "/inter_indptr.bin");
      a.interaction.indices = read_bin<int32_t>(dir + "/inter_indices.bin");
      a.interaction.data = read_bin<float>(dir + "/inter_data.bin");
      a.has_knn = true;
    }
  }
  return a;
}

std::vector<int32_t> topk_filtered(std::vector<float>& scores,
                                   const std::vector<int32_t>& consumed,
                                   int k) {
  for (const auto c : consumed)
    if (c >= 0 && c < (int32_t)scores.size()) scores[c] = -1e30f;
  std::vector<int32_t> ids(scores.size());
  for (size_t i = 0; i < ids.size(); ++i) ids[i] = (int32_t)i;
  const int take = std::min<int>(k, ids.size());
  std::partial_sort(ids.begin(), ids.begin() + take, ids.end(),
                    [&](int32_t x, int32_t y) { return scores[x] > scores[y]; });
  ids.resize(take);
  return ids;
}

// 8 independent accumulators: explicit reassociation lets the compiler
// vectorize the reduction under plain -O3 (a single-chain float dot
// cannot be auto-vectorized without -ffast-math, which we avoid for
// deterministic scoring) — ~2.5x on the embed endpoint
inline float dotf(const float* u, const float* v, int64_t D) {
  float acc[8] = {0.f};
  int64_t d = 0;
  for (; d + 8 <= D; d += 8)
    for (int j = 0; j < 8; ++j) acc[j] += u[d + j] * v[d + j];
  for (; d < D; ++d) acc[0] += u[d] * v[d];
  return ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
         ((acc[2] + acc[6]) + (acc[3] + acc[7]));
}

// IVF probe: top-n_probe centroids by score, then exact dots over their
// inverted lists only (mirrors retrieval/ivf.py `_ivf_search`).
std::vector<int32_t> ivf_candidates(const Artifacts& a, const float* u) {
  const auto C = a.ivf_centroids.rows;
  const auto D = a.ivf_centroids.cols;
  std::vector<float> cscores(C);
  for (int64_t c = 0; c < C; ++c)
    cscores[c] = dotf(u, a.ivf_centroids.row(c), D);
  const int probe = std::min<int64_t>(a.ivf_n_probe, C);
  std::vector<int32_t> cids(C);
  for (int64_t c = 0; c < C; ++c) cids[c] = (int32_t)c;
  std::partial_sort(cids.begin(), cids.begin() + probe, cids.end(),
                    [&](int32_t x, int32_t y) { return cscores[x] > cscores[y]; });
  std::vector<int32_t> cand;
  cand.reserve(probe * a.ivf_list_len);
  for (int p = 0; p < probe; ++p) {
    const int32_t* lst = a.ivf_lists.data() + (int64_t)cids[p] * a.ivf_list_len;
    for (int64_t j = 0; j < a.ivf_list_len; ++j)
      if (lst[j] >= 0) cand.push_back(lst[j]);
  }
  return cand;
}

std::string recommend_embed(const Artifacts& a, int32_t uid, int k) {
  const auto D = a.user_embed.cols;
  const float* u = a.user_embed.row(
      uid >= 0 && uid < a.user_embed.rows ? uid : a.user_embed.rows - 1);
  if (a.has_ivf) {
    const auto cand = ivf_candidates(a, u);
    const auto& consumed =
        (uid >= 0 && uid < (int32_t)a.consumed.size()) ? a.consumed[uid]
                                                       : std::vector<int32_t>{};
    std::unordered_set<int32_t> skip(consumed.begin(), consumed.end());
    std::vector<std::pair<float, int32_t>> scored;
    scored.reserve(cand.size());
    for (const auto i : cand)
      if (!skip.count(i))
        scored.emplace_back(dotf(u, a.item_embed.row(i), D), i);
    const int take = std::min<int>(k, scored.size());
    std::partial_sort(
        scored.begin(), scored.begin() + take, scored.end(),
        [](const auto& x, const auto& y) {
          return x.first > y.first || (x.first == y.first && x.second < y.second);
        });
    std::string out = "{\"rec_list\": [";
    for (int i = 0; i < take; ++i) {
      if (i) out += ", ";
      out += a.id2item[scored[i].second];
    }
    return out + "]}";
  }
  std::vector<float> scores(a.n_items);
  for (int32_t i = 0; i < a.n_items; ++i)
    scores[i] = dotf(u, a.item_embed.row(i), D);
  const auto& consumed0 =
      (uid >= 0 && uid < (int32_t)a.consumed.size()) ? a.consumed[uid]
                                                     : std::vector<int32_t>{};
  // reference can't-filter passthrough (ranking.py:38)
  const auto& consumed =
      k + (int64_t)consumed0.size() <= (int64_t)a.n_items
          ? consumed0 : std::vector<int32_t>{};
  const auto ids = topk_filtered(scores, consumed, k);
  std::string out = "{\"rec_list\": [";
  for (size_t i = 0; i < ids.size(); ++i) {
    if (i) out += ", ";
    out += a.id2item[ids[i]];
  }
  return out + "]}";
}

std::string recommend_knn(const Artifacts& a, int32_t uid, int k) {
  std::vector<float> scores(a.n_items, 0.f);
  if (a.cf_mode == "user") {
    if (uid >= 0 && uid < a.sim_vals.rows) {
      for (int64_t j = 0; j < a.sim_k; ++j) {
        const int32_t nbr = a.sim_ids[uid * a.sim_k + j];
        if (nbr < 0) continue;
        const float sim = a.sim_vals.data[uid * a.sim_k + j];
        for (int64_t p = a.interaction.indptr[nbr];
             p < a.interaction.indptr[nbr + 1]; ++p)
          scores[a.interaction.indices[p]] += sim * a.interaction.data[p];
      }
    }
  } else {  // item mode: aggregate over the user's consumed items
    if (uid >= 0 && uid < (int32_t)a.consumed.size()) {
      for (const auto c : a.consumed[uid]) {
        for (int64_t j = 0; j < a.sim_k; ++j) {
          const int32_t nbr = a.sim_ids[(int64_t)c * a.sim_k + j];
          if (nbr >= 0) scores[nbr] += a.sim_vals.data[(int64_t)c * a.sim_k + j];
        }
      }
    }
  }
  const auto& consumed0 =
      (uid >= 0 && uid < (int32_t)a.consumed.size()) ? a.consumed[uid]
                                                     : std::vector<int32_t>{};
  // reference can't-filter passthrough (ranking.py:38)
  const auto& consumed =
      k + (int64_t)consumed0.size() <= (int64_t)a.n_items
          ? consumed0 : std::vector<int32_t>{};
  const auto ids = topk_filtered(scores, consumed, k);
  std::string out = "{\"rec_list\": [";
  size_t n = 0;
  for (const auto id : ids) {
    if (scores[id] <= -1e29f || scores[id] == 0.f) continue;
    if (n++) out += ", ";
    out += a.id2item[id];
  }
  return out + "]}";
}

// Extract the RAW JSON value (object/array/string/number) for a key by
// bracket matching, so dynamic "user_feats"/"seq" pass through verbatim.
std::string json_raw_value(const std::string& body, const std::string& key) {
  const auto kq = "\"" + key + "\"";
  auto p = body.find(kq);
  if (p == std::string::npos) return "";
  p = body.find(':', p + kq.size());
  if (p == std::string::npos) return "";
  ++p;
  while (p < body.size() && isspace((unsigned char)body[p])) ++p;
  if (p >= body.size()) return "";
  const char c = body[p];
  if (c == '{' || c == '[') {
    const char open = c, close = c == '{' ? '}' : ']';
    int depth = 0;
    bool in_str = false;
    for (auto e = p; e < body.size(); ++e) {
      const char ch = body[e];
      if (in_str) {
        if (ch == '\\') ++e;
        else if (ch == '"') in_str = false;
      } else if (ch == '"') {
        in_str = true;
      } else if (ch == open) {
        ++depth;
      } else if (ch == close) {
        if (--depth == 0) return body.substr(p, e - p + 1);
      }
    }
    return "";
  }
  if (c == '"') {
    for (auto e = p + 1; e < body.size(); ++e) {
      if (body[e] == '\\') ++e;
      else if (body[e] == '"') return body.substr(p, e - p + 1);
    }
    return "";
  }
  auto e = p;
  while (e < body.size() && (isdigit((unsigned char)body[e]) || body[e] == '-' ||
                             body[e] == '.' || body[e] == 'e' || body[e] == '+'))
    ++e;
  return body.substr(p, e - p);
}

// Minimal loopback HTTP client: POST json to the backend scorer, return the
// response body ("" on failure). Mirrors tf_deploy.rs's reqwest hop.
std::string backend_post(const std::string& host, int port,
                         const std::string& path, const std::string& json) {
  const int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return "";
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1 ||
      ::connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return "";
  }
  std::string req = "POST " + path + " HTTP/1.1\r\nHost: " + host +
                    "\r\nContent-Type: application/json\r\nContent-Length: " +
                    std::to_string(json.size()) + "\r\nConnection: close\r\n\r\n" +
                    json;
  size_t off = 0;
  while (off < req.size()) {
    const auto n = ::send(fd, req.data() + off, req.size() - off, 0);
    if (n <= 0) { ::close(fd); return ""; }
    off += n;
  }
  std::string resp;
  char buf[8192];
  while (true) {
    const auto n = ::recv(fd, buf, sizeof(buf), 0);
    if (n <= 0) break;
    resp.append(buf, n);
    if (resp.size() > (8u << 20)) break;  // 8 MiB response cap
  }
  ::close(fd);
  const auto p = resp.find("\r\n\r\n");
  return p == std::string::npos ? "" : resp.substr(p + 4);
}

// Parse a flat JSON int array ("[3, 1, 4]") into a vector.
std::vector<int64_t> parse_int_array(const std::string& raw) {
  std::vector<int64_t> out;
  size_t p = 0;
  while (p < raw.size()) {
    while (p < raw.size() && !isdigit((unsigned char)raw[p]) && raw[p] != '-')
      ++p;
    if (p >= raw.size()) break;
    errno = 0;
    char* end = nullptr;
    const long long v = std::strtoll(raw.c_str() + p, &end, 10);
    if (end == raw.c_str() + p) break;
    if (errno == 0) out.push_back(v);
    p = end - raw.c_str();
  }
  return out;
}

struct Backend {
  std::string host;
  int port = 0;
  bool configured() const { return port > 0; }
};

// model/online endpoints: candidate sizing + consumed filtering + raw-id
// mapping natively; scoring delegated to the backend's /candidates route
// (online_deploy.py:25 candidate logic k = n_rec + |consumed|).
std::string recommend_via_backend(const Artifacts& a, const Backend& be,
                                  int32_t uid,
                                  int n_rec, const std::string& feats_raw,
                                  const std::string& seq_raw) {
  const auto& consumed =
      (uid >= 0 && uid < (int32_t)a.consumed.size()) ? a.consumed[uid]
                                                     : std::vector<int32_t>{};
  const int k = std::min<int>(n_rec + (int)consumed.size(), a.n_items);
  std::string req = "{\"user_inner\": " + std::to_string(uid) +
                    ", \"k\": " + std::to_string(k);
  if (!feats_raw.empty()) req += ", \"user_feats\": " + feats_raw;
  if (!seq_raw.empty()) req += ", \"seq\": " + seq_raw;
  req += "}";
  const auto resp = backend_post(be.host, be.port, "/candidates", req);
  if (resp.empty()) return "";
  const auto cands = parse_int_array(json_raw_value(resp, "candidates"));
  std::unordered_set<int32_t> skip(consumed.begin(), consumed.end());
  std::string out = "{\"rec_list\": [";
  int taken = 0;
  for (const auto c : cands) {
    if (taken >= n_rec) break;
    if (c < 0 || c >= (int64_t)a.id2item.size() || skip.count((int32_t)c))
      continue;
    if (taken++) out += ", ";
    out += a.id2item[c];
  }
  return out + "]}";
}

std::string http_response(int status, const std::string& body, bool keep) {
  std::string head = "HTTP/1.1 " + std::to_string(status) +
                     (status == 200 ? " OK" : " Bad Request") +
                     "\r\nContent-Type: application/json\r\nContent-Length: " +
                     std::to_string(body.size()) +
                     (keep ? "\r\nConnection: keep-alive\r\n\r\n"
                           : "\r\nConnection: close\r\n\r\n");
  head += body;
  return head;
}

// Parse an integer field from untrusted JSON, clamped to [lo, hi]; any
// parse failure returns the default (advisor finding: std::stoi on raw
// request data can throw and std::terminate a worker thread).
int parse_int_field(const std::string& body, const std::string& key,
                    int dflt, int lo, int hi) {
  const auto raw = json_str(body, key);
  if (raw.empty()) return dflt;
  errno = 0;
  char* end = nullptr;
  const long v = std::strtol(raw.c_str(), &end, 10);
  if (errno != 0 || end == raw.c_str()) return dflt;
  return (int)std::max<long>(lo, std::min<long>(hi, v));
}

constexpr size_t kMaxBody = 1 << 20;  // 1 MiB request cap

// Dispatch one parsed request -> (status, response body). `req` is the
// request line + headers; `body` is exactly the JSON payload.
std::pair<int, std::string> dispatch_checked(const std::string& req,
                                             const std::string& body,
                                             const Artifacts& a,
                                             const Backend& be) {
  if (req.rfind("GET /health", 0) == 0) {
    return {200, "{\"status\": \"ok\"}"};
  } else if (req.rfind("POST /embed/recommend", 0) == 0 && a.has_embed) {
    const auto user = json_str(body, "user");
    const int n_rec = parse_int_field(body, "n_rec", 10, 1, a.n_items);
    const auto it = a.user2id.find(user);
    const int32_t uid = it == a.user2id.end() ? -1 : it->second;
    return {200, recommend_embed(a, uid, n_rec)};
  } else if (req.rfind("POST /knn/recommend", 0) == 0 && a.has_knn) {
    const auto user = json_str(body, "user");
    const int n_rec = parse_int_field(body, "n_rec", 10, 1, a.n_items);
    const auto it = a.user2id.find(user);
    const int32_t uid = it == a.user2id.end() ? -1 : it->second;
    return {200, recommend_knn(a, uid, n_rec)};
  } else if ((req.rfind("POST /model/recommend", 0) == 0 ||
              req.rfind("POST /online/recommend", 0) == 0) &&
             a.runtime.loaded) {
    // in-process scoring: no Python, no backend hop
    const bool online = req.rfind("POST /online/recommend", 0) == 0;
    const auto user = json_str(body, "user");
    const int n_rec = parse_int_field(body, "n_rec", 10, 1, a.n_items);
    const auto it = a.user2id.find(user);
    const int64_t uid =
        it == a.user2id.end() ? a.runtime.n_users : it->second;
    if (!online && a.runtime.static_k > 0) {
      // precomputed static list (default_recs analog); empty -> request
      // needs a deeper list than the table holds, fall through to live.
      // Reference can't-filter semantics: when the unconsumed remainder
      // can't fill n_rec, serve the unfiltered list (ranking.py:38)
      const auto& table_consumed0 =
          (uid >= 0 && uid < (int64_t)a.consumed.size())
              ? a.consumed[uid] : std::vector<int32_t>{};
      const bool table_can_filter =
          n_rec + (int64_t)table_consumed0.size() <= (int64_t)a.n_items;
      const auto ids = a.runtime.topk_from_table(
          uid, table_can_filter ? table_consumed0 : std::vector<int32_t>{},
          n_rec);
      if (!ids.empty()) {
        std::string out = "{\"rec_list\": [";
        for (size_t i = 0; i < ids.size(); ++i) {
          if (i) out += ", ";
          out += a.id2item[ids[i]];
        }
        return {200, out + "]}"};
      }
    }
    std::vector<float> scores;
    if (online) {
      const auto feats_raw = json_raw_value(body, "user_feats");
      const auto seq_raw = json_raw_value(body, "seq");
      const auto seq = parse_int_array(seq_raw);
      std::unique_ptr<jxi::JV> feats;
      if (!feats_raw.empty() && feats_raw[0] == '{')
        feats = std::make_unique<jxi::JV>(
            jxi::JsonParser(feats_raw).parse());
      scores = a.runtime.scores_online(uid, feats.get(), seq);
    } else {
      scores = a.runtime.scores_static(uid);
    }
    const auto& consumed0 =
        (uid >= 0 && uid < (int64_t)a.consumed.size())
            ? a.consumed[uid] : std::vector<int32_t>{};
    // reference can't-filter semantics (ranking.py:38): when the
    // unconsumed remainder can't fill n_rec, return the unfiltered top-k
    const bool can_filter =
        n_rec + (int64_t)consumed0.size() <= (int64_t)a.n_items;
    const auto& consumed =
        can_filter ? consumed0 : std::vector<int32_t>{};
    const auto ids = topk_filtered(scores, consumed, n_rec);
    std::string out = "{\"rec_list\": [";
    for (size_t i = 0; i < ids.size(); ++i) {
      if (i) out += ", ";
      out += a.id2item[ids[i]];
    }
    return {200, out + "]}"};
  } else if ((req.rfind("POST /model/recommend", 0) == 0 ||
              req.rfind("POST /online/recommend", 0) == 0) &&
             be.configured()) {
    const bool online = req.rfind("POST /online/recommend", 0) == 0;
    const auto user = json_str(body, "user");
    const int n_rec = parse_int_field(body, "n_rec", 10, 1, a.n_items);
    const auto it = a.user2id.find(user);
    const int32_t uid = it == a.user2id.end() ? -1 : it->second;
    const auto feats = online ? json_raw_value(body, "user_feats") : "";
    const auto seq = online ? json_raw_value(body, "seq") : "";
    const auto resp = recommend_via_backend(a, be, uid, n_rec, feats, seq);
    if (resp.empty()) return {502, "{\"error\": \"backend unavailable\"}"};
    return {200, resp};
  } else {
    return {400, "{\"error\": \"unknown endpoint\"}"};
  }
}

std::pair<int, std::string> dispatch(const std::string& req,
                                     const std::string& body,
                                     const Artifacts& a, const Backend& be) {
  try {
    return dispatch_checked(req, body, a, be);
  } catch (const std::exception& e) {
    return {400, std::string("{\"error\": \"") + e.what() + "\"}"};
  } catch (...) {
    return {400, "{\"error\": \"internal\"}"};
  }
}

// ---------------------------------------------------------------- event loop
// Each server thread runs its own epoll instance; the (non-blocking) listen
// socket is registered in every instance with EPOLLEXCLUSIVE so the kernel
// wakes exactly one loop per incoming connection, and a connection then
// lives on the thread that accepted it (no cross-thread state). Requests
// are parsed incrementally from a per-connection buffer and dispatched
// inline — endpoint work is microseconds (dot products / neighbor-list
// aggregation over in-memory artifacts), so an evented design serves
// thousands of keep-alive connections per thread without a handoff queue.
// The model/online families proxy to the Python backend with a blocking
// call; those deployments should size n_threads to the expected in-flight
// backend fan-out (mirrors the reference's actix worker sizing).
struct Conn {
  std::string in;
  std::string out;
  size_t out_off = 0;
  std::chrono::steady_clock::time_point last;
  bool close_after_write = false;
};

bool set_nonblocking(int fd) {
  const int fl = ::fcntl(fd, F_GETFL, 0);
  return fl >= 0 && ::fcntl(fd, F_SETFL, fl | O_NONBLOCK) == 0;
}

// Drain c.out to the socket; returns false on fatal error.
bool flush_out(int fd, Conn& c) {
  while (c.out_off < c.out.size()) {
    const auto n =
        ::send(fd, c.out.data() + c.out_off, c.out.size() - c.out_off,
               MSG_NOSIGNAL);
    if (n > 0) {
      c.out_off += n;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
    return false;
  }
  c.out.clear();
  c.out_off = 0;
  return true;
}

// Parse + serve every complete pipelined request in c.in; sets
// close_after_write on oversized/malformed input or Connection: close.
void process_buffer(Conn& c, const Artifacts& a, const Backend& be) {
  while (!c.close_after_write) {
    const auto hdr_end = c.in.find("\r\n\r\n");
    if (hdr_end == std::string::npos) {
      if (c.in.size() > kMaxBody + 8192) {
        c.out += http_response(400, "{\"error\": \"request too large\"}",
                               false);
        c.close_after_write = true;
      }
      return;
    }
    size_t content_len = 0;
    auto cl = c.in.find("Content-Length:");
    if (cl == std::string::npos) cl = c.in.find("content-length:");
    if (cl != std::string::npos && cl < hdr_end) {
      errno = 0;
      char* end = nullptr;
      const unsigned long v = std::strtoul(c.in.c_str() + cl + 15, &end, 10);
      if (errno != 0 || v > kMaxBody) {
        c.out += http_response(400, "{\"error\": \"bad content-length\"}",
                               false);
        c.close_after_write = true;
        return;
      }
      content_len = v;
    }
    const size_t body_start = hdr_end + 4;
    if (c.in.size() < body_start + content_len) return;  // need more bytes
    const std::string head = c.in.substr(0, hdr_end);
    const std::string body = c.in.substr(body_start, content_len);
    c.in.erase(0, body_start + content_len);
    const bool keep = head.find("Connection: close") == std::string::npos &&
                      head.find("connection: close") == std::string::npos &&
                      head.find("HTTP/1.0") == std::string::npos;
    const auto res = dispatch(head, body, a, be);
    c.out += http_response(res.first, res.second, keep);
    if (!keep) c.close_after_write = true;
  }
}

constexpr int kIdleTimeoutSec = 30;

void run_loop(int listen_fd, const Artifacts& a, const Backend& be) {
  const int ep = ::epoll_create1(0);
  epoll_event lev{};
  lev.events = EPOLLIN | EPOLLEXCLUSIVE;
  lev.data.fd = listen_fd;
  ::epoll_ctl(ep, EPOLL_CTL_ADD, listen_fd, &lev);
  std::unordered_map<int, Conn> conns;
  auto last_sweep = std::chrono::steady_clock::now();
  epoll_event events[64];
  char buf[16384];
  while (true) {
    const int n = ::epoll_wait(ep, events, 64, 1000);
    const auto now = std::chrono::steady_clock::now();
    for (int i = 0; i < n; ++i) {
      const int fd = events[i].data.fd;
      if (fd == listen_fd) {
        while (true) {
          const int cfd = ::accept(listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          set_nonblocking(cfd);
          int one = 1;
          ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          ::epoll_ctl(ep, EPOLL_CTL_ADD, cfd, &cev);
          conns[cfd].last = now;
        }
        continue;
      }
      auto it = conns.find(fd);
      if (it == conns.end()) continue;
      Conn& c = it->second;
      c.last = now;
      bool dead = (events[i].events & (EPOLLERR | EPOLLHUP)) != 0;
      if (!dead && (events[i].events & EPOLLIN)) {
        while (true) {
          const auto r = ::recv(fd, buf, sizeof(buf), 0);
          if (r > 0) {
            c.in.append(buf, r);
            continue;
          }
          if (r == 0) dead = true;  // peer closed
          if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK) dead = true;
          break;
        }
        if (!dead) process_buffer(c, a, be);
      }
      if (!dead && !flush_out(fd, c)) dead = true;
      if (!dead && c.out.empty() && c.close_after_write) dead = true;
      if (dead) {
        ::epoll_ctl(ep, EPOLL_CTL_DEL, fd, nullptr);
        ::close(fd);
        conns.erase(it);
        continue;
      }
      // arm/disarm EPOLLOUT depending on pending writes
      epoll_event cev{};
      cev.events = EPOLLIN | (c.out.empty() ? 0 : EPOLLOUT);
      cev.data.fd = fd;
      ::epoll_ctl(ep, EPOLL_CTL_MOD, fd, &cev);
    }
    if (now - last_sweep > std::chrono::seconds(5)) {
      last_sweep = now;
      for (auto it = conns.begin(); it != conns.end();) {
        if (now - it->second.last >
            std::chrono::seconds(kIdleTimeoutSec)) {
          ::epoll_ctl(ep, EPOLL_CTL_DEL, it->first, nullptr);
          ::close(it->first);
          it = conns.erase(it);
        } else {
          ++it;
        }
      }
    }
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::cerr << "usage: server <artifact_dir> <port> [n_threads]\n"
              << "       server <artifact_dir> --build-topk [K]\n";
    return 1;
  }
  const std::string dir = argv[1];
  if (std::string(argv[2]) == "--build-topk") {
    // Rebuild static_topk.bin THROUGH the serving interpreter so the
    // precomputed /model table and the live tiled fallback are
    // bit-consistent (the XLA-built table can disagree on near-ties —
    // docs/serving_guide.md §4). Ranking: score desc, id asc — identical
    // to the live partial_sort comparator on non-tied scores and
    // deterministic on ties.
    const Artifacts artifacts = load_artifacts(dir);
    const jxi::ModelRuntime& rt = artifacts.runtime;
    if (rt.static_k == 0) {
      std::cerr << "artifact has no static_topk to rebuild\n";
      return 1;
    }
    const int64_t K =
        argc > 3 ? std::atoll(argv[3]) : int64_t(rt.static_k);
    const int64_t rows = rt.n_users + 1;  // + OOV/cold row
    std::vector<int32_t> table(size_t(rows * K));
    std::vector<int32_t> ids(size_t(rt.n_items));
    for (int64_t row = 0; row < rows; ++row) {
      const std::vector<float> scores = rt.scores_static(row);
      for (size_t i = 0; i < ids.size(); ++i) ids[i] = int32_t(i);
      const int64_t take = std::min<int64_t>(K, int64_t(ids.size()));
      std::partial_sort(
          ids.begin(), ids.begin() + take, ids.end(),
          [&](int32_t x, int32_t y) {
            return scores[x] != scores[y] ? scores[x] > scores[y] : x < y;
          });
      std::copy(ids.begin(), ids.begin() + take,
                table.begin() + row * K);
    }
    const int64_t shape[2] = {rows, K};
    {
      std::ofstream f(dir + "/static_topk_shape.bin", std::ios::binary);
      f.write(reinterpret_cast<const char*>(shape), sizeof(shape));
    }
    {
      std::ofstream f(dir + "/static_topk.bin", std::ios::binary);
      f.write(reinterpret_cast<const char*>(table.data()),
              std::streamsize(table.size() * sizeof(int32_t)));
    }
    std::cout << "rebuilt static_topk via interpreter: " << rows << " x "
              << K << std::endl;
    return 0;
  }
  const int port = std::atoi(argv[2]);
  const int n_threads = argc > 3 ? std::atoi(argv[3]) : 4;
  Backend backend;
  if (argc > 5) {
    backend.host = argv[4];
    backend.port = std::atoi(argv[5]);
  }
  const Artifacts artifacts = load_artifacts(dir);

  const int server_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  int opt = 1;
  ::setsockopt(server_fd, SOL_SOCKET, SO_REUSEADDR, &opt, sizeof(opt));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (::bind(server_fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    std::cerr << "bind failed\n";
    return 1;
  }
  ::listen(server_fd, 512);
  set_nonblocking(server_fd);
  std::cout << "native server listening on 127.0.0.1:" << port << std::endl;

  std::vector<std::thread> loops;
  for (int t = 1; t < n_threads; ++t)
    loops.emplace_back(
        [&] { run_loop(server_fd, artifacts, backend); });
  run_loop(server_fd, artifacts, backend);
  for (auto& th : loops) th.join();
  return 0;
}
