// jaxpr_interp.hpp — native (C++) executor for the flat scoring programs
// serialized by serving/native_program.py.
//
// The port's copy of the JAX package's
// librecommender_tpu/serving/native_server/jaxpr_interp.hpp, kept in step
// with it: programs of either package run in either copy.
//
// Role in the architecture: the reference's serving tier delegates model
// scoring to TF Serving's C++ runtime (reference
// libserving/actix_serving/src/tf_deploy.rs:1, online_deploy_grpc.rs:38);
// here the SAME jitted jax scoring function that runs on TPU is traced to a
// jaxpr, serialized to a flat op list + constant blob, and executed
// in-process by this interpreter — model/online endpoints never leave the
// server process and never touch Python.
//
// Scope: the ~30 lax primitives that appear in this framework's scoring
// programs (dot_general, gather with batching dims, scan, conv_general_
// dilated, pad, dynamic_slice, elementwise/reduce/shape ops). Floats
// compute in f32 (bf16 constants are stored rounded-through); ints in
// int64. Shapes are fixed at export time (one program per dispatch width).
//
// Unknown primitives throw std::runtime_error naming the primitive, so a
// model whose forward uses something new fails loudly at load/first-run.
#pragma once

#include <algorithm>
#include <cassert>
#include <cctype>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <type_traits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef __GLIBC__
#include <malloc.h>
#endif

namespace jxi {

// Program intermediates are multi-MB buffers allocated and freed every op;
// glibc's default 128KB mmap threshold would mmap/munmap (and page-fault
// zero) each one. Raising the thresholds keeps them on the recycled heap —
// measured 1.3x on catalog-sized programs.
#ifdef __GLIBC__
namespace detail {
struct MallocTuning {
  MallocTuning() {
    mallopt(M_MMAP_THRESHOLD, 256 << 20);
    mallopt(M_TRIM_THRESHOLD, 256 << 20);
  }
};
static const MallocTuning malloc_tuning{};
}  // namespace detail
#endif

// ------------------------------------------------------------- minimal JSON
struct JV {
  enum T { NUL, BOO, NUM, STR, ARR, OBJ } t = NUL;
  bool boo = false;
  double num = 0;
  std::string str;
  std::vector<JV> arr;
  std::vector<std::pair<std::string, JV>> obj;

  const JV* find(const std::string& k) const {
    for (const auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  const JV& at(const std::string& k) const {
    const JV* v = find(k);
    if (!v) throw std::runtime_error("json: missing key " + k);
    return *v;
  }
  int64_t asi() const { return static_cast<int64_t>(num); }
  std::vector<int64_t> ints() const {
    std::vector<int64_t> out;
    out.reserve(arr.size());
    for (const auto& v : arr) out.push_back(v.asi());
    return out;
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& s) : s_(s) {}
  JV parse() {
    JV v = value();
    ws();
    return v;
  }

 private:
  const std::string& s_;
  size_t p_ = 0;

  void ws() {
    while (p_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[p_])))
      ++p_;
  }
  char peek() {
    ws();
    if (p_ >= s_.size()) throw std::runtime_error("json: eof");
    return s_[p_];
  }
  JV value() {
    switch (peek()) {
      case '{': return object();
      case '[': return array();
      case '"': { JV v; v.t = JV::STR; v.str = string(); return v; }
      case 't': p_ += 4; { JV v; v.t = JV::BOO; v.boo = true; return v; }
      case 'f': p_ += 5; { JV v; v.t = JV::BOO; v.boo = false; return v; }
      case 'n': p_ += 4; return JV{};
      default: return number();
    }
  }
  JV number() {
    size_t start = p_;
    while (p_ < s_.size() && (std::isdigit(static_cast<unsigned char>(s_[p_])) ||
           s_[p_] == '-' || s_[p_] == '+' || s_[p_] == '.' || s_[p_] == 'e' ||
           s_[p_] == 'E'))
      ++p_;
    JV v;
    v.t = JV::NUM;
    v.num = std::strtod(s_.c_str() + start, nullptr);
    return v;
  }
  std::string string() {
    ws();
    ++p_;  // opening quote
    std::string out;
    while (s_[p_] != '"') {
      if (s_[p_] == '\\') {
        ++p_;
        char c = s_[p_++];
        switch (c) {
          case 'n': out += '\n'; break;
          case 't': out += '\t'; break;
          case 'u': p_ += 4; out += '?'; break;  // not needed for our keys
          default: out += c;
        }
      } else {
        out += s_[p_++];
      }
    }
    ++p_;
    return out;
  }
  JV array() {
    JV v;
    v.t = JV::ARR;
    ++p_;  // [
    if (peek() == ']') { ++p_; return v; }
    while (true) {
      v.arr.push_back(value());
      char c = peek();
      ++p_;
      if (c == ']') break;
      if (c != ',') throw std::runtime_error("json: bad array");
    }
    return v;
  }
  JV object() {
    JV v;
    v.t = JV::OBJ;
    ++p_;  // {
    if (peek() == '}') { ++p_; return v; }
    while (true) {
      std::string key = string();
      if (peek() != ':') throw std::runtime_error("json: bad object");
      ++p_;
      v.obj.emplace_back(std::move(key), value());
      char c = peek();
      ++p_;
      if (c == '}') break;
      if (c != ',') throw std::runtime_error("json: bad object");
    }
    return v;
  }
};

// ------------------------------------------------------------------ tensors
enum class DT : uint8_t { F32, I64, I32, I8, U32 };

inline DT dt_from(const std::string& s) {
  if (s == "f32" || s == "bf16" || s == "f64") return DT::F32;
  if (s == "i64") return DT::I64;
  if (s == "i32") return DT::I32;
  if (s == "bool" || s == "i8") return DT::I8;
  if (s == "u32") return DT::U32;
  throw std::runtime_error("unknown dtype " + s);
}
inline bool dt_is_float(DT d) { return d == DT::F32; }

struct Tensor {
  DT dt = DT::F32;
  std::vector<int64_t> shape;
  std::vector<float> f;
  std::vector<int64_t> i;

  int64_t numel() const {
    int64_t n = 1;
    for (int64_t d : shape) n *= d;
    return n;
  }
  bool isf() const { return dt_is_float(dt); }
  void alloc() {
    if (isf()) { f.assign(numel(), 0.0f); i.clear(); }
    else { i.assign(numel(), 0); f.clear(); }
  }
  double get(int64_t k) const { return isf() ? f[k] : double(i[k]); }
};

// Per-thread output-buffer pool — built as the round-5 /online p99
// lever and MEASURED OFF by default: the hypothesis was that per-op
// malloc churn drives the long tail, but the A/B (JXI_POOL toggled,
// parity/bench_model_serving.py, full ML-1M) showed the OPPOSITE —
// /online p99 36.7/41.3 ms with the pool vs 28.4 without (p50/req_s
// unchanged). With the raised M_MMAP_THRESHOLD glibc already recycles
// these buffers LIFO, handing back cache-HOT memory; the pool's
// best-fit scan returns colder buffers and grows per-thread RSS.
// JXI_POOL=1 re-enables it for allocators/hosts where malloc is the
// bottleneck.
struct BufferPool {
  static constexpr size_t kMaxBuffers = 64;
  static constexpr size_t kMinBytes = 4096;        // don't pool tiny ones
  static constexpr size_t kMaxPoolBytes = 256u << 20;

  static bool disabled() {
    static const bool on = std::getenv("JXI_POOL") != nullptr;
    return !on;
  }
  std::vector<std::vector<float>> f;
  std::vector<std::vector<int64_t>> i;
  size_t bytes = 0;

  static BufferPool& local() {
    static thread_local BufferPool pool;
    return pool;
  }

  template <class V>
  void donate_one(std::vector<std::vector<V>>& list, std::vector<V>&& v) {
    const size_t b = v.capacity() * sizeof(V);
    if (b < kMinBytes || list.size() >= kMaxBuffers ||
        bytes + b > kMaxPoolBytes)
      return;
    bytes += b;
    v.clear();
    list.push_back(std::move(v));
  }
  void donate(Tensor&& t);

  // best-fit: smallest pooled buffer with capacity >= n (bounded linear
  // scan; the pool holds <= 64 entries)
  template <class V>
  bool acquire(std::vector<std::vector<V>>& list, size_t n,
               std::vector<V>* out) {
    int best = -1;
    for (int k = 0; k < int(list.size()); ++k) {
      if (list[k].capacity() < n) continue;
      if (best < 0 || list[k].capacity() < list[best].capacity()) best = k;
    }
    if (best < 0) return false;
    bytes -= list[best].capacity() * sizeof(V);
    *out = std::move(list[best]);
    list.erase(list.begin() + best);
    return true;
  }
};

inline void BufferPool::donate(Tensor&& t) {
  if (disabled()) return;
  if (!t.f.empty() || t.f.capacity()) donate_one(f, std::move(t.f));
  if (!t.i.empty() || t.i.capacity()) donate_one(i, std::move(t.i));
  t.shape.clear();
}

// pool-aware zero-initialized allocation (make_out's path)
inline void alloc_pooled(Tensor& t) {
  const int64_t n = t.numel();
  BufferPool& pool = BufferPool::local();
  if (t.isf()) {
    t.i.clear();
    if (t.f.capacity() < size_t(n) && size_t(n) * 4 >= BufferPool::kMinBytes)
      pool.acquire(pool.f, size_t(n), &t.f);
    t.f.assign(n, 0.0f);
  } else {
    t.f.clear();
    if (t.i.capacity() < size_t(n) && size_t(n) * 8 >= BufferPool::kMinBytes)
      pool.acquire(pool.i, size_t(n), &t.i);
    t.i.assign(n, 0);
  }
}

inline std::vector<int64_t> strides_of(const std::vector<int64_t>& shape) {
  std::vector<int64_t> st(shape.size(), 1);
  for (int d = int(shape.size()) - 2; d >= 0; --d)
    st[d] = st[d + 1] * shape[d + 1];
  return st;
}

// ------------------------------------------------------------------ program
struct TensorDecl {
  int id = -1;
  std::vector<int64_t> shape;
  DT dt = DT::F32;
  std::string dtype_name;  // logical dtype ("bf16" retains rounding hints)
};

struct SubProgram;

struct Op {
  std::string prim;
  std::vector<int> inputs;
  std::vector<TensorDecl> outputs;
  JV attrs;
  std::shared_ptr<SubProgram> body;  // scan
  // liveness: input k's register dies at this op (not a constant, not a
  // program output, no later consumer) — layout ops may MOVE it instead
  // of deep-copying multi-MB buffers
  std::vector<bool> input_dies;
};

struct ConstDecl {
  TensorDecl decl;
  int64_t offset = 0;
  std::string stored;  // physical dtype in the blob
};

struct SubProgram {
  std::vector<TensorDecl> inputs;
  std::vector<ConstDecl> constants;
  std::vector<Op> ops;
  std::vector<int> outputs;
  int max_id = 0;
  // constants decoded once at load time (heap-stable under Program moves);
  // looked up by id at execution instead of re-reading the blob per run
  std::map<int, Tensor> const_vals;
};

struct Program {
  SubProgram main;
  std::vector<char> blob;
};

inline TensorDecl parse_decl(const JV& j) {
  TensorDecl d;
  d.id = int(j.at("id").asi());
  d.shape = j.at("shape").ints();
  d.dtype_name = j.at("dtype").str;
  d.dt = dt_from(d.dtype_name);
  return d;
}

// Mark, for every op input, whether its register dies there (no later
// consumer, not a subprogram output). Constants are excluded at execution
// time (they live in const_vals, not regs). Walk backwards: first sighting
// of an id is its last use.
inline void compute_liveness(SubProgram* sp) {
  std::vector<bool> seen(size_t(sp->max_id) + 1, false);
  for (int oid : sp->outputs)
    if (oid >= 0 && oid <= sp->max_id) seen[oid] = true;
  for (auto it = sp->ops.rbegin(); it != sp->ops.rend(); ++it) {
    Op& op = *it;
    op.input_dies.assign(op.inputs.size(), false);
    // within one op, only the LAST occurrence of a repeated id may move
    for (size_t k = op.inputs.size(); k-- > 0;) {
      const int id = op.inputs[k];
      if (id >= 0 && id <= sp->max_id && !seen[id]) {
        op.input_dies[k] = true;
        seen[id] = true;
      }
    }
  }
}

inline void parse_subprogram(const JV& j, SubProgram* sp) {
  for (const auto& v : j.at("inputs").arr) {
    sp->inputs.push_back(parse_decl(v));
    sp->max_id = std::max(sp->max_id, sp->inputs.back().id);
  }
  for (const auto& v : j.at("constants").arr) {
    ConstDecl c;
    c.decl = parse_decl(v);
    c.offset = v.at("offset").asi();
    const JV* st = v.find("stored");
    c.stored = st ? st->str : c.decl.dtype_name;
    sp->constants.push_back(c);
    sp->max_id = std::max(sp->max_id, c.decl.id);
  }
  for (const auto& v : j.at("ops").arr) {
    Op op;
    op.prim = v.at("prim").str;
    for (const auto& x : v.at("inputs").arr) op.inputs.push_back(int(x.asi()));
    for (const auto& x : v.at("outputs").arr) {
      op.outputs.push_back(parse_decl(x));
      sp->max_id = std::max(sp->max_id, op.outputs.back().id);
    }
    op.attrs = v.at("attrs");
    if (const JV* b = v.find("body")) {
      op.body = std::make_shared<SubProgram>();
      parse_subprogram(*b, op.body.get());
    }
    sp->ops.push_back(std::move(op));
  }
  for (const auto& v : j.at("outputs").arr) sp->outputs.push_back(int(v.asi()));
  compute_liveness(sp);
}

inline std::string read_file(const std::string& path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) throw std::runtime_error("cannot open " + path);
  std::string data((std::istreambuf_iterator<char>(in)),
                   std::istreambuf_iterator<char>());
  return data;
}

inline Tensor decode_const(const ConstDecl& c, const std::vector<char>& blob) {
  Tensor t;
  t.dt = c.decl.dt;
  t.shape = c.decl.shape;
  const char* src = blob.data() + c.offset;
  const int64_t n = t.numel();
  if (c.stored == "f32") {
    t.f.resize(n);
    std::memcpy(t.f.data(), src, n * 4);
    t.dt = DT::F32;
  } else if (c.stored == "i64") {
    t.i.resize(n);
    std::memcpy(t.i.data(), src, n * 8);
  } else if (c.stored == "i32" || c.stored == "u32") {
    t.i.resize(n);
    const int32_t* s = reinterpret_cast<const int32_t*>(src);
    for (int64_t k = 0; k < n; ++k) t.i[k] = s[k];
  } else if (c.stored == "i8") {
    t.i.resize(n);
    const int8_t* s = reinterpret_cast<const int8_t*>(src);
    for (int64_t k = 0; k < n; ++k) t.i[k] = s[k];
  } else {
    throw std::runtime_error("bad stored dtype " + c.stored);
  }
  return t;
}

inline void init_const_cache(SubProgram* sp, const std::vector<char>& blob) {
  for (const auto& c : sp->constants)
    sp->const_vals.emplace(c.decl.id, decode_const(c, blob));
  for (auto& op : sp->ops)
    if (op.body) init_const_cache(op.body.get(), blob);
}

inline Program load_program(const std::string& json_path,
                            const std::string& blob_path) {
  Program p;
  const std::string text = read_file(json_path);
  JV root = JsonParser(text).parse();
  parse_subprogram(root, &p.main);
  const std::string blob = read_file(blob_path);
  p.blob.assign(blob.begin(), blob.end());
  init_const_cache(&p.main, p.blob);
  return p;
}

// -------------------------------------------------------------- interpreter
class Executor {
 public:
  explicit Executor(const Program& p) : prog_(p) {}

  std::vector<Tensor> run(std::vector<Tensor> inputs) const {
    return run_sub(prog_.main, std::move(inputs));
  }

  // ---- opt-in per-op profiling (JXI_PROFILE=1): accumulated wall time per
  // primitive (+ output shape for the hot ops) across every run() on this
  // executor. Costs nothing when the env var is absent.
  struct ProfEntry {
    double us = 0;
    int64_t count = 0;
  };
  mutable std::map<std::string, ProfEntry> profile;

  static bool prof_enabled() {
    static const bool e = std::getenv("JXI_PROFILE") != nullptr;
    return e;
  }

  void dump_profile(std::FILE* out) const {
    std::vector<std::pair<std::string, ProfEntry>> rows(profile.begin(),
                                                        profile.end());
    std::sort(rows.begin(), rows.end(), [](const auto& a, const auto& b) {
      return a.second.us > b.second.us;
    });
    double total = 0;
    for (const auto& r : rows) total += r.second.us;
    std::fprintf(out, "-- jxi profile (total %.1f us) --\n", total);
    for (const auto& r : rows)
      std::fprintf(out, "%8.1f us %5.1f%% x%-6lld %s\n", r.second.us,
                   100.0 * r.second.us / total,
                   (long long)r.second.count, r.first.c_str());
  }

 private:
  const Program& prog_;

  const Tensor& reg_get(const SubProgram& sp, const std::vector<Tensor>& regs,
                        int id) const {
    const auto it = sp.const_vals.find(id);
    return it != sp.const_vals.end() ? it->second : regs[id];
  }

  std::vector<Tensor> run_sub(const SubProgram& sp,
                              std::vector<Tensor> inputs) const {
    std::vector<Tensor> regs(sp.max_id + 1);
    if (inputs.size() != sp.inputs.size())
      throw std::runtime_error("input arity mismatch");
    for (size_t k = 0; k < inputs.size(); ++k) {
      Tensor& t = inputs[k];
      const TensorDecl& d = sp.inputs[k];
      if (t.numel() != [&] { int64_t n = 1; for (auto x : d.shape) n *= x; return n; }())
        throw std::runtime_error("input shape mismatch");
      t.shape = d.shape;
      regs[d.id] = std::move(t);
    }
    if (!prof_enabled()) {
      for (const auto& op : sp.ops) exec_op(op, sp, regs);
    } else {
      for (const auto& op : sp.ops) {
        const auto t0 = std::chrono::steady_clock::now();
        exec_op(op, sp, regs);
        const double us = std::chrono::duration<double, std::micro>(
                              std::chrono::steady_clock::now() - t0)
                              .count();
        std::string key = op.prim;
        if (!op.outputs.empty()) {
          key += " out=";
          for (size_t d = 0; d < op.outputs[0].shape.size(); ++d)
            key += (d ? "x" : "") + std::to_string(op.outputs[0].shape[d]);
        }
        ProfEntry& e = profile[key];
        e.us += us;
        e.count += 1;
      }
    }
    std::vector<Tensor> outs;
    outs.reserve(sp.outputs.size());
    for (size_t k = 0; k < sp.outputs.size(); ++k) {
      const int oid = sp.outputs[k];
      // move the register into the result on its LAST use (consts and
      // earlier duplicate occurrences copy)
      bool last = true;
      for (size_t j = k + 1; j < sp.outputs.size(); ++j)
        if (sp.outputs[j] == oid) { last = false; break; }
      if (last && sp.const_vals.find(oid) == sp.const_vals.end())
        outs.push_back(std::move(regs[oid]));
      else
        outs.push_back(reg_get(sp, regs, oid));
    }
    // recycle every remaining register buffer into the thread's pool —
    // the next execution of this (fixed-shape) program reuses them
    BufferPool& pool = BufferPool::local();
    for (Tensor& t : regs) pool.donate(std::move(t));
    return outs;
  }

  static Tensor make_out(const TensorDecl& d) {
    Tensor t;
    t.dt = d.dt;
    t.shape = d.shape;
    alloc_pooled(t);
    return t;
  }

  // Take ownership of input k's buffer when its register dies at this op
  // (layout ops become O(1) moves instead of multi-MB copies); otherwise
  // deep-copy. Constants never move — they live in const_vals, not regs.
  static Tensor take_or_copy(const Op& op, size_t k, const SubProgram& sp,
                             std::vector<Tensor>& regs) {
    const int id = op.inputs[k];
    if (k < op.input_dies.size() && op.input_dies[k] &&
        sp.const_vals.find(id) == sp.const_vals.end())
      return std::move(regs[id]);
    const auto it = sp.const_vals.find(id);
    return it != sp.const_vals.end() ? it->second : regs[id];
  }

  // ---- op dispatch
  void exec_op(const Op& op, const SubProgram& sp,
               std::vector<Tensor>& regs) const {
    const std::string& p = op.prim;
    auto in = [&](size_t k) -> const Tensor& {
      return reg_get(sp, regs, op.inputs[k]);
    };
    auto set = [&](size_t k, Tensor&& t) { regs[op.outputs[k].id] = std::move(t); };

    // -- elementwise binaries (same-shape operands, per jaxpr contract)
    static const std::map<std::string, int> kBin = {
        {"add", 0}, {"sub", 1}, {"mul", 2}, {"div", 3}, {"max", 4},
        {"min", 5}, {"pow", 6}, {"rem", 7}, {"atan2", 8},
    };
    static const std::map<std::string, int> kCmp = {
        {"lt", 0}, {"gt", 1}, {"le", 2}, {"ge", 3}, {"eq", 4}, {"ne", 5},
    };
    static const std::map<std::string, int> kLogic = {
        {"and", 0}, {"or", 1}, {"xor", 2},
    };
    static const std::map<std::string, int> kUn = {
        {"exp", 0}, {"log", 1}, {"tanh", 2}, {"logistic", 3}, {"sqrt", 4},
        {"rsqrt", 5}, {"square", 6}, {"abs", 7}, {"neg", 8}, {"sign", 9},
        {"floor", 10}, {"ceil", 11}, {"round", 12}, {"erf", 13},
        {"is_finite", 14}, {"not", 15}, {"log1p", 16}, {"expm1", 17},
        {"cbrt", 18}, {"sin", 19}, {"cos", 20},
    };

    auto bit = kBin.find(p);
    if (bit != kBin.end()) { set(0, binop(bit->second, op, sp, regs)); return; }
    auto cit = kCmp.find(p);
    if (cit != kCmp.end()) { set(0, cmpop(cit->second, in(0), in(1), op.outputs[0])); return; }
    auto lit = kLogic.find(p);
    if (lit != kLogic.end()) { set(0, logicop(lit->second, in(0), in(1), op.outputs[0])); return; }
    auto uit = kUn.find(p);
    if (uit != kUn.end()) { set(0, unop(uit->second, op, sp, regs)); return; }

    if (p == "integer_pow") {
      const int64_t y = op.attrs.at("y").asi();
      Tensor out = make_out(op.outputs[0]);
      const Tensor& a = in(0);
      for (int64_t k = 0; k < out.numel(); ++k) {
        if (out.isf()) out.f[k] = float(std::pow(double(a.f[k]), double(y)));
        else out.i[k] = int64_t(std::llround(std::pow(double(a.i[k]), double(y))));
      }
      set(0, std::move(out));
    } else if (p == "clamp") {
      Tensor out = make_out(op.outputs[0]);
      const MatRef ml(in(0), out.shape), mx(in(1), out.shape),
                   mh(in(2), out.shape);
      const Tensor &lo = *ml, &x = *mx, &hi = *mh;
      const int64_t sl = lo.numel() == 1 ? 0 : 1,
                    sx = x.numel() == 1 ? 0 : 1,
                    sh = hi.numel() == 1 ? 0 : 1;
      for (int64_t k = 0; k < out.numel(); ++k) {
        if (out.isf())
          out.f[k] = std::min(std::max(x.f[k * sx], lo.f[k * sl]),
                              hi.f[k * sh]);
        else
          out.i[k] = std::min(std::max(x.i[k * sx], lo.i[k * sl]),
                              hi.i[k * sh]);
      }
      set(0, std::move(out));
    } else if (p == "select_n") {
      // two-case float select (the only form our programs emit in hot
      // paths): fused broadcast plan + vectorizable blended inner loop
      if (op.inputs.size() == 3 && dt_is_float(op.outputs[0].dt) &&
          !in(0).isf() && in(0).numel() > 1 && in(1).isf() &&
          in(2).isf()) {
        set(0, select2(op, sp, regs));
        return;
      }
      Tensor out = make_out(op.outputs[0]);
      const int ncase = int(op.inputs.size()) - 1;
      const MatRef mp(in(0), out.shape);
      const Tensor& pred = *mp;
      const int64_t sp_ = pred.numel() == 1 ? 0 : 1;
      std::vector<MatRef> cases;
      cases.reserve(ncase);
      for (int c = 0; c < ncase; ++c) cases.emplace_back(in(1 + size_t(c)), out.shape);
      for (int64_t k = 0; k < out.numel(); ++k) {
        const int64_t pk = k * sp_;
        int64_t c = pred.i.empty() ? int64_t(pred.f[pk]) : pred.i[pk];
        if (c < 0) c = 0;
        if (c >= ncase) c = ncase - 1;
        const Tensor& src = *cases[size_t(c)];
        const int64_t sk = src.numel() == 1 ? 0 : k;
        if (out.isf()) out.f[k] = src.f[sk]; else out.i[k] = src.i[sk];
      }
      set(0, std::move(out));
    } else if (p == "convert_element_type") {
      set(0, convert(in(0), op.outputs[0]));
    } else if (p == "reduce_precision") {
      // bf16 rounding pass-through (exponent 8 / mantissa 7)
      Tensor out = take_or_copy(op, 0, sp, regs);
      for (auto& v : out.f) v = bf16_round(v);
      out.shape = op.outputs[0].shape;
      set(0, std::move(out));
    } else if (p == "iota") {
      Tensor out = make_out(op.outputs[0]);
      const int64_t dim = op.attrs.at("dimension").asi();
      const auto st = strides_of(out.shape);
      for (int64_t k = 0; k < out.numel(); ++k) {
        const int64_t v = (k / st[dim]) % out.shape[dim];
        if (out.isf()) out.f[k] = float(v); else out.i[k] = v;
      }
      set(0, std::move(out));
    } else if (p == "reshape" || p == "squeeze" || p == "expand_dims") {
      Tensor out = take_or_copy(op, 0, sp, regs);
      out.shape = op.outputs[0].shape;
      out.dt = op.outputs[0].dt;
      set(0, std::move(out));
    } else if (p == "broadcast_in_dim") {
      set(0, broadcast_in_dim(in(0), op.outputs[0],
                              op.attrs.at("broadcast_dimensions").ints()));
    } else if (p == "transpose") {
      set(0, transpose(in(0), op.outputs[0], op.attrs.at("permutation").ints()));
    } else if (p == "tile") {
      set(0, tile(in(0), op.outputs[0]));
    } else if (p == "concatenate") {
      set(0, concatenate(op, sp, regs));
    } else if (p == "slice") {
      set(0, slice_op(in(0), op));
    } else if (p == "rev") {
      set(0, rev(in(0), op.outputs[0], op.attrs.at("dimensions").ints()));
    } else if (p == "pad") {
      set(0, pad(in(0), in(1), op));
    } else if (p == "dynamic_slice") {
      set(0, dynamic_slice(op, sp, regs));
    } else if (p == "dynamic_update_slice") {
      set(0, dynamic_update_slice(op, sp, regs));
    } else if (p == "reduce_sum" || p == "reduce_max" || p == "reduce_min" ||
               p == "reduce_prod" || p == "reduce_or" || p == "reduce_and") {
      set(0, reduce(p, in(0), op));
    } else if (p == "argmax" || p == "argmin") {
      set(0, argreduce(p == "argmax", in(0), op));
    } else if (p == "cumsum" || p == "cumprod" || p == "cummax" ||
               p == "cummin") {
      set(0, cumop(p, in(0), op));
    } else if (p == "gather") {
      set(0, gather(in(0), in(1), op));
    } else if (p == "dot_general") {
      set(0, dot_general(in(0), in(1), op));
    } else if (p == "conv_general_dilated") {
      set(0, conv(in(0), in(1), op));
    } else if (p == "split") {
      split(op, sp, regs);
    } else if (p == "scan") {
      scan(op, sp, regs);
    } else if (p == "stop_gradient" || p == "copy") {
      set(0, take_or_copy(op, 0, sp, regs));
    } else {
      throw std::runtime_error("jaxpr_interp: unsupported primitive '" + p + "'");
    }
  }

  // ---- odometer iteration: visit dst = 0..numel(oshape)-1 while the
  // source index advances by istr[d] when output dim d increments — no
  // per-element div/mod (the generic remap cost that otherwise dominates
  // the elementwise/layout ops).
  template <typename F>
  static void for_each_remap(const std::vector<int64_t>& oshape,
                             const std::vector<int64_t>& istr, int64_t base,
                             F&& f) {
    const size_t r = oshape.size();
    int64_t n = 1;
    for (int64_t d : oshape) n *= d;
    if (n == 0) return;
    if (r == 0) { f(int64_t(0), base); return; }
    std::vector<int64_t> coord(r, 0);
    int64_t src = base;
    for (int64_t k = 0;;) {
      f(k, src);
      if (++k >= n) break;
      size_t d = r;
      while (d-- > 0) {
        ++coord[d];
        src += istr[d];
        if (coord[d] < oshape[d]) break;
        src -= oshape[d] * istr[d];
        coord[d] = 0;
      }
    }
  }

  // Gather-copy `a` into a fresh direct-layout tensor of shape `oshape`,
  // reading a at base + sum(coord[d] * istr[d]). Contiguous inner runs
  // (trailing dims whose strides match a packed layout) become memcpys.
  static Tensor gather_layout(const Tensor& a, DT dt,
                              const std::vector<int64_t>& oshape,
                              const std::vector<int64_t>& istr,
                              int64_t base = 0) {
    Tensor out;
    out.dt = dt;
    out.shape = oshape;
    alloc_pooled(out);
    size_t r = oshape.size();
    int64_t run = 1;
    while (r > 0 && istr[r - 1] == run) { run *= oshape[r - 1]; --r; }
    const std::vector<int64_t> osub(oshape.begin(), oshape.begin() + r);
    const std::vector<int64_t> isub(istr.begin(), istr.begin() + r);
    if (out.isf()) {
      const float* src = a.f.data();
      float* dst = out.f.data();
      for_each_remap(osub, isub, base, [&](int64_t k, int64_t s) {
        std::memcpy(dst + k * run, src + s, size_t(run) * sizeof(float));
      });
    } else {
      const int64_t* src = a.i.data();
      int64_t* dst = out.i.data();
      for_each_remap(osub, isub, base, [&](int64_t k, int64_t s) {
        std::memcpy(dst + k * run, src + s, size_t(run) * sizeof(int64_t));
      });
    }
    return out;
  }

  // Scatter-copy contiguous `a` into `out` at base + sum(coord * ostr).
  static void scatter_layout(const Tensor& a, Tensor* out,
                             const std::vector<int64_t>& ostr, int64_t base) {
    size_t r = a.shape.size();
    int64_t run = 1;
    while (r > 0 && ostr[r - 1] == run) { run *= a.shape[r - 1]; --r; }
    const std::vector<int64_t> ssub(a.shape.begin(), a.shape.begin() + r);
    const std::vector<int64_t> osub(ostr.begin(), ostr.begin() + r);
    if (out->isf()) {
      const float* src = a.f.data();
      float* dst = out->f.data();
      for_each_remap(ssub, osub, base, [&](int64_t k, int64_t s) {
        std::memcpy(dst + s, src + k * run, size_t(run) * sizeof(float));
      });
    } else {
      const int64_t* src = a.i.data();
      int64_t* dst = out->i.data();
      for_each_remap(ssub, osub, base, [&](int64_t k, int64_t s) {
        std::memcpy(dst + s, src + k * run, size_t(run) * sizeof(int64_t));
      });
    }
  }

  // Materialize an operand into the direct layout of `oshape` (NumPy
  // right-aligned broadcast of rank-0 / size-1 dims).
  static Tensor materialize(const Tensor& t,
                            const std::vector<int64_t>& oshape) {
    if (t.shape == oshape) {
      Tensor out = t;
      return out;
    }
    std::vector<int64_t> istr(oshape.size(), 0);
    const auto ist = strides_of(t.shape);
    const size_t off = oshape.size() - t.shape.size();
    for (size_t d = 0; d < t.shape.size(); ++d)
      if (t.shape[d] != 1) istr[off + d] = ist[d];
    return gather_layout(t, t.dt, oshape, istr);
  }

  static float bf16_round(float v) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    const uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;  // round to nearest even
    bits &= 0xffff0000u;
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
  }

  // Branch-free float exp (cephes-style range reduction + degree-6
  // polynomial; max rel err 8.3e-8 over the clamped range). The two
  // non-obvious choices are what make it ACTUALLY vectorize (measured
  // 0.46 ns/elem vs 3.3 scalar — 7x): round-to-nearest via the 2^23
  // magic constant (gcc refuses to vectorize std::floor on this target
  // even under -fno-math-errno), and __builtin_bit_cast for the
  // exponent scaling (a memcpy type-pun kills the loop with
  // "no vectype").
  static inline float fexp(float x) {
    x = x < -87.33654f ? -87.33654f : (x > 88.72283f ? 88.72283f : x);
    const float n =
        (x * 1.44269504088896341f + 12582912.0f) - 12582912.0f;
    float r = x - n * 0.693359375f;          // ln2 split high/low keeps
    r -= n * -2.12194440e-4f;                // the reduction exact in f32
    float p = 1.9875691500e-4f;
    p = p * r + 1.3981999507e-3f;
    p = p * r + 8.3334519073e-3f;
    p = p * r + 4.1665795894e-2f;
    p = p * r + 1.6666665459e-1f;
    p = p * r + 5.0000001201e-1f;
    const float y = p * r * r + r + 1.0f;
    int32_t bits = __builtin_bit_cast(int32_t, y);
    bits += int32_t(n) << 23;               // scale by 2^n in the exponent
    return __builtin_bit_cast(float, bits);
  }

  // ---- fused broadcast plan for elementwise binaries: find the largest
  // trailing block of output dims over which each operand is either fully
  // contiguous (inner step 1) or fully constant (inner step 0); the
  // kernels then run one tight vectorizable inner loop per outer position
  // with NO materialized broadcast copy (the copy used to cost as much as
  // the op itself on bias-add/normalize shapes).
  struct Bcast2 {
    std::vector<int64_t> osub, astr, bstr;  // outer dims + per-dim strides
    int64_t run = 1;                        // inner elements per callback
    int sa = 1, sb = 1;                     // inner steps (0 = broadcast)
  };

  static std::vector<int64_t> bcast_strides(
      const Tensor& t, const std::vector<int64_t>& oshape) {
    std::vector<int64_t> istr(oshape.size(), 0);
    const auto ist = strides_of(t.shape);
    const size_t off = oshape.size() - t.shape.size();
    for (size_t d = 0; d < t.shape.size(); ++d)
      if (t.shape[d] != 1) istr[off + d] = ist[d];
    return istr;
  }

  static Bcast2 plan_bcast2(const std::vector<int64_t>& oshape,
                            const std::vector<int64_t>& astr,
                            const std::vector<int64_t>& bstr) {
    Bcast2 pl;
    int64_t run = 1;
    int amode = 2, bmode = 2;  // 2 = undecided, 1 = contig, 0 = const
    size_t r = oshape.size();
    while (r > 0) {
      const size_t d = r - 1;
      auto extend = [&](int64_t s, int& mode) {
        if (oshape[d] == 1) return true;  // size-1 dim is neutral
        if (s == 0) {
          if (mode == 1) return false;
          mode = 0;
          return true;
        }
        if (s == run) {
          if (mode == 0) return false;
          mode = 1;
          return true;
        }
        return false;
      };
      int am = amode, bm = bmode;
      if (!extend(astr[d], am) || !extend(bstr[d], bm)) break;
      amode = am;
      bmode = bm;
      run *= oshape[d];
      --r;
    }
    pl.run = run;
    pl.sa = amode == 0 ? 0 : 1;
    pl.sb = bmode == 0 ? 0 : 1;
    pl.osub.assign(oshape.begin(), oshape.begin() + r);
    pl.astr.assign(astr.begin(), astr.begin() + r);
    pl.bstr.assign(bstr.begin(), bstr.begin() + r);
    return pl;
  }

  // Two-source odometer: visit output blocks 0..N-1 with both source
  // offsets advanced by per-dim strides (same scheme as for_each_remap).
  template <typename F>
  static void for_each_remap2(const std::vector<int64_t>& oshape,
                              const std::vector<int64_t>& astr,
                              const std::vector<int64_t>& bstr, F&& f) {
    const size_t r = oshape.size();
    int64_t n = 1;
    for (int64_t d : oshape) n *= d;
    if (n == 0) return;
    if (r == 0) {
      f(int64_t(0), int64_t(0), int64_t(0));
      return;
    }
    std::vector<int64_t> coord(r, 0);
    int64_t sa = 0, sb = 0;
    for (int64_t k = 0;;) {
      f(k, sa, sb);
      if (++k >= n) break;
      size_t d = r;
      while (d-- > 0) {
        ++coord[d];
        sa += astr[d];
        sb += bstr[d];
        if (coord[d] < oshape[d]) break;
        sa -= oshape[d] * astr[d];
        sb -= oshape[d] * bstr[d];
        coord[d] = 0;
      }
    }
  }

  // Holds either a pointer to the original operand (already direct or
  // scalar) or an owned materialized copy — avoids the accidental deep
  // copy a mixed-category ternary would make.
  struct MatRef {
    Tensor tmp;
    const Tensor* p;
    MatRef(const Tensor& t, const std::vector<int64_t>& oshape) {
      if (t.numel() == 1 || t.shape == oshape) {
        p = &t;
      } else {
        tmp = materialize(t, oshape);
        p = &tmp;
      }
    }
    MatRef(MatRef&& o) noexcept
        : tmp(std::move(o.tmp)), p(o.p == &o.tmp ? &tmp : o.p) {}
    MatRef(const MatRef&) = delete;
    MatRef& operator=(const MatRef&) = delete;
    const Tensor& operator*() const { return *p; }
  };

  // Can op input k's register buffer be reused as this op's output?
  // (dies here, lives in regs not const_vals, full output shape, same
  // storage class) — turns the elementwise tier in-place: no allocation,
  // no zero-fill pass, and the write lands in an already-hot buffer.
  static bool reusable_as_out(const Op& op, size_t k, const SubProgram& sp,
                              const Tensor& t, const TensorDecl& od) {
    return k < op.input_dies.size() && op.input_dies[k] &&
           sp.const_vals.find(op.inputs[k]) == sp.const_vals.end() &&
           t.shape == od.shape && t.isf() == dt_is_float(od.dt);
  }

  // Two-case float select with the fused broadcast plan: one trailing
  // suffix over which pred/a/b are each contiguous-or-constant, blended
  // in a vectorizable inner loop; a dying full-shape case buffer is
  // reused as the output (the masked-score selects in attention programs
  // used to materialize every operand per element).
  Tensor select2(const Op& op, const SubProgram& sp,
                 std::vector<Tensor>& regs) const {
    const TensorDecl& od = op.outputs[0];
    const int ia = op.inputs[1], ib = op.inputs[2];
    const Tensor& p0 = reg_get(sp, regs, op.inputs[0]);
    const Tensor& a0 = reg_get(sp, regs, ia);
    const Tensor& b0 = reg_get(sp, regs, ib);
    const auto pstr = bcast_strides(p0, od.shape);
    const auto astr = bcast_strides(a0, od.shape);
    const auto bstr = bcast_strides(b0, od.shape);
    int64_t run = 1;
    int pm = 2, am = 2, bm = 2;  // plan_bcast2 modes, three ways
    size_t r = od.shape.size();
    while (r > 0) {
      const size_t d = r - 1;
      auto ext = [&](int64_t s, int& mode) {
        if (od.shape[d] == 1) return true;
        if (s == 0) {
          if (mode == 1) return false;
          mode = 0;
          return true;
        }
        if (s == run) {
          if (mode == 0) return false;
          mode = 1;
          return true;
        }
        return false;
      };
      int p2 = pm, a2 = am, b2 = bm;
      if (!ext(pstr[d], p2) || !ext(astr[d], a2) || !ext(bstr[d], b2))
        break;
      pm = p2;
      am = a2;
      bm = b2;
      run *= od.shape[d];
      --r;
    }
    const int64_t m = run;
    const std::vector<int64_t> osub(od.shape.begin(), od.shape.begin() + r);
    const std::vector<int64_t> psub(pstr.begin(), pstr.begin() + r);
    const std::vector<int64_t> asub(astr.begin(), astr.begin() + r);
    const std::vector<int64_t> bsub(bstr.begin(), bstr.begin() + r);

    int reuse = -1;
    if (reusable_as_out(op, 1, sp, a0, od)) reuse = 1;
    else if (reusable_as_out(op, 2, sp, b0, od)) reuse = 2;
    Tensor out;
    if (reuse >= 0) {
      out = std::move(regs[op.inputs[reuse]]);
      out.dt = od.dt;
      out.shape = od.shape;
    } else {
      out = make_out(od);
    }
    if (out.numel() == 0) return out;
    const Tensor& a = (reuse == 1 || (reuse >= 0 && ia == ib))
                          ? out : reg_get(sp, regs, ia);
    const Tensor& b = (reuse == 2 || (reuse >= 0 && ia == ib))
                          ? out : reg_get(sp, regs, ib);
    const int64_t* vp = p0.i.data();
    const float* va = a.f.data();
    const float* vb = b.f.data();
    float* vo = out.f.data();

    auto kern = [&](auto cp_c, auto ca_c, auto cb_c) {
      constexpr int64_t cp = decltype(cp_c)::value;
      constexpr int64_t ca = decltype(ca_c)::value;
      constexpr int64_t cb = decltype(cb_c)::value;
      // 3-source odometer over the outer dims
      int64_t n = 1;
      for (int64_t d : osub) n *= d;
      std::vector<int64_t> coord(osub.size(), 0);
      int64_t pi = 0, ai = 0, bi = 0;
      for (int64_t k = 0;;) {
        const int64_t* wp = vp + pi;
        const float* wa = va + ai;
        const float* wb = vb + bi;
        float* wo = vo + k * m;
        for (int64_t j = 0; j < m; ++j)
          wo[j] = wp[j * cp] ? wb[j * cb] : wa[j * ca];
        if (++k >= n) break;
        size_t d = osub.size();
        while (d-- > 0) {
          ++coord[d];
          pi += psub[d];
          ai += asub[d];
          bi += bsub[d];
          if (coord[d] < osub[d]) break;
          pi -= osub[d] * psub[d];
          ai -= osub[d] * asub[d];
          bi -= osub[d] * bsub[d];
          coord[d] = 0;
        }
      }
    };
    using c0 = std::integral_constant<int64_t, 0>;
    using c1 = std::integral_constant<int64_t, 1>;
    const bool sp1 = pm != 0, sa1 = am != 0, sb1 = bm != 0;
    if (sp1) {
      if (sa1 && sb1) kern(c1{}, c1{}, c1{});
      else if (sa1) kern(c1{}, c1{}, c0{});
      else if (sb1) kern(c1{}, c0{}, c1{});
      else kern(c1{}, c0{}, c0{});
    } else {
      if (sa1 && sb1) kern(c0{}, c1{}, c1{});
      else if (sa1) kern(c0{}, c1{}, c0{});
      else if (sb1) kern(c0{}, c0{}, c1{});
      else kern(c0{}, c0{}, c0{});
    }
    return out;
  }

  Tensor binop(int kind, const Op& op, const SubProgram& sp,
               std::vector<Tensor>& regs) const {
    const TensorDecl& od = op.outputs[0];
    const int ia = op.inputs[0], ib = op.inputs[1];
    // plan from shapes before any buffer moves
    const Tensor& a0 = reg_get(sp, regs, ia);
    const Tensor& b0 = reg_get(sp, regs, ib);
    const auto astr = bcast_strides(a0, od.shape);
    const auto bstr = bcast_strides(b0, od.shape);
    const Bcast2 pl = plan_bcast2(od.shape, astr, bstr);

    int reuse = -1;
    if (reusable_as_out(op, 0, sp, a0, od)) reuse = 0;
    else if (reusable_as_out(op, 1, sp, b0, od)) reuse = 1;
    Tensor out;
    if (reuse >= 0) {
      out = std::move(regs[op.inputs[reuse]]);
      out.dt = od.dt;
      out.shape = od.shape;
    } else {
      out = make_out(od);
    }
    if (out.numel() == 0) return out;
    // a full-shape reused operand aliases the output elementwise (same
    // packed layout), which is safe for these pure per-element kernels;
    // when ia == ib both operands alias it too
    const Tensor& a = (reuse == 0 || (reuse >= 0 && ia == ib))
                          ? out : reg_get(sp, regs, ia);
    const Tensor& b = (reuse == 1 || (reuse >= 0 && ia == ib))
                          ? out : reg_get(sp, regs, ib);
    // fused broadcast execution: outer odometer over the leading dims,
    // tight vectorizable inner loop of `m` elements; operands are read in
    // place with inner step 1 (contiguous) or 0 (broadcast) — no
    // materialized copies
    const int64_t m = pl.run;

    auto launch = [&](auto&& kern) {
      // compile-time (sa, sb) dispatch keeps the inner loops vectorizable
      auto go = [&](auto sa_c, auto sb_c) {
        for_each_remap2(pl.osub, pl.astr, pl.bstr,
                        [&](int64_t k, int64_t ai, int64_t bi) {
                          kern(k * m, ai, bi, sa_c, sb_c);
                        });
      };
      using c0 = std::integral_constant<int64_t, 0>;
      using c1 = std::integral_constant<int64_t, 1>;
      if (pl.sa == 1 && pl.sb == 1) go(c1{}, c1{});
      else if (pl.sa == 1) go(c1{}, c0{});
      else if (pl.sb == 1) go(c0{}, c1{});
      else go(c0{}, c0{});
    };

    if (out.isf()) {
      const float *pa = a.f.data(), *pb = b.f.data();
      float* po = out.f.data();
      auto ew = [&](auto opf) {
        launch([&](int64_t o, int64_t ai, int64_t bi, auto sa_c, auto sb_c) {
          constexpr int64_t sa = decltype(sa_c)::value;
          constexpr int64_t sb = decltype(sb_c)::value;
          const float* va = pa + ai;
          const float* vb = pb + bi;
          float* vo = po + o;
          for (int64_t j = 0; j < m; ++j) vo[j] = opf(va[j * sa], vb[j * sb]);
        });
      };
      switch (kind) {
        case 0: ew([](float x, float y) { return x + y; }); break;
        case 1: ew([](float x, float y) { return x - y; }); break;
        case 2: ew([](float x, float y) { return x * y; }); break;
        case 3: ew([](float x, float y) { return x / y; }); break;
        case 4: ew([](float x, float y) { return std::max(x, y); }); break;
        case 5: ew([](float x, float y) { return std::min(x, y); }); break;
        case 6: ew([](float x, float y) { return std::pow(x, y); }); break;
        case 7: ew([](float x, float y) { return std::fmod(x, y); }); break;
        case 8: ew([](float x, float y) { return std::atan2(x, y); }); break;
      }
    } else {
      const int64_t *pa = a.i.data(), *pb = b.i.data();
      int64_t* po = out.i.data();
      launch([&](int64_t o, int64_t ai, int64_t bi, auto sa_c, auto sb_c) {
        constexpr int64_t sa = decltype(sa_c)::value;
        constexpr int64_t sb = decltype(sb_c)::value;
        const int64_t* va = pa + ai;
        const int64_t* vb = pb + bi;
        int64_t* vo = po + o;
        for (int64_t j = 0; j < m; ++j) {
          const int64_t x = va[j * sa], y = vb[j * sb];
          int64_t r = 0;
          switch (kind) {
            case 0: r = x + y; break;
            case 1: r = x - y; break;
            case 2: r = x * y; break;
            case 3: r = y ? x / y : 0; break;
            case 4: r = std::max(x, y); break;
            case 5: r = std::min(x, y); break;
            case 6: r = int64_t(std::pow(double(x), double(y))); break;
            case 7: r = y ? x % y : 0; break;
            default: throw std::runtime_error("int binop");
          }
          vo[j] = r;
        }
      });
    }
    return out;
  }

  Tensor cmpop(int kind, const Tensor& a0, const Tensor& b0,
               const TensorDecl& od) const {
    Tensor out = make_out(od);
    const int64_t n = out.numel();
    const bool a_scalar = a0.numel() == 1, b_scalar = b0.numel() == 1;
    const MatRef ma(a0, out.shape), mb(b0, out.shape);
    const Tensor &a = *ma, &b = *mb;
    const int64_t sa = a_scalar ? 0 : 1, sb = b_scalar ? 0 : 1;
    for (int64_t k = 0; k < n; ++k) {
      const double x = a.get(k * sa), y = b.get(k * sb);
      bool r = false;
      switch (kind) {
        case 0: r = x < y; break;
        case 1: r = x > y; break;
        case 2: r = x <= y; break;
        case 3: r = x >= y; break;
        case 4: r = x == y; break;
        case 5: r = x != y; break;
      }
      out.i[k] = r ? 1 : 0;
    }
    return out;
  }

  Tensor logicop(int kind, const Tensor& a0, const Tensor& b0,
                 const TensorDecl& od) const {
    Tensor out = make_out(od);
    const bool a_scalar = a0.numel() == 1, b_scalar = b0.numel() == 1;
    const MatRef ma(a0, out.shape), mb(b0, out.shape);
    const Tensor &a = *ma, &b = *mb;
    const int64_t sa = a_scalar ? 0 : 1, sb = b_scalar ? 0 : 1;
    for (int64_t k = 0; k < out.numel(); ++k) {
      const int64_t x = a.i[k * sa], y = b.i[k * sb];
      out.i[k] = kind == 0 ? (x & y) : kind == 1 ? (x | y) : (x ^ y);
    }
    return out;
  }

  Tensor unop(int kind, const Op& op, const SubProgram& sp,
              std::vector<Tensor>& regs) const {
    const TensorDecl& od = op.outputs[0];
    const Tensor& a0 = reg_get(sp, regs, op.inputs[0]);
    Tensor out;
    bool in_place = reusable_as_out(op, 0, sp, a0, od);
    if (in_place) {
      out = std::move(regs[op.inputs[0]]);
      out.dt = od.dt;
      out.shape = od.shape;
    } else {
      out = make_out(od);
    }
    const Tensor& a = in_place ? out : reg_get(sp, regs, op.inputs[0]);
    const int64_t n = out.numel();
    if (out.isf() && (kind == 0 || kind == 2 || kind == 3 || kind == 6)) {
      // hot transcendental kinds get dedicated vectorizable loops over
      // fexp (exp / tanh / logistic) — these dominate attention programs
      const float* pa = a.f.data();
      float* po = out.f.data();
      if (kind == 0) {
        for (int64_t k = 0; k < n; ++k) po[k] = fexp(pa[k]);
      } else if (kind == 3) {
        for (int64_t k = 0; k < n; ++k) po[k] = 1.0f / (1.0f + fexp(-pa[k]));
      } else if (kind == 2) {
        for (int64_t k = 0; k < n; ++k) {
          const float e = fexp(2.0f * pa[k]);  // fexp clamps: saturates ±1
          po[k] = (e - 1.0f) / (e + 1.0f);
        }
      } else {
        for (int64_t k = 0; k < n; ++k) po[k] = pa[k] * pa[k];
      }
      return out;
    }
    for (int64_t k = 0; k < n; ++k) {
      if (kind == 14) {  // is_finite -> bool
        out.i[k] = std::isfinite(a.f[k]) ? 1 : 0;
        continue;
      }
      if (kind == 15) {  // not
        out.i[k] = a.i[k] ? 0 : 1;
        continue;
      }
      if (!out.isf()) {  // int abs/neg/sign
        const int64_t x = a.i[k];
        switch (kind) {
          case 7: out.i[k] = std::llabs(x); break;
          case 8: out.i[k] = -x; break;
          case 9: out.i[k] = (x > 0) - (x < 0); break;
          default: throw std::runtime_error("int unop");
        }
        continue;
      }
      const float x = a.f[k];
      float r = 0;
      switch (kind) {
        case 0: r = std::exp(x); break;
        case 1: r = std::log(x); break;
        case 2: r = std::tanh(x); break;
        case 3: r = 1.0f / (1.0f + std::exp(-x)); break;
        case 4: r = std::sqrt(x); break;
        case 5: r = 1.0f / std::sqrt(x); break;
        case 6: r = x * x; break;
        case 7: r = std::fabs(x); break;
        case 8: r = -x; break;
        case 9: r = (x > 0.f) - (x < 0.f); break;
        case 10: r = std::floor(x); break;
        case 11: r = std::ceil(x); break;
        case 12: r = std::nearbyint(x); break;
        case 13: r = std::erf(x); break;
        case 16: r = std::log1p(x); break;
        case 17: r = std::expm1(x); break;
        case 18: r = std::cbrt(x); break;
        case 19: r = std::sin(x); break;
        case 20: r = std::cos(x); break;
      }
      out.f[k] = r;
    }
    return out;
  }

  Tensor convert(const Tensor& a, const TensorDecl& od) const {
    Tensor out = make_out(od);
    const int64_t n = out.numel();
    const bool to_bf16 = od.dtype_name == "bf16";
    for (int64_t k = 0; k < n; ++k) {
      if (out.isf()) {
        float v = a.isf() ? a.f[k] : float(a.i[k]);
        out.f[k] = to_bf16 ? bf16_round(v) : v;
      } else {
        out.i[k] = a.isf() ? int64_t(a.f[k]) : a.i[k];
        if (od.dtype_name == "bool") out.i[k] = out.i[k] ? 1 : 0;
      }
    }
    return out;
  }

  Tensor broadcast_in_dim(const Tensor& a, const TensorDecl& od,
                          const std::vector<int64_t>& bdims) const {
    const auto ist = strides_of(a.shape);
    std::vector<int64_t> istr(od.shape.size(), 0);
    for (size_t d = 0; d < bdims.size(); ++d)
      if (a.shape[d] != 1) istr[bdims[d]] = ist[d];
    return gather_layout(a, od.dt, od.shape, istr);
  }

  Tensor transpose(const Tensor& a, const TensorDecl& od,
                   const std::vector<int64_t>& perm) const {
    const auto ist = strides_of(a.shape);
    std::vector<int64_t> istr(perm.size());
    for (size_t d = 0; d < perm.size(); ++d) istr[d] = ist[perm[d]];
    return gather_layout(a, od.dt, od.shape, istr);
  }

  Tensor tile(const Tensor& a, const TensorDecl& od) const {
    Tensor out = make_out(od);
    const auto ost = strides_of(out.shape);
    const auto ist = strides_of(a.shape);
    const size_t r = out.shape.size();
    const size_t off = r - a.shape.size();
    const int64_t n = out.numel();
    for (int64_t k = 0; k < n; ++k) {
      int64_t src = 0;
      for (size_t d = 0; d < a.shape.size(); ++d) {
        const int64_t coord = (k / ost[off + d]) % out.shape[off + d];
        src += (coord % a.shape[d]) * ist[d];
      }
      if (out.isf()) out.f[k] = a.f[src]; else out.i[k] = a.i[src];
    }
    return out;
  }

  Tensor concatenate(const Op& op, const SubProgram& sp,
                     std::vector<Tensor>& regs) const {
    Tensor out = make_out(op.outputs[0]);
    const int64_t dim = op.attrs.at("dimension").asi();
    const auto ost = strides_of(out.shape);
    int64_t dim_off = 0;
    for (int ii : op.inputs) {
      const Tensor& a = reg_get(sp, regs, ii);
      scatter_layout(a, &out, ost, dim_off * ost[dim]);
      dim_off += a.shape[dim];
    }
    return out;
  }

  Tensor slice_op(const Tensor& a, const Op& op) const {
    const auto& od = op.outputs[0];
    const auto start = op.attrs.at("start_indices").ints();
    std::vector<int64_t> strides(a.shape.size(), 1);
    const JV* sv = op.attrs.find("strides");
    if (sv && sv->t == JV::ARR) strides = sv->ints();
    const auto ist = strides_of(a.shape);
    std::vector<int64_t> istr(a.shape.size());
    int64_t base = 0;
    for (size_t d = 0; d < a.shape.size(); ++d) {
      istr[d] = strides[d] * ist[d];
      base += start[d] * ist[d];
    }
    return gather_layout(a, od.dt, od.shape, istr, base);
  }

  Tensor rev(const Tensor& a, const TensorDecl& od,
             const std::vector<int64_t>& dims) const {
    const auto st = strides_of(a.shape);
    std::vector<int64_t> istr(st);
    std::vector<bool> isrev(a.shape.size(), false);
    for (int64_t d : dims) isrev[d] = true;
    int64_t base = 0;
    for (size_t d = 0; d < a.shape.size(); ++d) {
      if (isrev[d]) {
        base += (a.shape[d] - 1) * st[d];
        istr[d] = -st[d];
      }
    }
    return gather_layout(a, od.dt, od.shape, istr, base);
  }

  Tensor pad(const Tensor& a, const Tensor& pv, const Op& op) const {
    Tensor out = make_out(op.outputs[0]);
    const double fill = pv.get(0);
    for (int64_t k = 0; k < out.numel(); ++k) {
      if (out.isf()) out.f[k] = float(fill); else out.i[k] = int64_t(fill);
    }
    std::vector<int64_t> lo, interior;
    for (const auto& cfg : op.attrs.at("padding_config").arr) {
      lo.push_back(cfg.arr[0].asi());
      interior.push_back(cfg.arr[2].asi());
    }
    const auto ist = strides_of(a.shape);
    const auto ost = strides_of(out.shape);
    const int64_t n = a.numel();
    for (int64_t k = 0; k < n; ++k) {
      int64_t dst = 0;
      bool ok = true;
      for (size_t d = 0; d < a.shape.size(); ++d) {
        const int64_t coord = (k / ist[d]) % a.shape[d];
        const int64_t oc = lo[d] + coord * (interior[d] + 1);
        if (oc < 0 || oc >= out.shape[d]) { ok = false; break; }
        dst += oc * ost[d];
      }
      if (!ok) continue;  // negative low padding drops rows
      if (out.isf()) out.f[dst] = a.f[k]; else out.i[dst] = a.i[k];
    }
    return out;
  }

  Tensor dynamic_slice(const Op& op, const SubProgram& sp,
                       std::vector<Tensor>& regs) const {
    const Tensor& a = reg_get(sp, regs, op.inputs[0]);
    Tensor out = make_out(op.outputs[0]);
    const auto sizes = op.attrs.at("slice_sizes").ints();
    std::vector<int64_t> start(a.shape.size());
    for (size_t d = 0; d < start.size(); ++d) {
      const Tensor& s = reg_get(sp, regs, op.inputs[1 + d]);
      int64_t v = s.isf() ? int64_t(s.f[0]) : s.i[0];
      v = std::max<int64_t>(0, std::min(v, a.shape[d] - sizes[d]));
      start[d] = v;
    }
    const auto ist = strides_of(a.shape);
    const auto ost = strides_of(out.shape);
    for (int64_t k = 0; k < out.numel(); ++k) {
      int64_t src = 0;
      for (size_t d = 0; d < out.shape.size(); ++d) {
        const int64_t coord = (k / ost[d]) % out.shape[d];
        src += (start[d] + coord) * ist[d];
      }
      if (out.isf()) out.f[k] = a.f[src]; else out.i[k] = a.i[src];
    }
    return out;
  }

  Tensor dynamic_update_slice(const Op& op, const SubProgram& sp,
                              std::vector<Tensor>& regs) const {
    Tensor out = reg_get(sp, regs, op.inputs[0]);
    const Tensor& upd = reg_get(sp, regs, op.inputs[1]);
    std::vector<int64_t> start(out.shape.size());
    for (size_t d = 0; d < start.size(); ++d) {
      const Tensor& s = reg_get(sp, regs, op.inputs[2 + d]);
      int64_t v = s.isf() ? int64_t(s.f[0]) : s.i[0];
      v = std::max<int64_t>(0, std::min(v, out.shape[d] - upd.shape[d]));
      start[d] = v;
    }
    const auto ost = strides_of(out.shape);
    const auto ust = strides_of(upd.shape);
    for (int64_t k = 0; k < upd.numel(); ++k) {
      int64_t dst = 0;
      for (size_t d = 0; d < upd.shape.size(); ++d) {
        const int64_t coord = (k / ust[d]) % upd.shape[d];
        dst += (start[d] + coord) * ost[d];
      }
      if (out.isf()) out.f[dst] = upd.f[k]; else out.i[dst] = upd.i[k];
    }
    return out;
  }

  Tensor reduce(const std::string& p, const Tensor& a, const Op& op) const {
    Tensor out = make_out(op.outputs[0]);
    const auto axes = op.attrs.at("axes").ints();
    std::vector<bool> isred(a.shape.size(), false);
    for (int64_t d : axes) isred[d] = true;
    const bool is_max = p == "reduce_max", is_min = p == "reduce_min";
    const bool is_prod = p == "reduce_prod";
    const bool is_or = p == "reduce_or", is_and = p == "reduce_and";

    // trailing-suffix reduction (the common case: softmax sums, LN stats,
    // dot pools): one contiguous inner loop per output row — the generic
    // odometer below costs ~6x on these shapes
    {
      bool trailing = true;
      for (size_t d = a.shape.size() - axes.size(); d < a.shape.size(); ++d)
        trailing = trailing && isred[d];
      trailing = trailing && axes.size() == size_t([&] {
        size_t c = 0;
        for (bool b : isred) c += b;
        return c;
      }());
      if (trailing && !axes.empty() && a.isf() && out.isf()) {
        int64_t inner = 1;
        for (size_t d = a.shape.size() - axes.size(); d < a.shape.size(); ++d)
          inner *= a.shape[d];
        const int64_t outer = out.numel();
        const float* pa = a.f.data();
        float* po = out.f.data();
        if (is_max) {
          for (int64_t o = 0; o < outer; ++o) {
            const float* row = pa + o * inner;
            float acc = -INFINITY;
            for (int64_t j = 0; j < inner; ++j) acc = std::max(acc, row[j]);
            po[o] = acc;
          }
        } else if (is_min) {
          for (int64_t o = 0; o < outer; ++o) {
            const float* row = pa + o * inner;
            float acc = INFINITY;
            for (int64_t j = 0; j < inner; ++j) acc = std::min(acc, row[j]);
            po[o] = acc;
          }
        } else if (is_prod) {
          for (int64_t o = 0; o < outer; ++o) {
            const float* row = pa + o * inner;
            float acc = 1.0f;
            for (int64_t j = 0; j < inner; ++j) acc *= row[j];
            po[o] = acc;
          }
        } else {
          for (int64_t o = 0; o < outer; ++o) {
            const float* row = pa + o * inner;
            float acc[8] = {0.f};
            int64_t j = 0;
            for (; j + 8 <= inner; j += 8)
              for (int u = 0; u < 8; ++u) acc[u] += row[j + u];
            float tail = 0.f;
            for (; j < inner; ++j) tail += row[j];
            po[o] = ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
                    ((acc[2] + acc[6]) + (acc[3] + acc[7])) + tail;
          }
        }
        return out;
      }
    }
    // init
    for (int64_t k = 0; k < out.numel(); ++k) {
      if (out.isf()) {
        out.f[k] = is_max ? -INFINITY : is_min ? INFINITY : is_prod ? 1.f : 0.f;
      } else {
        out.i[k] = is_max ? INT64_MIN : is_min ? INT64_MAX
                   : is_prod ? 1 : is_and ? 1 : 0;
      }
    }
    const auto ost = strides_of(out.shape);
    std::vector<int64_t> dstr(a.shape.size(), 0);
    {
      size_t oo = 0;
      for (size_t d = 0; d < a.shape.size(); ++d)
        if (!isred[d]) dstr[d] = ost[oo++];
    }
    if (out.isf()) {
      const float* pa = a.f.data();
      float* po = out.f.data();
      for_each_remap(a.shape, dstr, 0, [&](int64_t k, int64_t dst) {
        const float v = pa[k];
        float& o = po[dst];
        if (is_max) o = std::max(o, v);
        else if (is_min) o = std::min(o, v);
        else if (is_prod) o *= v;
        else o += v;
      });
    } else {
      const int64_t* pa = a.i.data();
      int64_t* po = out.i.data();
      for_each_remap(a.shape, dstr, 0, [&](int64_t k, int64_t dst) {
        const int64_t v = pa[k];
        int64_t& o = po[dst];
        if (is_max) o = std::max(o, v);
        else if (is_min) o = std::min(o, v);
        else if (is_prod) o *= v;
        else if (is_or) o = o | (v ? 1 : 0);
        else if (is_and) o = o & (v ? 1 : 0);
        else o += v;
      });
    }
    return out;
  }

  Tensor cumop(const std::string& p, const Tensor& a, const Op& op) const {
    Tensor out = a;
    out.shape = op.outputs[0].shape;
    const int64_t ax = op.attrs.at("axis").asi();
    const bool reverse =
        op.attrs.find("reverse") && op.attrs.at("reverse").boo;
    const auto st = strides_of(a.shape);
    const int64_t n = a.numel(), len = a.shape[ax], stride = st[ax];
    for (int64_t base = 0; base < n; ++base) {
      // only process positions at the start of their scan lane
      if ((base / stride) % len != (reverse ? len - 1 : 0)) continue;
      const int64_t step = reverse ? -stride : stride;
      for (int64_t j = 1; j < len; ++j) {
        const int64_t cur = base + j * step, prev = cur - step;
        if (out.isf()) {
          if (p == "cumsum") out.f[cur] += out.f[prev];
          else if (p == "cumprod") out.f[cur] *= out.f[prev];
          else if (p == "cummax") out.f[cur] = std::max(out.f[cur], out.f[prev]);
          else out.f[cur] = std::min(out.f[cur], out.f[prev]);
        } else {
          if (p == "cumsum") out.i[cur] += out.i[prev];
          else if (p == "cumprod") out.i[cur] *= out.i[prev];
          else if (p == "cummax") out.i[cur] = std::max(out.i[cur], out.i[prev]);
          else out.i[cur] = std::min(out.i[cur], out.i[prev]);
        }
      }
    }
    return out;
  }

  Tensor argreduce(bool is_max, const Tensor& a, const Op& op) const {
    Tensor out = make_out(op.outputs[0]);
    const auto axes = op.attrs.at("axes").ints();
    if (axes.size() != 1) throw std::runtime_error("argreduce: 1 axis only");
    const int64_t ax = axes[0];
    const auto ist = strides_of(a.shape);
    const auto ost = strides_of(out.shape);
    std::vector<double> best(out.numel(), is_max ? -INFINITY : INFINITY);
    const int64_t n = a.numel();
    for (int64_t k = 0; k < n; ++k) {
      int64_t dst = 0;
      size_t oo = 0;
      for (size_t d = 0; d < a.shape.size(); ++d) {
        if (int64_t(d) == ax) continue;
        dst += ((k / ist[d]) % a.shape[d]) * ost[oo++];
      }
      const double v = a.get(k);
      const int64_t coord = (k / ist[ax]) % a.shape[ax];
      if ((is_max && v > best[dst]) || (!is_max && v < best[dst])) {
        best[dst] = v;
        out.i[dst] = coord;
      }
    }
    return out;
  }

  // XLA gather with operand/start-indices batching dims.
  Tensor gather(const Tensor& a, const Tensor& sidx, const Op& op) const {
    Tensor out = make_out(op.outputs[0]);
    const auto& dn = op.attrs.at("dimension_numbers").arr;
    const auto offset_dims = dn[0].ints();
    const auto collapsed = dn[1].ints();
    const auto start_map = dn[2].ints();
    const auto op_batch = dn.size() > 3 ? dn[3].ints() : std::vector<int64_t>{};
    const auto si_batch = dn.size() > 4 ? dn[4].ints() : std::vector<int64_t>{};
    const auto slice_sizes = op.attrs.at("slice_sizes").ints();

    const size_t orank = a.shape.size();
    std::vector<bool> is_collapsed(orank, false), is_obatch(orank, false);
    for (int64_t d : collapsed) is_collapsed[d] = true;
    for (int64_t d : op_batch) is_obatch[d] = true;
    // operand dims that produce output offset dims, in order
    std::vector<int64_t> slice_dims;
    for (size_t d = 0; d < orank; ++d)
      if (!is_collapsed[d] && !is_obatch[d]) slice_dims.push_back(int64_t(d));
    if (slice_dims.size() != offset_dims.size())
      throw std::runtime_error("gather: offset dims mismatch");

    // output dims not in offset_dims are batch dims, aligned in order with
    // start_indices dims except its trailing index-vector dim
    const size_t out_rank = out.shape.size();
    std::vector<bool> is_offset(out_rank, false);
    for (int64_t d : offset_dims) is_offset[d] = true;
    std::vector<int64_t> out_batch_dims;
    for (size_t d = 0; d < out_rank; ++d)
      if (!is_offset[d]) out_batch_dims.push_back(int64_t(d));

    // fast path: table[ids] — index the leading axis, take full rows
    // (the dominant gather in every scorer: embedding/feature/seq lookups)
    {
      bool row_gather = collapsed.size() == 1 && collapsed[0] == 0 &&
                        start_map.size() == 1 && start_map[0] == 0 &&
                        op_batch.empty() && slice_sizes[0] == 1;
      for (size_t d = 1; row_gather && d < orank; ++d)
        row_gather = slice_sizes[d] == a.shape[d];
      // slice dims must land on the TRAILING output dims, in order
      const size_t out_rank_fast = out.shape.size();
      for (size_t d = 0; row_gather && d < offset_dims.size(); ++d)
        row_gather = size_t(offset_dims[d]) ==
                     out_rank_fast - offset_dims.size() + d;
      if (row_gather) {
        int64_t rowlen = 1;
        for (size_t d = 1; d < orank; ++d) rowlen *= a.shape[d];
        const int64_t nrows = sidx.numel();  // trailing index-vector dim = 1
        const int64_t hi = a.shape[0] - 1;
        if (out.isf()) {
          const float* src = a.f.data();
          float* dst = out.f.data();
          for (int64_t r = 0; r < nrows; ++r) {
            int64_t idx = sidx.i[r];
            idx = idx < 0 ? 0 : (idx > hi ? hi : idx);
            std::memcpy(dst + r * rowlen, src + idx * rowlen,
                        size_t(rowlen) * sizeof(float));
          }
        } else {
          const int64_t* src = a.i.data();
          int64_t* dst = out.i.data();
          for (int64_t r = 0; r < nrows; ++r) {
            int64_t idx = sidx.i[r];
            idx = idx < 0 ? 0 : (idx > hi ? hi : idx);
            std::memcpy(dst + r * rowlen, src + idx * rowlen,
                        size_t(rowlen) * sizeof(int64_t));
          }
        }
        return out;
      }
    }

    const auto ast = strides_of(a.shape);
    const auto ost = strides_of(out.shape);
    const auto sst = strides_of(sidx.shape);
    const int64_t ivs = int64_t(start_map.size());
    const int64_t n = out.numel();
    std::vector<int64_t> start(orank, 0);
    for (int64_t k = 0; k < n; ++k) {
      // batch coords -> start_indices base offset
      int64_t si_base = 0;
      for (size_t bd = 0; bd < out_batch_dims.size(); ++bd) {
        const int64_t coord = (k / ost[out_batch_dims[bd]]) %
                              out.shape[out_batch_dims[bd]];
        si_base += coord * sst[bd];
      }
      std::fill(start.begin(), start.end(), 0);
      for (int64_t v = 0; v < ivs; ++v) {
        const Tensor& s = sidx;
        const int64_t raw = s.isf()
            ? int64_t(s.f[si_base + v * sst[sidx.shape.size() - 1]])
            : s.i[si_base + v * sst[sidx.shape.size() - 1]];
        const int64_t d = start_map[v];
        start[d] = std::max<int64_t>(
            0, std::min(raw, a.shape[d] - slice_sizes[d]));
      }
      // operand batching dims take the matching start_indices batch coord
      for (size_t bi = 0; bi < op_batch.size(); ++bi) {
        const int64_t si_dim = si_batch[bi];
        // find position of si_dim among start_indices batch dims (all dims
        // except the trailing index-vector dim map 1:1 to out_batch_dims)
        const int64_t coord = (k / ost[out_batch_dims[si_dim]]) %
                              out.shape[out_batch_dims[si_dim]];
        start[op_batch[bi]] = coord;
      }
      int64_t src = 0;
      for (size_t d = 0; d < orank; ++d) src += start[d] * ast[d];
      for (size_t sd = 0; sd < slice_dims.size(); ++sd) {
        const int64_t coord = (k / ost[offset_dims[sd]]) %
                              out.shape[offset_dims[sd]];
        src += coord * ast[slice_dims[sd]];
      }
      if (out.isf()) out.f[k] = a.f[src]; else out.i[k] = a.i[src];
    }
    return out;
  }

  // General contraction: pack to [B, M, K] x [B, K, N] then batched GEMM.
  Tensor dot_general(const Tensor& a, const Tensor& b, const Op& op) const {
    const auto& dn = op.attrs.at("dimension_numbers").arr;
    const auto lc = dn[0].arr[0].ints(), rc = dn[0].arr[1].ints();
    const auto lb = dn[1].arr[0].ints(), rb = dn[1].arr[1].ints();

    auto free_dims = [](const Tensor& t, const std::vector<int64_t>& c,
                        const std::vector<int64_t>& bt) {
      std::vector<bool> used(t.shape.size(), false);
      for (int64_t d : c) used[d] = true;
      for (int64_t d : bt) used[d] = true;
      std::vector<int64_t> out;
      for (size_t d = 0; d < t.shape.size(); ++d)
        if (!used[d]) out.push_back(int64_t(d));
      return out;
    };
    const auto lf = free_dims(a, lc, lb), rf = free_dims(b, rc, rb);

    int64_t B = 1, M = 1, N = 1, K = 1;
    for (int64_t d : lb) B *= a.shape[d];
    for (int64_t d : lf) M *= a.shape[d];
    for (int64_t d : rf) N *= b.shape[d];
    for (int64_t d : lc) K *= a.shape[d];

    // pack lhs as [B, M, K]
    auto pack = [](const Tensor& t, const std::vector<int64_t>& batch,
                   const std::vector<int64_t>& rows,
                   const std::vector<int64_t>& cols) {
      std::vector<int64_t> perm;
      perm.insert(perm.end(), batch.begin(), batch.end());
      perm.insert(perm.end(), rows.begin(), rows.end());
      perm.insert(perm.end(), cols.begin(), cols.end());
      const auto st = strides_of(t.shape);
      std::vector<int64_t> pshape, pstr;
      for (int64_t d : perm) {
        pshape.push_back(t.shape[d]);
        pstr.push_back(st[d]);
      }
      std::vector<float> out(t.numel());
      if (t.isf()) {
        const float* src = t.f.data();
        for_each_remap(pshape, pstr, 0,
                       [&](int64_t k, int64_t sidx) { out[k] = src[sidx]; });
      } else {
        const int64_t* src = t.i.data();
        for_each_remap(pshape, pstr, 0, [&](int64_t k, int64_t sidx) {
          out[k] = float(src[sidx]);
        });
      }
      return out;
    };
    // pack elision: when the (batch, rows, cols) permutation is already
    // the identity the operand is used in place — this removes two full
    // operand copies per matmul (weights used to be repacked per request)
    auto is_identity = [](const std::vector<int64_t>& d0,
                          const std::vector<int64_t>& d1,
                          const std::vector<int64_t>& d2, size_t rank) {
      int64_t next = 0;
      for (int64_t v : d0)
        if (v != next++) return false;
      for (int64_t v : d1)
        if (v != next++) return false;
      for (int64_t v : d2)
        if (v != next++) return false;
      return size_t(next) == rank;
    };
    std::vector<float> Lbuf, Rbuf;
    const float* L;
    if (a.isf() && is_identity(lb, lf, lc, a.shape.size())) {
      L = a.f.data();
    } else {
      Lbuf = pack(a, lb, lf, lc);  // [B, M, K]
      L = Lbuf.data();
    }
    const float* R;
    if (b.isf() && is_identity(rb, rc, rf, b.shape.size())) {
      R = b.f.data();
    } else {
      Rbuf = pack(b, rb, rc, rf);  // [B, K, N]
      R = Rbuf.data();
    }

    Tensor out = make_out(op.outputs[0]);  // [batch..., lf..., rf...]
    if (!out.isf()) {
      // integer dot (rare): accumulate in int64
      for (int64_t bb = 0; bb < B; ++bb)
        for (int64_t m = 0; m < M; ++m)
          for (int64_t nn = 0; nn < N; ++nn) {
            int64_t acc = 0;
            for (int64_t kk = 0; kk < K; ++kk)
              acc += int64_t(L[(bb * M + m) * K + kk]) *
                     int64_t(R[(bb * K + kk) * N + nn]);
            out.i[(bb * M + m) * N + nn] = acc;
          }
      return out;
    }
    float* O = out.f.data();
    if (N == 1) {
      // matvec family (attention-score projections): the ikj loop below
      // degrades to scalar updates at N == 1; a multi-accumulator dot
      // over K vectorizes instead
      const int64_t rows = B * M;
      for (int64_t m = 0; m < rows; ++m) {
        const float* lrow = L + m * K;
        const float* rcol = R + (m / M) * K;
        float acc[8] = {0.f};
        int64_t kk = 0;
        for (; kk + 8 <= K; kk += 8)
          for (int u = 0; u < 8; ++u) acc[u] += lrow[kk + u] * rcol[kk + u];
        float tail = 0.f;
        for (; kk < K; ++kk) tail += lrow[kk] * rcol[kk];
        O[m] = ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
               ((acc[2] + acc[6]) + (acc[3] + acc[7])) + tail;
      }
      return out;
    }
    // N-blocked with a fixed-width local accumulator: the 64-float block
    // lives in vector registers across the whole K loop (the plain ikj
    // form re-loads/stores the output row every K step — measured ~4x
    // slower on the catalog MLP layers). An OpenMP parallel-for here
    // still LOSES (173ms vs 88ms on the DIN catalog program): many small
    // matmuls pay region setup; tile/request-level parallelism is the
    // scaling axis instead.
    // fixed-width sub-blocks (64/32/16 + runtime tail) so the compiler
    // keeps each accumulator block fully in vector registers across the
    // K loop — a runtime-width block spills (attention MLPs with N=36
    // measured 1.4x slower through the old runtime tail)
    auto block = [&](auto nb_c, int64_t n0, const float* Lb, const float* Rb,
                     float* Ob) {
      constexpr int64_t NBk = decltype(nb_c)::value;
      for (int64_t m = 0; m < M; ++m) {
        float acc[NBk] = {0.f};
        const float* lrow = Lb + m * K;
        for (int64_t kk = 0; kk < K; ++kk) {
          const float lv = lrow[kk];
          const float* rrow = Rb + kk * N + n0;
          for (int64_t j = 0; j < NBk; ++j) acc[j] += lv * rrow[j];
        }
        std::copy(acc, acc + NBk, Ob + m * N + n0);
      }
    };
    for (int64_t bb = 0; bb < B; ++bb) {
      const float* Lb = L + bb * M * K;
      const float* Rb = R + bb * K * N;
      float* Ob = O + bb * M * N;
      int64_t n0 = 0;
      for (; n0 + 64 <= N; n0 += 64)
        block(std::integral_constant<int64_t, 64>{}, n0, Lb, Rb, Ob);
      if (n0 + 32 <= N) {
        block(std::integral_constant<int64_t, 32>{}, n0, Lb, Rb, Ob);
        n0 += 32;
      }
      if (n0 + 16 <= N) {
        block(std::integral_constant<int64_t, 16>{}, n0, Lb, Rb, Ob);
        n0 += 16;
      }
      if (n0 < N) {
        const int64_t nb = N - n0;
        for (int64_t m = 0; m < M; ++m) {
          float acc[16] = {0.f};
          const float* lrow = Lb + m * K;
          for (int64_t kk = 0; kk < K; ++kk) {
            const float lv = lrow[kk];
            const float* rrow = Rb + kk * N + n0;
            for (int64_t j = 0; j < nb; ++j) acc[j] += lv * rrow[j];
          }
          std::copy(acc, acc + nb, Ob + m * N + n0);
        }
      }
    }
    return out;
  }

  Tensor conv(const Tensor& lhs, const Tensor& rhs, const Op& op) const {
    const auto& dn = op.attrs.at("dimension_numbers").arr;
    const auto lspec = dn[0].ints();  // [batch, feature, spatial...]
    const auto rspec = dn[1].ints();  // [out_f, in_f, spatial...]
    const auto ospec = dn[2].ints();
    const auto strides = op.attrs.at("window_strides").ints();
    const auto lhs_dil = op.attrs.at("lhs_dilation").ints();
    const auto rhs_dil = op.attrs.at("rhs_dilation").ints();
    const int64_t groups = op.attrs.at("feature_group_count").asi();
    std::vector<int64_t> pad_lo;
    for (const auto& pr : op.attrs.at("padding").arr)
      pad_lo.push_back(pr.arr[0].asi());

    Tensor out = make_out(op.outputs[0]);
    const size_t nsp = lspec.size() - 2;
    const auto lst = strides_of(lhs.shape), rst = strides_of(rhs.shape),
               ost = strides_of(out.shape);
    const int64_t Bn = lhs.shape[lspec[0]];
    const int64_t Cout = rhs.shape[rspec[0]];
    const int64_t cin_g = rhs.shape[rspec[1]];  // in-features per group
    const int64_t cout_g = Cout / groups;

    std::vector<int64_t> osp(nsp), ksp(nsp);
    for (size_t d = 0; d < nsp; ++d) {
      osp[d] = out.shape[ospec[2 + d]];
      ksp[d] = rhs.shape[rspec[2 + d]];
    }
    // odometer increment: returns false when all coords wrapped to zero
    auto advance = [](std::vector<int64_t>& coord,
                      const std::vector<int64_t>& dims) {
      for (size_t d = dims.size(); d-- > 0;) {
        if (++coord[d] < dims[d]) return true;
        coord[d] = 0;
      }
      return false;
    };

    std::vector<int64_t> ocoord(nsp, 0), kcoord(nsp, 0);
    for (int64_t bb = 0; bb < Bn; ++bb) {
      for (int64_t oc = 0; oc < Cout; ++oc) {
        const int64_t g = oc / cout_g;
        std::fill(ocoord.begin(), ocoord.end(), 0);
        do {
          double acc = 0;
          std::fill(kcoord.begin(), kcoord.end(), 0);
          do {
            bool valid = true;
            int64_t lsp_idx = 0;
            for (size_t d = 0; d < nsp; ++d) {
              const int64_t pos = ocoord[d] * strides[d] - pad_lo[d] +
                                  kcoord[d] * rhs_dil[d];
              if (pos < 0 || pos % lhs_dil[d] != 0) { valid = false; break; }
              const int64_t ip = pos / lhs_dil[d];
              if (ip >= lhs.shape[lspec[2 + d]]) { valid = false; break; }
              lsp_idx += ip * lst[lspec[2 + d]];
            }
            if (valid) {
              for (int64_t ic = 0; ic < cin_g; ++ic) {
                const int64_t li = bb * lst[lspec[0]] + lsp_idx +
                                   (g * cin_g + ic) * lst[lspec[1]];
                int64_t ri = oc * rst[rspec[0]] + ic * rst[rspec[1]];
                for (size_t d = 0; d < nsp; ++d)
                  ri += kcoord[d] * rst[rspec[2 + d]];
                acc += double(lhs.f[li]) * double(rhs.f[ri]);
              }
            }
          } while (advance(kcoord, ksp));
          int64_t oidx = bb * ost[ospec[0]] + oc * ost[ospec[1]];
          for (size_t d = 0; d < nsp; ++d)
            oidx += ocoord[d] * ost[ospec[2 + d]];
          out.f[oidx] = float(acc);
        } while (advance(ocoord, osp));
      }
    }
    return out;
  }

  void split(const Op& op, const SubProgram& sp,
             std::vector<Tensor>& regs) const {
    const Tensor& a = reg_get(sp, regs, op.inputs[0]);
    const int64_t axis = op.attrs.at("axis").asi();
    const auto ist = strides_of(a.shape);
    int64_t off = 0;
    for (const auto& od : op.outputs) {
      regs[od.id] = gather_layout(a, od.dt, od.shape, ist, off * ist[axis]);
      off += od.shape[axis];
    }
  }

  void scan(const Op& op, const SubProgram& sp,
            std::vector<Tensor>& regs) const {
    const int64_t length = op.attrs.at("length").asi();
    const int64_t num_consts = op.attrs.at("num_consts").asi();
    const int64_t num_carry = op.attrs.at("num_carry").asi();
    const bool reverse = op.attrs.at("reverse").boo;
    const SubProgram& body = *op.body;

    std::vector<Tensor> consts, carry;
    for (int64_t k = 0; k < num_consts; ++k)
      consts.push_back(reg_get(sp, regs, op.inputs[k]));
    for (int64_t k = 0; k < num_carry; ++k)
      carry.push_back(reg_get(sp, regs, op.inputs[num_consts + k]));
    const int64_t num_xs = int64_t(op.inputs.size()) - num_consts - num_carry;
    const int64_t num_ys = int64_t(op.outputs.size()) - num_carry;

    // preallocate stacked ys
    std::vector<Tensor> ys;
    for (int64_t y = 0; y < num_ys; ++y)
      ys.push_back(make_out(op.outputs[num_carry + y]));

    for (int64_t it = 0; it < length; ++it) {
      const int64_t t = reverse ? length - 1 - it : it;
      std::vector<Tensor> args = consts;
      for (auto& c : carry) args.push_back(c);
      for (int64_t x = 0; x < num_xs; ++x) {
        const Tensor& xs = reg_get(sp, regs, op.inputs[num_consts + num_carry + x]);
        Tensor sl;
        sl.dt = xs.dt;
        sl.shape.assign(xs.shape.begin() + 1, xs.shape.end());
        const int64_t step = sl.numel() ? sl.numel() : 1;
        if (xs.isf())
          sl.f.assign(xs.f.begin() + t * step, xs.f.begin() + (t + 1) * step);
        else
          sl.i.assign(xs.i.begin() + t * step, xs.i.begin() + (t + 1) * step);
        args.push_back(std::move(sl));
      }
      std::vector<Tensor> outs = run_sub(body, std::move(args));
      for (int64_t k = 0; k < num_carry; ++k) carry[k] = std::move(outs[k]);
      for (int64_t y = 0; y < num_ys; ++y) {
        const Tensor& v = outs[num_carry + y];
        const int64_t step = v.numel() ? v.numel() : 1;
        if (ys[y].isf())
          std::copy(v.f.begin(), v.f.end(), ys[y].f.begin() + t * step);
        else
          std::copy(v.i.begin(), v.i.end(), ys[y].i.begin() + t * step);
      }
    }
    for (int64_t k = 0; k < num_carry; ++k) {
      carry[k].shape = op.outputs[k].shape;
      regs[op.outputs[k].id] = std::move(carry[k]);
    }
    for (int64_t y = 0; y < num_ys; ++y)
      regs[op.outputs[num_carry + y].id] = std::move(ys[y]);
  }
};

}  // namespace jxi
