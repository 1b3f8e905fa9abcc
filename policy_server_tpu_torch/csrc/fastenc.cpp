// fastenc — native single-pass AdmissionReview JSON → feature-tensor encoder.
//
// The TPU serving pipeline's host-side bottleneck is encoding (SURVEY.md §7.4
// hard-part #1): walking the request JSON and scattering leaves into the
// policy-derived feature arrays (ops/codec.py). This is the native
// implementation of exactly that codec: a minimal JSON parser fused with the
// extraction trie, writing numeric/bool/presence features straight into the
// caller's numpy buffers and collecting ID/pred strings into an arena for
// the (memoized, cheap) Python-side interning pass.
//
// Semantics mirror ops/codec.py bit for bit:
//   * dtype mismatches are "missing" (mask stays 0): ID wants a JSON string;
//     F32 wants a number (bool excluded); I32 wants a syntactic integer
//     (bool and floats excluded); BOOL wants true/false.
//   * presence marks non-null leaves; null is absent.
//   * a '*' axis over an object iterates {"__key__", "__value__"} wrappers
//     in SORTED key order (codec.star_elements).
//   * axis overflow aborts the encode with the offending array id (the
//     caller raises SchemaOverflow and falls back to a wider bucket or the
//     host oracle).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// The entire encode runs without touching Python objects, so callers may
// release the GIL and encode batches on parallel threads.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ----------------------------------------------------------------- schema --

enum Kind : int32_t { KIND_VALUE = 0, KIND_PRESENT = 1, KIND_PRED = 2 };
enum DType : int32_t { DT_ID = 0, DT_F32 = 1, DT_BOOL = 2, DT_I32 = 3 };

struct Terminal {
  int32_t array_id;   // index into the caller's buffer table
  int32_t kind;       // Kind
  int32_t dtype;      // DType (KIND_VALUE only)
  int32_t mask_id;    // mask buffer index (KIND_VALUE only, else -1)
  int32_t pred_id;    // string-pred id (KIND_PRED only, else -1)
};

struct Node {
  std::unordered_map<std::string, std::unique_ptr<Node>> children;
  std::unique_ptr<Node> star;
  std::vector<Terminal> terminals;
  int32_t axis_cap = 0;     // cap of the star axis rooted here
  int32_t overflow_id = -1; // representative array id for overflow errors
};

struct ArrayInfo {
  int32_t ndim;        // 0..2 element axes
  int32_t caps[2];     // axis capacities
  int32_t elsize;      // bytes per element in the caller buffer
  int64_t row_stride;  // batch-mode row stride in BYTES; 0 = contiguous
                       // (elems*elsize). Non-zero when the array is a
                       // column block of a wider packed batch buffer.
};

struct Schema {
  Node root;
  std::vector<ArrayInfo> arrays;
};

// ------------------------------------------------------ schema JSON parse --
// The schema description itself arrives as JSON (built once at boot by
// ops/fastenc.py); we reuse the same parser.

struct Parser;

// ------------------------------------------------------------ JSON parser --

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit Parser(const char* data, size_t n) : p(data), end(data + n) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }
  bool lit(const char* s, size_t n) {
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }
  // Parse a JSON string (assumes *p == '"'); appends decoded bytes to out.
  bool str(std::string& out) {
    if (p >= end || *p != '"') return false;
    p++;
    while (p < end) {
      unsigned char c = (unsigned char)*p;
      if (c == '"') { p++; return true; }
      if (c == '\\') {
        p++;
        if (p >= end) return false;
        char e = *p++;
        switch (e) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'n': out.push_back('\n'); break;
          case 'r': out.push_back('\r'); break;
          case 't': out.push_back('\t'); break;
          case 'u': {
            if (end - p < 4) return false;
            unsigned int cp = 0;
            for (int i = 0; i < 4; i++) {
              char h = p[i];
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else return false;
            }
            p += 4;
            // surrogate pair
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
                p[1] == 'u') {
              unsigned int lo = 0;
              bool okp = true;
              for (int i = 0; i < 4; i++) {
                char h = p[2 + i];
                lo <<= 4;
                if (h >= '0' && h <= '9') lo |= h - '0';
                else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                else { okp = false; break; }
              }
              if (okp && lo >= 0xDC00 && lo <= 0xDFFF) {
                p += 6;
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              }
            }
            // UTF-8 encode
            if (cp < 0x80) out.push_back((char)cp);
            else if (cp < 0x800) {
              out.push_back((char)(0xC0 | (cp >> 6)));
              out.push_back((char)(0x80 | (cp & 0x3F)));
            } else if (cp < 0x10000) {
              out.push_back((char)(0xE0 | (cp >> 12)));
              out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out.push_back((char)(0x80 | (cp & 0x3F)));
            } else {
              out.push_back((char)(0xF0 | (cp >> 18)));
              out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
              out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out.push_back((char)(0x80 | (cp & 0x3F)));
            }
            break;
          }
          default: return false;
        }
      } else {
        out.push_back((char)c);
        p++;
      }
    }
    return false;
  }
  bool skip_string() {
    if (p >= end || *p != '"') return false;
    p++;
    while (p < end) {
      if (*p == '\\') { p += 2; continue; }
      if (*p == '"') { p++; return true; }
      p++;
    }
    return false;
  }
  bool skip_value() {
    ws();
    if (p >= end) return false;
    switch (*p) {
      case '"': return skip_string();
      case '{': {
        p++;
        ws();
        if (p < end && *p == '}') { p++; return true; }
        while (p < end) {
          ws();
          if (!skip_string()) return false;
          ws();
          if (p >= end || *p != ':') return false;
          p++;
          if (!skip_value()) return false;
          ws();
          if (p < end && *p == ',') { p++; continue; }
          if (p < end && *p == '}') { p++; return true; }
          return false;
        }
        return false;
      }
      case '[': {
        p++;
        ws();
        if (p < end && *p == ']') { p++; return true; }
        while (p < end) {
          if (!skip_value()) return false;
          ws();
          if (p < end && *p == ',') { p++; continue; }
          if (p < end && *p == ']') { p++; return true; }
          return false;
        }
        return false;
      }
      case 't': return lit("true", 4);
      case 'f': return lit("false", 5);
      case 'n': return lit("null", 4);
      default: {
        const char* start = p;
        while (p < end && (*p == '-' || *p == '+' || *p == '.' || *p == 'e' ||
                           *p == 'E' || (*p >= '0' && *p <= '9')))
          p++;
        return p > start;
      }
    }
  }
};

// ------------------------------------------------------------- the encode --

struct StringRecord {
  int32_t array_id;
  int32_t flat_offset;
  int32_t is_pred;   // 1 when this is a pred array cell
  int32_t pred_id;
  int32_t str_offset;
  int32_t str_len;
};

struct EncodeState {
  const Schema* schema;
  uint8_t** buffers;       // array_id -> destination buffer
  std::string arena;       // collected ID/pred strings
  std::vector<StringRecord> records;
  int32_t error_array = -1;  // set on axis overflow / unencodable value
  bool unencodable = false;  // out-of-range numeric → oracle fallback
  std::string scratch;
};

inline int32_t flat_offset(const ArrayInfo& a, const int32_t* coords,
                           int depth) {
  // coords has `depth` entries; arrays may have fewer axes than the current
  // walk depth never happens (trie guarantees alignment).
  int32_t off = 0;
  for (int i = 0; i < a.ndim; i++) off = off * a.caps[i] + coords[i];
  return off;
}

// Values parsed at a leaf position.
enum LeafType { LEAF_NULL, LEAF_BOOL, LEAF_INT, LEAF_FLOAT, LEAF_STR, LEAF_CONTAINER };

struct Leaf {
  LeafType type = LEAF_NULL;
  bool b = false;
  double num = 0.0;
  int64_t inum = 0;
  const std::string* s = nullptr;  // points into EncodeState scratch/owned
};

// Out-of-range numerics must NOT silently truncate or read as missing —
// either would give a different verdict than the oracle (fail-open). They
// abort the row's encode; the host routes the request to the oracle
// (mirrors codec.UnencodableValue).
inline bool fits_i32(int64_t v) {
  return v >= INT32_MIN && v <= INT32_MAX;
}
inline bool fits_f32(double v) {
  return v == v && v <= 3.4028235677973366e38 && v >= -3.4028235677973366e38;
}

bool emit_terminals(EncodeState& st, const Node& node, const Leaf& leaf,
                    const int32_t* coords, int depth) {
  for (const Terminal& t : node.terminals) {
    const ArrayInfo& a = st.schema->arrays[(size_t)t.array_id];
    int32_t off = flat_offset(a, coords, depth);
    switch (t.kind) {
      case KIND_PRESENT:
        if (leaf.type != LEAF_NULL)
          st.buffers[t.array_id][off] = 1;
        break;
      case KIND_PRED:
        if (leaf.type == LEAF_STR) {
          st.records.push_back({t.array_id, off, 1, t.pred_id,
                                (int32_t)st.arena.size(),
                                (int32_t)leaf.s->size()});
          st.arena.append(*leaf.s);
        }
        break;
      case KIND_VALUE: {
        uint8_t* buf = st.buffers[t.array_id];
        // mask_id == -1: the optimizer proved this column's validity
        // mask redundant (zero-fill folding) — no mask buffer exists
        uint8_t* mask = t.mask_id >= 0 ? st.buffers[t.mask_id] : nullptr;
        switch (t.dtype) {
          case DT_ID:
            if (leaf.type == LEAF_STR) {
              st.records.push_back({t.array_id, off, 0, -1,
                                    (int32_t)st.arena.size(),
                                    (int32_t)leaf.s->size()});
              st.arena.append(*leaf.s);
              if (mask) mask[off] = 1;
            }
            break;
          case DT_F32:
            if (leaf.type == LEAF_INT || leaf.type == LEAF_FLOAT) {
              double v =
                  leaf.type == LEAF_INT ? (double)leaf.inum : leaf.num;
              if (!fits_f32(v)) {
                st.unencodable = true;
                st.error_array = t.array_id;
                return false;
              }
              ((float*)buf)[off] = (float)v;
              if (mask) mask[off] = 1;
            }
            break;
          case DT_I32:
            if (leaf.type == LEAF_INT) {
              if (!fits_i32(leaf.inum)) {
                st.unencodable = true;
                st.error_array = t.array_id;
                return false;
              }
              ((int32_t*)buf)[off] = (int32_t)leaf.inum;
              if (mask) mask[off] = 1;
            }
            break;
          case DT_BOOL:
            if (leaf.type == LEAF_BOOL) {
              buf[off] = leaf.b ? 1 : 0;
              if (mask) mask[off] = 1;
            }
            break;
        }
        break;
      }
    }
  }
  return true;
}

// Forward decl.
bool walk(EncodeState& st, Parser& ps, const Node& node, int32_t* coords,
          int depth);

// Expand a '*' axis over the upcoming JSON value.
bool walk_star(EncodeState& st, Parser& ps, const Node& node, int32_t* coords,
               int depth) {
  ps.ws();
  if (ps.p >= ps.end) return false;
  const Node& star = *node.star;
  if (*ps.p == '[') {
    ps.p++;
    ps.ws();
    int32_t i = 0;
    if (ps.p < ps.end && *ps.p == ']') { ps.p++; return true; }
    while (ps.p < ps.end) {
      if (node.axis_cap && i >= node.axis_cap) {
        st.error_array = node.overflow_id;
        return false;
      }
      coords[depth] = i;
      if (!walk(st, ps, star, coords, depth + 1)) return false;
      i++;
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == ']') { ps.p++; return true; }
      return false;
    }
    return false;
  }
  if (*ps.p == '{') {
    // Objects iterate {__key__, __value__} wrappers in SORTED key order; we
    // must buffer entries (key + raw value span) and re-walk them sorted.
    ps.p++;
    ps.ws();
    std::vector<std::pair<std::string, std::pair<const char*, const char*>>>
        entries;
    if (ps.p < ps.end && *ps.p == '}') {
      ps.p++;
    } else {
      while (ps.p < ps.end) {
        ps.ws();
        std::string key;
        if (!ps.str(key)) return false;
        ps.ws();
        if (ps.p >= ps.end || *ps.p != ':') return false;
        ps.p++;
        ps.ws();
        const char* vstart = ps.p;
        if (!ps.skip_value()) return false;
        entries.emplace_back(std::move(key), std::make_pair(vstart, ps.p));
        ps.ws();
        if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
        if (ps.p < ps.end && *ps.p == '}') { ps.p++; break; }
        return false;
      }
    }
    // Direct-key children coexist with the star expansion (e.g. both
    // metadata.labels[*] and metadata.labels.foo specs).
    if (!node.children.empty()) {
      for (auto& e : entries) {
        auto it = node.children.find(e.first);
        if (it != node.children.end()) {
          Parser sub(e.second.first,
                     (size_t)(e.second.second - e.second.first));
          if (!walk(st, sub, *it->second, coords, depth)) return false;
        }
      }
    }
    std::sort(entries.begin(), entries.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    if (node.axis_cap && (int32_t)entries.size() > node.axis_cap) {
      st.error_array = node.overflow_id;
      return false;
    }
    int32_t i = 0;
    for (auto& e : entries) {
      coords[depth] = i++;
      // The wrapper "element": terminals on the star node see a container.
      Leaf leaf;
      leaf.type = LEAF_CONTAINER;
      if (!emit_terminals(st, star, leaf, coords, depth + 1)) return false;
      // __key__ child
      auto kit = star.children.find("__key__");
      if (kit != star.children.end()) {
        Leaf kl;
        kl.type = LEAF_STR;
        kl.s = &e.first;
        if (!emit_terminals(st, *kit->second, kl, coords, depth + 1))
          return false;
        // __key__ has no deeper structure (it is a string)
      }
      // __value__ child: re-parse the buffered span
      auto vit = star.children.find("__value__");
      if (vit != star.children.end()) {
        Parser sub(e.second.first, (size_t)(e.second.second - e.second.first));
        if (!walk(st, sub, *vit->second, coords, depth + 1)) return false;
      }
      if (star.star) {
        // nested quantifier over the value (e.g. map value is an array):
        // matches codec semantics where the wrapper itself is the element
        // and deeper stars come from Elem sub-paths — wrapper dicts have no
        // direct star expansion.
      }
    }
    return true;
  }
  // Scalar under a star domain: not iterable — nothing to expand.
  return ps.skip_value();
}

bool walk(EncodeState& st, Parser& ps, const Node& node, int32_t* coords,
          int depth) {
  ps.ws();
  if (ps.p >= ps.end) return false;
  char c = *ps.p;

  // Leaf-typed values: emit terminals, no deeper traversal.
  if (c == '"') {
    st.scratch.clear();
    if (!ps.str(st.scratch)) return false;
    Leaf leaf;
    leaf.type = LEAF_STR;
    leaf.s = &st.scratch;
    if (!emit_terminals(st, node, leaf, coords, depth)) return false;
    return true;
  }
  if (c == 't' || c == 'f') {
    Leaf leaf;
    leaf.type = LEAF_BOOL;
    leaf.b = (c == 't');
    if (!(leaf.b ? ps.lit("true", 4) : ps.lit("false", 5))) return false;
    if (!emit_terminals(st, node, leaf, coords, depth)) return false;
    return true;
  }
  if (c == 'n') {
    if (!ps.lit("null", 4)) return false;
    Leaf leaf;  // LEAF_NULL
    if (!emit_terminals(st, node, leaf, coords, depth)) return false;
    return true;
  }
  if (c == '-' || (c >= '0' && c <= '9')) {
    const char* start = ps.p;
    bool is_float = false;
    while (ps.p < ps.end &&
           (*ps.p == '-' || *ps.p == '+' || *ps.p == '.' || *ps.p == 'e' ||
            *ps.p == 'E' || (*ps.p >= '0' && *ps.p <= '9'))) {
      if (*ps.p == '.' || *ps.p == 'e' || *ps.p == 'E') is_float = true;
      ps.p++;
    }
    std::string num(start, (size_t)(ps.p - start));
    Leaf leaf;
    if (is_float) {
      leaf.type = LEAF_FLOAT;
      leaf.num = strtod(num.c_str(), nullptr);
    } else {
      leaf.type = LEAF_INT;
      leaf.inum = strtoll(num.c_str(), nullptr, 10);
    }
    if (!emit_terminals(st, node, leaf, coords, depth)) return false;
    return true;
  }

  // Containers: presence terminals fire, then children / star.
  Leaf leaf;
  leaf.type = LEAF_CONTAINER;
  if (!emit_terminals(st, node, leaf, coords, depth)) return false;

  if (c == '{') {
    if (node.star) {
      // star over an object — handled by walk_star (it re-reads from p)
      return walk_star(st, ps, node, coords, depth);
    }
    ps.p++;
    ps.ws();
    if (ps.p < ps.end && *ps.p == '}') { ps.p++; return true; }
    while (ps.p < ps.end) {
      ps.ws();
      st.scratch.clear();
      std::string key;
      if (!ps.str(key)) return false;
      ps.ws();
      if (ps.p >= ps.end || *ps.p != ':') return false;
      ps.p++;
      auto it = node.children.find(key);
      if (it != node.children.end()) {
        if (!walk(st, ps, *it->second, coords, depth)) return false;
      } else {
        if (!ps.skip_value()) return false;
      }
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == '}') { ps.p++; return true; }
      return false;
    }
    return false;
  }
  if (c == '[') {
    if (node.star) return walk_star(st, ps, node, coords, depth);
    return ps.skip_value();  // array where schema expects object: skip
  }
  return false;
}

// ------------------------------------------------- schema JSON description --

// Minimal DOM for the schema description (parsed once at boot; clarity over
// speed here).
struct SVal {
  enum T { OBJ, ARR, STR, NUM, BOOL_, NUL } t = NUL;
  std::unordered_map<std::string, std::unique_ptr<SVal>> obj;
  std::vector<std::unique_ptr<SVal>> arr;
  std::string s;
  double num = 0;
  bool b = false;
};

std::unique_ptr<SVal> parse_sval(Parser& ps) {
  ps.ws();
  auto v = std::make_unique<SVal>();
  if (ps.p >= ps.end) return nullptr;
  char c = *ps.p;
  if (c == '{') {
    v->t = SVal::OBJ;
    ps.p++;
    ps.ws();
    if (ps.p < ps.end && *ps.p == '}') { ps.p++; return v; }
    while (ps.p < ps.end) {
      ps.ws();
      std::string key;
      if (!ps.str(key)) return nullptr;
      ps.ws();
      if (ps.p >= ps.end || *ps.p != ':') return nullptr;
      ps.p++;
      auto child = parse_sval(ps);
      if (!child) return nullptr;
      v->obj.emplace(std::move(key), std::move(child));
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == '}') { ps.p++; return v; }
      return nullptr;
    }
    return nullptr;
  }
  if (c == '[') {
    v->t = SVal::ARR;
    ps.p++;
    ps.ws();
    if (ps.p < ps.end && *ps.p == ']') { ps.p++; return v; }
    while (ps.p < ps.end) {
      auto child = parse_sval(ps);
      if (!child) return nullptr;
      v->arr.push_back(std::move(child));
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == ']') { ps.p++; return v; }
      return nullptr;
    }
    return nullptr;
  }
  if (c == '"') {
    v->t = SVal::STR;
    if (!ps.str(v->s)) return nullptr;
    return v;
  }
  if (c == 't') { v->t = SVal::BOOL_; v->b = true; return ps.lit("true", 4) ? std::move(v) : nullptr; }
  if (c == 'f') { v->t = SVal::BOOL_; v->b = false; return ps.lit("false", 5) ? std::move(v) : nullptr; }
  if (c == 'n') { v->t = SVal::NUL; return ps.lit("null", 4) ? std::move(v) : nullptr; }
  v->t = SVal::NUM;
  const char* start = ps.p;
  while (ps.p < ps.end && (*ps.p == '-' || *ps.p == '+' || *ps.p == '.' ||
                           *ps.p == 'e' || *ps.p == 'E' ||
                           (*ps.p >= '0' && *ps.p <= '9')))
    ps.p++;
  if (ps.p == start) return nullptr;
  v->num = strtod(std::string(start, (size_t)(ps.p - start)).c_str(), nullptr);
  return v;
}

bool build_node(const SVal& desc, Node& out) {
  auto ti = desc.obj.find("terminals");
  if (ti != desc.obj.end()) {
    for (const auto& t : ti->second->arr) {
      Terminal term;
      term.array_id = (int32_t)t->obj.at("array")->num;
      term.kind = (int32_t)t->obj.at("kind")->num;
      term.dtype = (int32_t)t->obj.at("dtype")->num;
      term.mask_id = (int32_t)t->obj.at("mask")->num;
      term.pred_id = (int32_t)t->obj.at("pred")->num;
      out.terminals.push_back(term);
    }
  }
  auto ci = desc.obj.find("children");
  if (ci != desc.obj.end()) {
    for (const auto& kv : ci->second->obj) {
      auto child = std::make_unique<Node>();
      if (!build_node(*kv.second, *child)) return false;
      out.children.emplace(kv.first, std::move(child));
    }
  }
  auto si = desc.obj.find("star");
  if (si != desc.obj.end() && si->second->t == SVal::OBJ) {
    out.star = std::make_unique<Node>();
    if (!build_node(*si->second, *out.star)) return false;
    out.axis_cap = (int32_t)desc.obj.at("axis_cap")->num;
    out.overflow_id = (int32_t)desc.obj.at("overflow_id")->num;
  }
  return true;
}

}  // namespace

// ------------------------------------------------------------------ C ABI --

extern "C" {

// Build a schema from its JSON description. Returns an opaque handle or null.
void* fastenc_create(const char* schema_json, int64_t len) {
  Parser ps(schema_json, (size_t)len);
  auto desc = parse_sval(ps);
  if (!desc || desc->t != SVal::OBJ) return nullptr;
  auto schema = std::make_unique<Schema>();
  for (const auto& a : desc->obj.at("arrays")->arr) {
    ArrayInfo info{};
    const auto& caps = a->obj.at("caps")->arr;
    info.ndim = (int32_t)caps.size();
    for (size_t i = 0; i < caps.size() && i < 2; i++)
      info.caps[i] = (int32_t)caps[i]->num;
    info.elsize = (int32_t)a->obj.at("elsize")->num;
    auto rs = a->obj.find("row_stride");
    info.row_stride = rs != a->obj.end() ? (int64_t)rs->second->num : 0;
    schema->arrays.push_back(info);
  }
  if (!build_node(*desc->obj.at("trie"), schema->root)) return nullptr;
  return schema.release();
}

void fastenc_destroy(void* handle) { delete (Schema*)handle; }

// Encode one JSON document.
//   buffers    — array of pointers, one per schema array (pre-zeroed!)
//   arena      — output buffer for ID/pred string bytes
//   arena_cap  — its capacity
//   records    — output buffer of int32 sextuples (see StringRecord)
//   records_cap— its capacity IN RECORDS
// Returns: >=0 — number of string records written;
//          -1 — JSON parse error; -2 — arena/records overflow;
//          -(1000+array_id) — axis cap overflow on array_id.
int64_t fastenc_encode(void* handle, const char* json, int64_t len,
                       uint8_t** buffers, uint8_t* arena, int64_t arena_cap,
                       int32_t* records, int64_t records_cap) {
  Schema* schema = (Schema*)handle;
  EncodeState st;
  st.schema = schema;
  st.buffers = buffers;
  Parser ps(json, (size_t)len);
  int32_t coords[4] = {0, 0, 0, 0};
  bool ok = walk(st, ps, schema->root, coords, 0);
  if (!ok) {
    if (st.error_array >= 0) return -(1000 + (int64_t)st.error_array);
    return -1;
  }
  if ((int64_t)st.arena.size() > arena_cap ||
      (int64_t)st.records.size() > records_cap)
    return -2;
  memcpy(arena, st.arena.data(), st.arena.size());
  memcpy(records, st.records.data(),
         st.records.size() * sizeof(StringRecord));
  return (int64_t)st.records.size();
}

// Encode a BATCH of JSON documents directly into batched (leading row axis)
// buffers — one call per dispatch, rows written in place, so the host never
// materializes per-request arrays or re-stacks them.
//   base_buffers — per-array base pointers of the batch arrays (pre-zeroed)
//   row_status   — per-row result: 0 ok, -1 parse error,
//                  -(1000+array_id) axis overflow (those rows are re-tried
//                  host-side on a wider bucket / the oracle)
//   records gain ABSOLUTE flat offsets (row * prod(caps) + local).
// Returns number of string records, or -2 on arena/records overflow.
int64_t fastenc_encode_batch(void* handle, const char** jsons,
                             const int64_t* lens, int64_t n_rows,
                             uint8_t** base_buffers, uint8_t* arena,
                             int64_t arena_cap, int32_t* records,
                             int64_t records_cap, int32_t* row_status) {
  Schema* schema = (Schema*)handle;
  size_t n_arrays = schema->arrays.size();
  std::vector<int64_t> stride_elems(n_arrays), block_bytes(n_arrays),
      row_stride_bytes(n_arrays);
  for (size_t i = 0; i < n_arrays; i++) {
    const ArrayInfo& a = schema->arrays[i];
    int64_t elems = 1;
    for (int d = 0; d < a.ndim; d++) elems *= a.caps[d];
    stride_elems[i] = elems;
    block_bytes[i] = elems * a.elsize;
    row_stride_bytes[i] = a.row_stride ? a.row_stride : block_bytes[i];
  }
  std::vector<uint8_t*> row_buffers(n_arrays);
  std::string arena_acc;
  std::vector<StringRecord> records_acc;
  // Batch-level string dedup: request corpora repeat names/images/keys
  // heavily, and the Python-side interning pass is O(#unique) after this.
  std::unordered_map<std::string, int32_t> interned;
  for (int64_t row = 0; row < n_rows; row++) {
    for (size_t i = 0; i < n_arrays; i++)
      row_buffers[i] = base_buffers[i] + row * row_stride_bytes[i];
    EncodeState st;
    st.schema = schema;
    st.buffers = row_buffers.data();
    Parser ps(jsons[row], (size_t)lens[row]);
    int32_t coords[4] = {0, 0, 0, 0};
    bool ok = walk(st, ps, schema->root, coords, 0);
    if (!ok) {
      row_status[row] =
          st.error_array >= 0 ? -(1000 + st.error_array) : -1;
      // wipe partial writes: the row still rides the batch dispatch and
      // must read as all-missing
      for (size_t i = 0; i < n_arrays; i++)
        memset(row_buffers[i], 0, (size_t)block_bytes[i]);
      continue;
    }
    row_status[row] = 0;
    for (StringRecord r : st.records) {
      std::string s(st.arena.data() + r.str_offset, (size_t)r.str_len);
      auto it = interned.find(s);
      int32_t off;
      if (it == interned.end()) {
        off = (int32_t)arena_acc.size();
        arena_acc.append(s);
        interned.emplace(std::move(s), off);
      } else {
        off = it->second;
      }
      r.str_offset = off;
      r.flat_offset += (int32_t)(row * stride_elems[(size_t)r.array_id]);
      records_acc.push_back(r);
    }
  }
  if ((int64_t)arena_acc.size() > arena_cap ||
      (int64_t)records_acc.size() > records_cap)
    return -2;
  // empty accumulators hand memcpy a null .data() — UB for a nonnull
  // parameter even at n=0 (no strings in the batch is a real case)
  if (!arena_acc.empty()) memcpy(arena, arena_acc.data(), arena_acc.size());
  if (!records_acc.empty())
    memcpy(records, records_acc.data(),
           records_acc.size() * sizeof(StringRecord));
  return (int64_t)records_acc.size();
}

}  // extern "C"
