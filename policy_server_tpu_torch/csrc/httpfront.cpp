// httpfront — GIL-free native HTTP/1.1 front-end for the policy server.
//
// The serving profile has been framing-bound since round 3: the in-process
// micro-batcher sustains 35-69k reviews/s while Python asyncio HTTP framing
// caps ≈1.3k requests/s per event loop (PROFILE.md rounds 3/5). This file is
// the csrc/ answer (fastenc.cpp / wasmint.cpp precedent): an epoll-based
// HTTP/1.1 server running entirely on native threads — accept, framing
// (keep-alive, chunked bodies, pipelining), AdmissionReview JSON parsing,
// and response serialization never touch the GIL. Python only drains parsed
// requests from a lock-free submission ring (one SPSC ring per event loop)
// and completes them through a lock-free MPSC completion stack.
//
// Parse fusion: the request handler parses the AdmissionReview ONCE,
// canonicalizing the `request` object into exactly the compact JSON bytes
// Python's json.dumps(AdmissionRequest.to_dict(), separators=(",", ":"))
// would produce (fixed key order, dropped nulls, normalized kind/resource,
// ensure_ascii escaping). Those bytes feed the fastenc native batch encoder
// directly (WireValidateRequest.payload_json()), so the old
// bytes→dict→re-serialize→encode double parse becomes one native pass.
// The canonicalizer is deliberately CONSERVATIVE: any construct whose
// Python-observable semantics it cannot reproduce byte-for-byte (floats,
// duplicate object keys, lone surrogates, non-string uid/namespace/
// operation, NaN/Infinity, depth > 96, invalid UTF-8, any syntax error)
// falls back to shipping the raw body for the Python parser — the Python
// frontend stays the correctness oracle, and 422 bodies are bit-exact by
// construction because Python renders them.
//
// Response serialization (round 19: batch-granular native response
// assembly): verdict shapes up to and including patches (patchType +
// base64 JSONPatch), warnings lists, and full status objects (message,
// code, reason, details.causes tables — group denials) serialize
// natively from packed v2 verdict records (parse_verdict_record) with
// json.dumps' default separators, byte-exact vs the Python responder
// (tests/test_native_assembly.py differential corpus; graftcheck RS01/
// RS02 pin the field classification and key order). Only
// auditAnnotations and non-encodable strings arrive pre-rendered from
// Python — the per-row oracle for hooks/mutations. HTTP response heads
// mirror aiohttp's (status line, Content-Type, Content-Length, Date,
// Server, Connection) so the differential framing corpus can require
// byte-parity modulo the Date value.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <arpa/inet.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <stdio.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- helpers --

inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

const char* reason_of(int status) {
  switch (status) {
    case 100: return "Continue";
    case 200: return "OK";
    case 202: return "Accepted";
    case 400: return "Bad Request";
    case 401: return "Unauthorized";
    case 403: return "Forbidden";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 409: return "Conflict";
    case 413: return "Request Entity Too Large";
    case 422: return "Unprocessable Entity";
    case 429: return "Too Many Requests";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    case 504: return "Gateway Timeout";
    default: return "Unknown";
  }
}

// ------------------------------------------------------- submission record --
// Wire layout of one parsed request handed to Python (little-endian):
//   u32 total_len (including this field)
//   u64 req_id
//   u8  kind      0=validate-parsed 1=audit-parsed 2=raw
//                 3=validate-fallback 4=audit-fallback
//   u8  flags     bit0: namespace present
//   u16 policy_len | u16 uid_len | u16 ns_len | u16 op_len | u16 gvk_len
//   u16 tp_len    (W3C traceparent header, verbatim; 0 when absent)
//   u32 payload_len
//   i64 t_first_ns | i64 t_parse_ns | i64 t_push_ns
//       flight-recorder stamps on CLOCK_MONOTONIC (the clock Python's
//       perf_counter_ns reads on Linux): request first byte observed,
//       request fully received (canonicalize begins), record pushed to
//       the ring. t_first is 0 when the request arrived in one read
//       (the arrival window never opened).
//   bytes: policy_id, uid, namespace, operation, requestKind.kind,
//          traceparent, payload
// Parsed kinds carry the canonical payload; raw/fallback carry the raw body.

constexpr int K_VALIDATE = 0, K_AUDIT = 1, K_RAW = 2, K_VALIDATE_FB = 3,
              K_AUDIT_FB = 4;

// graftcheck: abi(policy_server_tpu_torch/runtime/native_frontend.py:_REC)
struct RecHeader {
  uint32_t total_len;
  uint64_t req_id;
  uint8_t kind;
  uint8_t flags;
  uint16_t policy_len, uid_len, ns_len, op_len, gvk_len, tp_len;
  uint32_t payload_len;
  int64_t t_first_ns, t_parse_ns, t_push_ns;
} __attribute__((packed));

// graftcheck: wire-input
uint8_t* build_record(uint64_t req_id, int kind, bool has_ns,
                      const std::string& policy, const std::string& uid,
                      const std::string& ns, const std::string& op,
                      const std::string& gvk, const std::string& tp,
                      const std::string& payload, int64_t t_first,
                      int64_t t_parse, int64_t t_push) {
  // every wire-length field is narrower than size_t: a field that does
  // not fit its slot must fail the record, never truncate into a header
  // whose lens disagree with the bytes that follow (the Python drainer
  // would mis-split the record body). submit_request bounds the canon
  // fields and routing bounds policy_id, so this rejects nothing in
  // practice — it exists so the wire format cannot be corrupted by a
  // future caller that forgets.
  if (policy.size() > 0xFFFF || uid.size() > 0xFFFF || ns.size() > 0xFFFF ||
      op.size() > 0xFFFF || gvk.size() > 0xFFFF || tp.size() > 0xFFFF ||
      payload.size() > 0xFFFFFFFFull)
    return nullptr;
  size_t total = sizeof(RecHeader) + policy.size() + uid.size() + ns.size() +
                 op.size() + gvk.size() + tp.size() + payload.size();
  uint8_t* blob = (uint8_t*)malloc(total);
  RecHeader h;
  h.total_len = (uint32_t)total;
  h.req_id = req_id;
  h.kind = (uint8_t)kind;
  h.flags = has_ns ? 1 : 0;
  h.policy_len = (uint16_t)policy.size();
  h.uid_len = (uint16_t)uid.size();
  h.ns_len = (uint16_t)ns.size();
  h.op_len = (uint16_t)op.size();
  h.gvk_len = (uint16_t)gvk.size();
  h.tp_len = (uint16_t)tp.size();
  h.payload_len = (uint32_t)payload.size();
  h.t_first_ns = t_first;
  h.t_parse_ns = t_parse;
  h.t_push_ns = t_push;
  uint8_t* p = blob;
  memcpy(p, &h, sizeof(h)); p += sizeof(h);
  memcpy(p, policy.data(), policy.size()); p += policy.size();
  memcpy(p, uid.data(), uid.size()); p += uid.size();
  memcpy(p, ns.data(), ns.size()); p += ns.size();
  memcpy(p, op.data(), op.size()); p += op.size();
  memcpy(p, gvk.data(), gvk.size()); p += gvk.size();
  memcpy(p, tp.data(), tp.size()); p += tp.size();
  memcpy(p, payload.data(), payload.size());
  return blob;
}

// ------------------------------------------------- lock-free SPSC sub ring --
// One producer (the owning event-loop thread), one consumer (the Python
// drainer). Slots hold malloc'd record blobs; capacity is a power of two.

struct SubRing {
  std::vector<std::atomic<uint8_t*>> slots;
  size_t mask;
  std::atomic<uint64_t> head{0};  // producer: next write index
  std::atomic<uint64_t> tail{0};  // consumer: next read index

  explicit SubRing(size_t bits) : slots(1ull << bits), mask((1ull << bits) - 1) {
    for (auto& s : slots) s.store(nullptr, std::memory_order_relaxed);
  }
  // Returns -1 when full, 1 when pushed onto an EMPTY ring (the consumer
  // may be blocked — wake it), 0 when pushed behind existing records
  // (the consumer re-scans before blocking, so no wake syscall needed —
  // syscalls are ~10-25us on sandboxed kernels and dominate at rate).
  int push(uint8_t* rec) {
    uint64_t h = head.load(std::memory_order_relaxed);
    uint64_t t = tail.load(std::memory_order_acquire);
    if (h - t > mask) return -1;  // full
    slots[h & mask].store(rec, std::memory_order_relaxed);
    head.store(h + 1, std::memory_order_release);
    return h == t ? 1 : 0;
  }
  uint8_t* pop() {
    uint64_t t = tail.load(std::memory_order_relaxed);
    if (t == head.load(std::memory_order_acquire)) return nullptr;
    uint8_t* rec = slots[t & mask].load(std::memory_order_relaxed);
    tail.store(t + 1, std::memory_order_release);
    return rec;
  }
  // consumer-side peek/advance pair: the drainer must see a record's size
  // BEFORE committing to copy it into the (bounded) poll buffer
  uint8_t* peek() {
    uint64_t t = tail.load(std::memory_order_relaxed);
    if (t == head.load(std::memory_order_acquire)) return nullptr;
    return slots[t & mask].load(std::memory_order_relaxed);
  }
  void advance() {
    tail.store(tail.load(std::memory_order_relaxed) + 1,
               std::memory_order_release);
  }
};

// --------------------------------------------- lock-free MPSC completions --
// Producers: arbitrary Python threads (batcher pool workers, the drainer).
// Consumer: the owning event-loop thread. Classic Treiber stack; the
// consumer takes the whole stack with one exchange and reverses it so
// responses complete in push order.

struct Comp {
  Comp* next;
  uint64_t req_id;
  int status;
  int retry_after;  // <=0: none
  std::string body;
};

struct CompStack {
  std::atomic<Comp*> top{nullptr};
  // true when pushed onto an EMPTY stack: the first pusher after a
  // consumer drain issues the (expensive) eventfd wake; later pushers
  // coalesce onto the already-pending wakeup
  bool push(Comp* c) {
    Comp* t = top.load(std::memory_order_relaxed);
    do {
      c->next = t;
    } while (!top.compare_exchange_weak(t, c, std::memory_order_release,
                                        std::memory_order_relaxed));
    return t == nullptr;
  }
  Comp* take_all_reversed() {
    Comp* c = top.exchange(nullptr, std::memory_order_acquire);
    Comp* rev = nullptr;
    while (c) {
      Comp* nx = c->next;
      c->next = rev;
      rev = c;
      c = nx;
    }
    return rev;
  }
};

// ----------------------------------------------------- JSON canonicalizer --
// Strict parser + writer reproducing Python json.dumps byte-for-byte for
// the subset it accepts; anything else returns false → Python fallback.

constexpr int MAX_DEPTH = 96;

struct Jp {
  const char* p;
  const char* end;
  void ws() {
    while (p < end &&
           (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
  }
  bool lit(const char* s, size_t n) {
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }
};

// graftcheck: wire-input
bool valid_utf8(const uint8_t* s, size_t n) {
  size_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c < 0x80) { i++; continue; }
    int len;
    uint32_t cp;
    if ((c & 0xE0) == 0xC0) { len = 2; cp = c & 0x1F; }
    else if ((c & 0xF0) == 0xE0) { len = 3; cp = c & 0x0F; }
    else if ((c & 0xF8) == 0xF0) { len = 4; cp = c & 0x07; }
    else return false;
    if (i + len > n) return false;
    for (int k = 1; k < len; k++) {
      if ((s[i + k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (s[i + k] & 0x3F);
    }
    if (len == 2 && cp < 0x80) return false;          // overlong
    if (len == 3 && cp < 0x800) return false;
    if (len == 4 && cp < 0x10000) return false;
    if (cp > 0x10FFFF) return false;
    if (cp >= 0xD800 && cp <= 0xDFFF) return false;   // raw surrogate
    i += len;
  }
  return true;
}

// Decode a JSON string literal (at *p == '"') into UTF-8 `out`. Rejects
// lone surrogates and invalid escapes (Python tolerates lone surrogates;
// re-emitting them byte-exactly needs surrogate bookkeeping we skip —
// fallback is correct, just slower).
// graftcheck: wire-input
bool jstr(Jp& ps, std::string& out) {
  if (ps.p >= ps.end || *ps.p != '"') return false;
  ps.p++;
  while (ps.p < ps.end) {
    unsigned char c = (unsigned char)*ps.p;
    if (c == '"') { ps.p++; return true; }
    if (c < 0x20) return false;  // raw control char: Python rejects too
    if (c == '\\') {
      ps.p++;
      if (ps.p >= ps.end) return false;
      char e = *ps.p++;
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
          if (ps.end - ps.p < 4) return false;
          uint32_t cp = 0;
          for (int i = 0; i < 4; i++) {
            char h = ps.p[i];
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          ps.p += 4;
          if (cp >= 0xD800 && cp <= 0xDBFF) {
            if (ps.end - ps.p < 6 || ps.p[0] != '\\' || ps.p[1] != 'u')
              return false;  // lone high surrogate
            uint32_t lo = 0;
            for (int i = 0; i < 4; i++) {
              char h = ps.p[2 + i];
              lo <<= 4;
              if (h >= '0' && h <= '9') lo |= h - '0';
              else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
              else return false;
            }
            if (lo < 0xDC00 || lo > 0xDFFF) return false;
            ps.p += 6;
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
          } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
            return false;  // lone low surrogate
          }
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
      ps.p++;
    }
  }
  return false;
}

// Emit a UTF-8 string as Python json.dumps would (ensure_ascii=True):
// every char outside 0x20..0x7E escaped, lowercase hex, surrogate pairs
// for astral code points. Input must be valid UTF-8 (caller checked).
void py_escape(const std::string& s, std::string& out) {
  static const char* hexd = "0123456789abcdef";
  out.push_back('"');
  size_t i = 0, n = s.size();
  const uint8_t* d = (const uint8_t*)s.data();
  auto esc = [&](uint32_t u) {
    out.push_back('\\');
    out.push_back('u');
    out.push_back(hexd[(u >> 12) & 0xF]);
    out.push_back(hexd[(u >> 8) & 0xF]);
    out.push_back(hexd[(u >> 4) & 0xF]);
    out.push_back(hexd[u & 0xF]);
  };
  while (i < n) {
    uint8_t c = d[i];
    if (c < 0x80) {
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\b': out += "\\b"; break;
        case '\f': out += "\\f"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        default:
          if (c < 0x20 || c == 0x7F) esc(c);
          else out.push_back((char)c);
      }
      i++;
      continue;
    }
    uint32_t cp;
    int len;
    if ((c & 0xE0) == 0xC0) { len = 2; cp = c & 0x1F; }
    else if ((c & 0xF0) == 0xE0) { len = 3; cp = c & 0x0F; }
    else { len = 4; cp = c & 0x07; }
    // verdict-record fields reach here unvalidated (the Python packer
    // is the trusted producer, but httpfront_render_verdict is exported
    // for arbitrary bytes): a multibyte lead truncated by the end of
    // the field must not read past it — clamp and escape the garbage
    if (i + (size_t)len > n) len = (int)(n - i);
    for (int k = 1; k < len; k++) cp = (cp << 6) | (d[i + k] & 0x3F);
    i += len;
    if (cp < 0x10000) {
      esc(cp);
    } else {
      cp -= 0x10000;
      esc(0xD800 + (cp >> 10));
      esc(0xDC00 + (cp & 0x3FF));
    }
  }
  out.push_back('"');
}

// Strict number: -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
// Integers are re-emittable verbatim; fractions/exponents (Python float
// repr) and "-0" (Python normalizes to 0) are not → is_int=false.
bool jnum(Jp& ps, const char** start, const char** stop, bool* is_int) {
  const char* p = ps.p;
  const char* end = ps.end;
  *start = p;
  bool neg = false;
  if (p < end && *p == '-') { neg = true; p++; }
  if (p >= end) return false;
  if (*p == '0') {
    p++;
  } else if (*p >= '1' && *p <= '9') {
    while (p < end && *p >= '0' && *p <= '9') p++;
  } else {
    return false;
  }
  bool integral = true;
  if (p < end && *p == '.') {
    integral = false;
    p++;
    if (p >= end || *p < '0' || *p > '9') return false;
    while (p < end && *p >= '0' && *p <= '9') p++;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    integral = false;
    p++;
    if (p < end && (*p == '+' || *p == '-')) p++;
    if (p >= end || *p < '0' || *p > '9') return false;
    while (p < end && *p >= '0' && *p <= '9') p++;
  }
  // "-0" loads as int 0 in Python; verbatim re-emit would diverge
  if (neg && integral && (p - *start) == 2 && (*start)[1] == '0')
    integral = false;
  *stop = p;
  *is_int = integral;
  ps.p = p;
  return true;
}

// Canonicalize one JSON value: parse strictly, append the exact bytes
// Python json.dumps(value, separators=(",",":")) would produce. Objects
// keep wire key order (Python dicts preserve insertion); duplicate keys,
// floats, and anything surrogate-y bail out.
bool canon_value(Jp& ps, std::string& out, int depth) {
  if (depth > MAX_DEPTH) return false;
  ps.ws();
  if (ps.p >= ps.end) return false;
  char c = *ps.p;
  if (c == '"') {
    std::string s;
    if (!jstr(ps, s)) return false;
    py_escape(s, out);
    return true;
  }
  if (c == 't') { if (!ps.lit("true", 4)) return false; out += "true"; return true; }
  if (c == 'f') { if (!ps.lit("false", 5)) return false; out += "false"; return true; }
  if (c == 'n') { if (!ps.lit("null", 4)) return false; out += "null"; return true; }
  if (c == '{') {
    ps.p++;
    ps.ws();
    out.push_back('{');
    if (ps.p < ps.end && *ps.p == '}') { ps.p++; out.push_back('}'); return true; }
    std::unordered_set<std::string> seen;
    bool first = true;
    while (ps.p < ps.end) {
      ps.ws();
      std::string key;
      if (!jstr(ps, key)) return false;
      if (!seen.insert(key).second) return false;  // dup: Python last-wins
      ps.ws();
      if (ps.p >= ps.end || *ps.p != ':') return false;
      ps.p++;
      if (!first) out.push_back(',');
      first = false;
      py_escape(key, out);
      out.push_back(':');
      if (!canon_value(ps, out, depth + 1)) return false;
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == '}') { ps.p++; out.push_back('}'); return true; }
      return false;
    }
    return false;
  }
  if (c == '[') {
    ps.p++;
    ps.ws();
    out.push_back('[');
    if (ps.p < ps.end && *ps.p == ']') { ps.p++; out.push_back(']'); return true; }
    bool first = true;
    while (ps.p < ps.end) {
      if (!first) out.push_back(',');
      first = false;
      if (!canon_value(ps, out, depth + 1)) return false;
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == ']') { ps.p++; out.push_back(']'); return true; }
      return false;
    }
    return false;
  }
  const char *s0, *s1;
  bool is_int;
  if (!jnum(ps, &s0, &s1, &is_int)) return false;
  if (!is_int) return false;  // float repr parity is Python's job
  out.append(s0, (size_t)(s1 - s0));
  return true;
}

// Validate-and-skip one JSON value (content is dropped; syntax must still
// be at-least-as-strict as Python so "native 200 / python 422" divergence
// cannot happen). Floats ARE fine here — skipped values are never
// re-emitted.
bool skip_value(Jp& ps, int depth) {
  if (depth > MAX_DEPTH) return false;
  ps.ws();
  if (ps.p >= ps.end) return false;
  char c = *ps.p;
  if (c == '"') { std::string s; return jstr(ps, s); }
  if (c == 't') return ps.lit("true", 4);
  if (c == 'f') return ps.lit("false", 5);
  if (c == 'n') return ps.lit("null", 4);
  if (c == '{') {
    ps.p++;
    ps.ws();
    if (ps.p < ps.end && *ps.p == '}') { ps.p++; return true; }
    while (ps.p < ps.end) {
      ps.ws();
      std::string key;
      if (!jstr(ps, key)) return false;
      ps.ws();
      if (ps.p >= ps.end || *ps.p != ':') return false;
      ps.p++;
      if (!skip_value(ps, depth + 1)) return false;
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == '}') { ps.p++; return true; }
      return false;
    }
    return false;
  }
  if (c == '[') {
    ps.p++;
    ps.ws();
    if (ps.p < ps.end && *ps.p == ']') { ps.p++; return true; }
    while (ps.p < ps.end) {
      if (!skip_value(ps, depth + 1)) return false;
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == ']') { ps.p++; return true; }
      return false;
    }
    return false;
  }
  const char *s0, *s1;
  bool is_int;
  return jnum(ps, &s0, &s1, &is_int);
}

struct Span {
  const char* a = nullptr;
  const char* b = nullptr;
  bool present() const { return a != nullptr; }
};

bool span_is_null(const Span& s) {
  Jp ps{s.a, s.b};
  ps.ws();
  return ps.lit("null", 4);
}

// A span that must hold a JSON string → decoded value.
bool span_string(const Span& s, std::string& out) {
  Jp ps{s.a, s.b};
  ps.ws();
  if (ps.p >= ps.end || *ps.p != '"') return false;
  return jstr(ps, out);
}

// Normalize a kind/resource sub-object per GroupVersionKind.from_dict:
// {"group": g, "version": v, "kind"/"resource": k} with "" for missing or
// null; values must be JSON strings (non-string truthiness games →
// fallback); unknown sub-keys ignored; duplicate known sub-keys bail.
bool canon_gvk(const Span& s, const char* third_key, std::string& out,
               std::string* kind_out) {
  std::string g, v, k;
  bool has_g = false, has_v = false, has_k = false;
  if (s.present() && !span_is_null(s)) {
    Jp ps{s.a, s.b};
    ps.ws();
    if (ps.p >= ps.end || *ps.p != '{') return false;
    ps.p++;
    ps.ws();
    if (ps.p < ps.end && *ps.p == '}') {
      ps.p++;
    } else {
      while (ps.p < ps.end) {
        ps.ws();
        std::string key;
        if (!jstr(ps, key)) return false;
        ps.ws();
        if (ps.p >= ps.end || *ps.p != ':') return false;
        ps.p++;
        ps.ws();
        bool known = key == "group" || key == "version" || key == third_key;
        if (known) {
          std::string* dst = key == "group" ? &g
                             : key == "version" ? &v : &k;
          bool* flag = key == "group" ? &has_g
                       : key == "version" ? &has_v : &has_k;
          if (*flag) return false;  // dup
          *flag = true;
          if (ps.p < ps.end && *ps.p == 'n') {
            if (!ps.lit("null", 4)) return false;  // null → ""
          } else if (!jstr(ps, *dst)) {
            return false;  // non-string value: truthiness games → Python
          }
        } else {
          if (!skip_value(ps, 0)) return false;
        }
        ps.ws();
        if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
        if (ps.p < ps.end && *ps.p == '}') { ps.p++; break; }
        return false;
      }
    }
    Jp tail = ps;
    tail.ws();
    if (tail.p != tail.end) return false;
  }
  out += "{\"group\":";
  py_escape(g, out);
  out += ",\"version\":";
  py_escape(v, out);
  out += ",\"";
  out += third_key;
  out += "\":";
  py_escape(k, out);
  out.push_back('}');
  if (kind_out) *kind_out = k;
  return true;
}

struct CanonResult {
  std::string uid, ns, op, gvk;  // gvk = requestKind.kind ("" when absent)
  bool has_ns = false;
  std::string payload;           // canonical compact request JSON
};

// Canonicalize a full AdmissionReview body → CanonResult. Returns false
// for ANYTHING it cannot reproduce byte-exactly → Python fallback.
bool canon_admission_review(const char* body, size_t len, CanonResult& out) {
  if (!valid_utf8((const uint8_t*)body, len)) return false;
  Jp ps{body, body + len};
  ps.ws();
  if (ps.p >= ps.end || *ps.p != '{') return false;
  ps.p++;
  ps.ws();
  Span request;
  if (ps.p < ps.end && *ps.p == '}') {
    ps.p++;
  } else {
    while (ps.p < ps.end) {
      ps.ws();
      std::string key;
      if (!jstr(ps, key)) return false;
      ps.ws();
      if (ps.p >= ps.end || *ps.p != ':') return false;
      ps.p++;
      ps.ws();
      if (key == "request") {
        if (request.present()) return false;  // dup request key
        request.a = ps.p;
        if (!skip_value(ps, 0)) return false;
        request.b = ps.p;
      } else {
        if (!skip_value(ps, 0)) return false;
      }
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      if (ps.p < ps.end && *ps.p == '}') { ps.p++; break; }
      return false;
    }
  }
  ps.ws();
  if (ps.p != ps.end) return false;  // trailing garbage: Python 422s
  if (!request.present()) return false;  // missing request: Python 422s

  // second pass: collect the known request fields' spans
  Jp rq{request.a, request.b};
  rq.ws();
  if (rq.p >= rq.end || *rq.p != '{') return false;
  rq.p++;
  rq.ws();
  Span f_uid, f_kind, f_resource, f_sub, f_rkind, f_rres, f_rsub, f_name,
      f_ns, f_op, f_user, f_obj, f_old, f_dry, f_opt;
  struct KV { const char* name; Span* span; };
  const KV table[] = {
      {"uid", &f_uid}, {"kind", &f_kind}, {"resource", &f_resource},
      {"subResource", &f_sub}, {"requestKind", &f_rkind},
      {"requestResource", &f_rres}, {"requestSubResource", &f_rsub},
      {"name", &f_name}, {"namespace", &f_ns}, {"operation", &f_op},
      {"userInfo", &f_user}, {"object", &f_obj}, {"oldObject", &f_old},
      {"dryRun", &f_dry}, {"options", &f_opt},
  };
  if (rq.p < rq.end && *rq.p == '}') {
    rq.p++;
  } else {
    while (rq.p < rq.end) {
      rq.ws();
      std::string key;
      if (!jstr(rq, key)) return false;
      rq.ws();
      if (rq.p >= rq.end || *rq.p != ':') return false;
      rq.p++;
      rq.ws();
      Span* dst = nullptr;
      for (const auto& kv : table)
        if (key == kv.name) { dst = kv.span; break; }
      const char* a = rq.p;
      if (!skip_value(rq, 0)) return false;
      if (dst != nullptr) {
        if (dst->present()) return false;  // dup known key
        dst->a = a;
        dst->b = rq.p;
      }
      rq.ws();
      if (rq.p < rq.end && *rq.p == ',') { rq.p++; continue; }
      if (rq.p < rq.end && *rq.p == '}') { rq.p++; break; }
      return false;
    }
  }
  Jp rtail = rq;
  rtail.ws();
  if (rtail.p != rtail.end) return false;

  // uid: required non-empty string (else Python raises the exact 422)
  if (!f_uid.present() || !span_string(f_uid, out.uid) || out.uid.empty())
    return false;

  std::string& pl = out.payload;
  pl.reserve((size_t)(request.b - request.a) + 64);
  pl += "{\"uid\":";
  py_escape(out.uid, pl);
  pl += ",\"kind\":";
  if (!canon_gvk(f_kind, "kind", pl, nullptr)) return false;
  pl += ",\"resource\":";
  if (!canon_gvk(f_resource, "resource", pl, nullptr)) return false;

  auto emit_optional = [&](const Span& s, const char* key) -> bool {
    if (!s.present() || span_is_null(s)) return true;
    pl += ",\"";
    pl += key;
    pl += "\":";
    Jp vp{s.a, s.b};
    if (!canon_value(vp, pl, 0)) return false;
    Jp vt = vp;
    vt.ws();
    return vt.p == vt.end;
  };

  if (!emit_optional(f_sub, "subResource")) return false;
  if (f_rkind.present() && !span_is_null(f_rkind)) {
    pl += ",\"requestKind\":";
    if (!canon_gvk(f_rkind, "kind", pl, &out.gvk)) return false;
  }
  if (f_rres.present() && !span_is_null(f_rres)) {
    pl += ",\"requestResource\":";
    if (!canon_gvk(f_rres, "resource", pl, nullptr)) return false;
  }
  if (!emit_optional(f_rsub, "requestSubResource")) return false;
  if (!emit_optional(f_name, "name")) return false;
  // namespace: header consumers (always-accept shortcut, metric labels)
  // read it as a string — require string-or-absent
  if (f_ns.present() && !span_is_null(f_ns)) {
    if (!span_string(f_ns, out.ns)) return false;
    out.has_ns = true;
    pl += ",\"namespace\":";
    py_escape(out.ns, pl);
  }
  // operation: `d.get("operation", "") or ""` — falsy → ""; require
  // string-or-absent-or-null (0/false → Python)
  if (f_op.present() && !span_is_null(f_op)) {
    if (!span_string(f_op, out.op)) return false;
  }
  pl += ",\"operation\":";
  py_escape(out.op, pl);
  // userInfo: dict(x or {}) then `or None` — {} and [] drop, object
  // emits in wire order, anything else → Python
  if (f_user.present() && !span_is_null(f_user)) {
    Jp up{f_user.a, f_user.b};
    up.ws();
    if (up.p < up.end && *up.p == '{') {
      std::string tmp;
      Jp vp{f_user.a, f_user.b};
      if (!canon_value(vp, tmp, 0)) return false;
      Jp vt = vp;
      vt.ws();
      if (vt.p != vt.end) return false;
      if (tmp != "{}") {
        pl += ",\"userInfo\":";
        pl += tmp;
      }
    } else if (up.p < up.end && *up.p == '[') {
      Jp vp = up;
      if (!skip_value(vp, 0)) return false;
      std::string probe(up.p, (size_t)(f_user.b - up.p));
      // only the empty array maps to dict([]) == {} → dropped
      Jp ep{f_user.a, f_user.b};
      ep.ws();
      ep.p++;
      ep.ws();
      if (ep.p >= ep.end || *ep.p != ']') return false;
    } else {
      return false;
    }
  }
  if (!emit_optional(f_obj, "object")) return false;
  if (!emit_optional(f_old, "oldObject")) return false;
  if (!emit_optional(f_dry, "dryRun")) return false;
  if (!emit_optional(f_opt, "options")) return false;
  pl.push_back('}');
  return true;
}

// --------------------------------------------------------------- responses --

struct StaticResp {
  int status = 0;
  std::string content_type;
  std::string body;         // 413 slot: printf template with one %lld
  std::string extra;        // extra header lines, e.g. "Allow: POST\r\n"
};

enum { ST_404 = 0, ST_405 = 1, ST_413 = 2, ST_503 = 3, ST_400 = 4, ST_MAX = 5 };

// -------------------------------------------------------------------- tls --
//
// Native TLS termination (round 20): OpenSSL is bound at RUNTIME via
// dlopen — this toolchain ships libssl.so.1.1/libcrypto.so.1.1 but no
// development headers, so the needed subset of the OpenSSL 1.1 API is
// declared here (the 1.1 ABI is stable; the same names resolve against
// 3.x). A missing or incomplete libssl leaves TlsApi::ok false and
// httpfront_tls_available() reports it, so the Python side degrades
// LOUDLY to the aiohttp TLS frontend (round-11 fallback precedent)
// instead of silently serving plaintext.
//
// Handshakes run on memory BIOs entirely inside the event loop: the
// socket stays in the same non-blocking epoll state machine, raw bytes
// are pumped socket→rbio and wbio→socket, and SSL_read/SSL_write sit
// between the socket and the UNCHANGED plaintext parser/assembler.
// kTLS offload after the userspace handshake needs OpenSSL 3.x
// (SSL_OP_ENABLE_KTLS); against 1.1 the capability probe answers no
// and the Python side logs it — a probe, never a silent downgrade.

constexpr int kSSL_ERROR_WANT_READ = 2;
constexpr int kSSL_ERROR_WANT_WRITE = 3;
constexpr int kSSL_ERROR_ZERO_RETURN = 6;
constexpr int kSSL_CTRL_SET_MIN_PROTO_VERSION = 123;
constexpr int kSSL_CTRL_EXTRA_CHAIN_CERT = 14;
constexpr long kTLS1_2_VERSION = 0x0303;
constexpr int kSSL_VERIFY_PEER = 0x01;
constexpr int kSSL_VERIFY_FAIL_IF_NO_PEER_CERT = 0x02;

struct TlsApi {
  bool ok = false;
  bool ktls = false;  // SSL_sendfile present (OpenSSL 3.x kTLS build)
  std::string err;    // why the binding is unavailable
  // libcrypto
  void* (*BIO_new)(const void*) = nullptr;
  const void* (*BIO_s_mem)() = nullptr;
  int (*BIO_write)(void*, const void*, int) = nullptr;
  int (*BIO_read)(void*, void*, int) = nullptr;
  size_t (*BIO_ctrl_pending)(void*) = nullptr;
  void* (*BIO_new_mem_buf)(const void*, int) = nullptr;
  int (*BIO_free)(void*) = nullptr;
  void* (*PEM_read_bio_X509)(void*, void*, void*, void*) = nullptr;
  void* (*PEM_read_bio_PrivateKey)(void*, void*, void*, void*) = nullptr;
  int (*X509_STORE_add_cert)(void*, void*) = nullptr;
  void (*X509_free)(void*) = nullptr;
  void (*EVP_PKEY_free)(void*) = nullptr;
  void (*ERR_clear_error)() = nullptr;
  unsigned long (*ERR_get_error)() = nullptr;
  void (*ERR_error_string_n)(unsigned long, char*, size_t) = nullptr;
  // libssl
  const void* (*TLS_server_method)() = nullptr;
  void* (*SSL_CTX_new)(const void*) = nullptr;
  void (*SSL_CTX_free)(void*) = nullptr;
  long (*SSL_CTX_ctrl)(void*, int, long, void*) = nullptr;
  int (*SSL_CTX_use_certificate)(void*, void*) = nullptr;
  int (*SSL_CTX_use_PrivateKey)(void*, void*) = nullptr;
  int (*SSL_CTX_check_private_key)(const void*) = nullptr;
  void (*SSL_CTX_set_verify)(void*, int, void*) = nullptr;
  void* (*SSL_CTX_get_cert_store)(const void*) = nullptr;
  void* (*SSL_new)(void*) = nullptr;
  void (*SSL_free)(void*) = nullptr;
  void (*SSL_set_bio)(void*, void*, void*) = nullptr;
  void (*SSL_set_accept_state)(void*) = nullptr;
  int (*SSL_do_handshake)(void*) = nullptr;
  int (*SSL_read)(void*, void*, int) = nullptr;
  int (*SSL_write)(void*, const void*, int) = nullptr;
  int (*SSL_get_error)(const void*, int) = nullptr;
  int (*SSL_shutdown)(void*) = nullptr;
};

TlsApi* tls_api() {
  static TlsApi* api = [] {
    TlsApi* a = new TlsApi();
    // matched pairs only: a 3.x libssl over a 1.1 libcrypto (or the
    // reverse) resolves symbols but corrupts state
    const char* pairs[][2] = {{"libssl.so.3", "libcrypto.so.3"},
                              {"libssl.so.1.1", "libcrypto.so.1.1"},
                              {"libssl.so", "libcrypto.so"}};
    void* hs = nullptr;
    void* hc = nullptr;
    for (auto& p : pairs) {
      hc = dlopen(p[1], RTLD_NOW | RTLD_GLOBAL);
      if (hc == nullptr) continue;
      hs = dlopen(p[0], RTLD_NOW | RTLD_GLOBAL);
      if (hs != nullptr) break;
    }
    if (hs == nullptr || hc == nullptr) {
      a->err = "libssl/libcrypto not found (tried .so.3, .so.1.1, .so)";
      return a;
    }
    const char* missing = nullptr;
    auto need = [&](void* h, const char* name) -> void* {
      void* p = dlsym(h, name);
      if (p == nullptr && missing == nullptr) missing = name;
      return p;
    };
#define TLS_SYM(handle, name) \
  a->name = reinterpret_cast<decltype(a->name)>(need(handle, #name))
    TLS_SYM(hc, BIO_new);
    TLS_SYM(hc, BIO_s_mem);
    TLS_SYM(hc, BIO_write);
    TLS_SYM(hc, BIO_read);
    TLS_SYM(hc, BIO_ctrl_pending);
    TLS_SYM(hc, BIO_new_mem_buf);
    TLS_SYM(hc, BIO_free);
    TLS_SYM(hc, PEM_read_bio_X509);
    TLS_SYM(hc, PEM_read_bio_PrivateKey);
    TLS_SYM(hc, X509_STORE_add_cert);
    TLS_SYM(hc, X509_free);
    TLS_SYM(hc, EVP_PKEY_free);
    TLS_SYM(hc, ERR_clear_error);
    TLS_SYM(hc, ERR_get_error);
    TLS_SYM(hc, ERR_error_string_n);
    TLS_SYM(hs, TLS_server_method);
    TLS_SYM(hs, SSL_CTX_new);
    TLS_SYM(hs, SSL_CTX_free);
    TLS_SYM(hs, SSL_CTX_ctrl);
    TLS_SYM(hs, SSL_CTX_use_certificate);
    TLS_SYM(hs, SSL_CTX_use_PrivateKey);
    TLS_SYM(hs, SSL_CTX_check_private_key);
    TLS_SYM(hs, SSL_CTX_set_verify);
    TLS_SYM(hs, SSL_CTX_get_cert_store);
    TLS_SYM(hs, SSL_new);
    TLS_SYM(hs, SSL_free);
    TLS_SYM(hs, SSL_set_bio);
    TLS_SYM(hs, SSL_set_accept_state);
    TLS_SYM(hs, SSL_do_handshake);
    TLS_SYM(hs, SSL_read);
    TLS_SYM(hs, SSL_write);
    TLS_SYM(hs, SSL_get_error);
    TLS_SYM(hs, SSL_shutdown);
#undef TLS_SYM
    if (missing != nullptr) {
      a->err = std::string("libssl symbol missing: ") + missing;
      return a;
    }
    a->ktls = dlsym(hs, "SSL_sendfile") != nullptr;
    a->ok = true;
    return a;
  }();
  return api;
}

thread_local char g_tls_err[256] = {0};

void set_tls_err(const char* what) {
  TlsApi* a = tls_api();
  unsigned long e = a->ok ? a->ERR_get_error() : 0;
  if (e != 0) {
    char ebuf[160];
    a->ERR_error_string_n(e, ebuf, sizeof(ebuf));
    snprintf(g_tls_err, sizeof(g_tls_err), "%s: %s", what, ebuf);
    while (a->ERR_get_error() != 0) {  // drain the queue for next time
    }
  } else {
    snprintf(g_tls_err, sizeof(g_tls_err), "%s", what);
  }
}

// One SSL_CTX "generation". Hot rotation swaps the Front's current
// generation under a mutex taken only at accept/swap time; every live
// connection pins the generation it handshook under via a refcount, so
// established connections DRAIN on the old identity while new accepts
// see the new one — exactly certs.py's SNI-callback contract.
struct TlsCtx {
  void* ctx = nullptr;  // SSL_CTX*
  std::atomic<long> refs{1};
};

void tls_ctx_unref(TlsCtx* t) {
  if (t != nullptr && t->refs.fetch_add(-1, std::memory_order_acq_rel) == 1) {
    tls_api()->SSL_CTX_free(t->ctx);
    delete t;
  }
}

// ------------------------------------------------------------------- conn --

struct PendingResp {
  uint64_t id;
  bool done = false;
  bool close_after = false;
  bool http10 = false;  // captured at parse time: the conn's per-request
                        // state resets before the completion arrives
  std::string wire;     // full head+body, ready to write
};

struct Conn {
  int fd;
  std::string in;
  size_t off = 0;  // parse cursor into `in`
  std::string out;
  size_t out_off = 0;
  // connection-abuse hardening (round 13): last byte activity and the
  // start of the oldest incomplete request (0 = none pending). The
  // idle timeout reaps silent keep-alive connections; the read timeout
  // bounds how long ONE request may take to arrive in full, which is
  // what defeats slowloris drips (each drip refreshes last_activity
  // but never completes the request).
  int64_t last_activity_ns = 0;
  int64_t request_start_ns = 0;
  // TLS termination (round 20): non-null ssl marks a TLS connection.
  // The handshake deadline anchors at accept_ns and is NEVER refreshed
  // by arriving bytes — a ClientHello dripped one byte at a time is the
  // slowloris shape moved down one layer, and it must die on the same
  // absolute clock no matter how diligently it drips.
  void* ssl = nullptr;   // SSL* (owns both BIOs once set_bio'd)
  void* rbio = nullptr;  // socket→SSL ciphertext
  void* wbio = nullptr;  // SSL→socket ciphertext
  TlsCtx* tls = nullptr;           // generation pinned at accept
  std::string enc_out;             // encrypted bytes awaiting send()
  size_t enc_off = 0;
  int64_t accept_ns = 0;           // handshake-arrival deadline anchor
  bool tls_established = false;    // SSL_do_handshake returned 1
  bool tls_shutdown_sent = false;  // close_notify already queued
  bool tls_fail_injected = false;  // `tls.handshake` failpoint armed
  bool reject_after_handshake = false;  // over-cap: 503 once readable
  bool want_write = false;
  bool closing = false;       // stop parsing further requests
  bool flush_queued = false;  // dedup marker within one process_comps pass
  std::deque<std::unique_ptr<PendingResp>> pipeline;

  // per-request parse state
  int state = 0;  // 0=head 1=body-cl 2=body-chunked
  bool http10 = false, req_close = false, chunked = false;
  int64_t content_length = -1;
  size_t body_start = 0;
  std::string chunk_body;
  int ch_state = 0;  // 0=size-line 1=data 2=data-crlf 3=trailer
  size_t ch_remaining = 0;
  int64_t total_body = 0;
  int route = -1;  // 0 validate 1 raw 2 audit; -1 miss; -2 method miss
  std::string policy_id;
  // incoming W3C traceparent header, carried verbatim across the ring
  // so Python parents the request's spans to the webhook caller's trace
  std::string traceparent;
  bool expect_continue = false;
};

// ------------------------------------------------------------------ loops --

struct Front;

struct Loop {
  Front* front;
  int idx;
  int ep = -1;
  int comp_efd = -1;
  std::thread thr;
  SubRing ring;
  CompStack comps;
  std::unordered_map<int, Conn*> conns;
  std::unordered_map<uint64_t, std::pair<Conn*, PendingResp*>> pending;
  uint64_t next_seq = 1;
  int64_t last_sweep_ns = 0;  // timeout sweep cadence (~1 s)
  bool listen_registered = false;
  // cached Date header value, rebuilt once per second
  time_t date_sec = 0;
  char date_buf[64] = {0};

  explicit Loop(size_t ring_bits) : ring(ring_bits) {}
};

constexpr int STAT_N = 24;

struct Front {
  int listen_fd;
  int n_loops;
  int64_t max_body;
  std::string server_hdr;
  std::vector<std::unique_ptr<Loop>> loops;
  StaticResp statics[ST_MAX];
  int sub_efd = -1;  // wakes the Python drainer
  std::atomic<bool> stop{false};
  std::atomic<bool> stop_accepting{false};
  // connection-abuse hardening knobs (httpfront_configure; 0 = off)
  std::atomic<int64_t> idle_timeout_ns{0};
  std::atomic<int64_t> read_timeout_ns{0};
  std::atomic<int64_t> max_conns{0};
  std::atomic<int64_t> live_conns{0};
  // TLS (round 20): the current SSL_CTX generation for NEW accepts.
  // The mutex is taken at accept and swap only — accept-rate, not
  // per-byte — so rotation never contends with the serving byte path.
  std::mutex tls_mu;
  TlsCtx* tls_current = nullptr;  // guarded by tls_mu
  std::atomic<int64_t> tls_handshake_timeout_ns{0};
  // `tls.handshake` failpoint: -1 = fail every handshake, n>0 = fail
  // the next n, 0 = disarmed
  std::atomic<long> tls_fail_next{0};
  std::atomic<int64_t> stats[STAT_N] = {};
};

enum {
  S_CONNS = 0, S_REQUESTS, S_PARSED, S_FALLBACKS, S_NATIVE_SER, S_PY_SER,
  S_RING_FULL, S_BAD_REQ, S_ROUTE_MISS, S_OVERSIZE, S_BYTES_IN, S_BYTES_OUT,
  S_FRAMING_NS, S_OUTSTANDING, S_DISCONNECTS, S_IDLE_CLOSES, S_CONN_CAP,
  // TLS termination (round 20) — fills the STAT_N=24 budget exactly
  S_TLS_CONNS, S_TLS_HS_OK, S_TLS_HS_FAIL, S_TLS_HS_TIMEOUT,
  S_TLS_HS_DISCONNECT, S_TLS_FAIL_INJECTED, S_TLS_CLEAN_CLOSES,
};
static_assert(S_TLS_CLEAN_CLOSES == STAT_N - 1,
              "stats enum must fit the ABI's fixed STAT_N slots");

void wake_fd(int fd) {
  uint64_t one = 1;
  ssize_t r = write(fd, &one, sizeof(one));
  (void)r;
}

const char* date_header(Loop* lp) {
  time_t now = time(nullptr);
  if (now != lp->date_sec) {
    lp->date_sec = now;
    tm g;
    gmtime_r(&now, &g);
    strftime(lp->date_buf, sizeof(lp->date_buf),
             "%a, %d %b %Y %H:%M:%S GMT", &g);
  }
  return lp->date_buf;
}

void build_head(Loop* lp, std::string& w, int status,
                const std::string& content_type, size_t body_len,
                int retry_after, const std::string& extra, bool http10,
                bool close_conn) {
  char line[160];
  int n = snprintf(line, sizeof(line), "HTTP/1.%c %d %s\r\n",
                   http10 ? '0' : '1', status, reason_of(status));
  w.append(line, (size_t)n);
  w += "Content-Type: ";
  w += content_type;
  w += "\r\n";
  w += extra;
  if (retry_after > 0) {
    n = snprintf(line, sizeof(line), "Retry-After: %d\r\n", retry_after);
    w.append(line, (size_t)n);
  }
  n = snprintf(line, sizeof(line), "Content-Length: %zu\r\n", body_len);
  w.append(line, (size_t)n);
  w += "Date: ";
  w += date_header(lp);
  w += "\r\nServer: ";
  w += lp->front->server_hdr;
  w += "\r\n";
  if (close_conn && !http10) w += "Connection: close\r\n";
  w += "\r\n";
}

void fill_response(Loop* lp, PendingResp* pr, int status,
                   const std::string& content_type, const std::string& body,
                   int retry_after, const std::string& extra) {
  pr->wire.clear();
  build_head(lp, pr->wire, status, content_type, body.size(), retry_after,
             extra, pr->http10, pr->close_after);
  pr->wire += body;
  pr->done = true;
}

void conn_destroy(Loop* lp, Conn* c, bool midbody) {
  for (auto& pr : c->pipeline) lp->pending.erase(pr->id);
  lp->conns.erase(c->fd);
  epoll_ctl(lp->ep, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  lp->front->live_conns.fetch_add(-1, std::memory_order_relaxed);
  if (midbody)
    lp->front->stats[S_DISCONNECTS].fetch_add(1, std::memory_order_relaxed);
  if (c->ssl != nullptr) tls_api()->SSL_free(c->ssl);  // frees both BIOs
  if (c->tls != nullptr) tls_ctx_unref(c->tls);
  delete c;
}

void tls_flush(Loop* lp, Conn* c);

// Server-initiated clean close of a TLS connection: queue close_notify,
// best-effort flush it (one non-blocking send — the alert is ~2 dozen
// bytes), then tear down. Used by every path that CHOOSES to close
// (closing-complete, idle reap, conn-cap 503) so well-behaved clients
// see an orderly TLS EOF instead of a truncation-looking RST.
void tls_graceful_destroy(Loop* lp, Conn* c) {
  TlsApi* a = tls_api();
  if (!c->tls_shutdown_sent) {
    c->tls_shutdown_sent = true;
    // count at decision time, before the alert hits the wire: the
    // peer's clean-EOF observation must never precede the counter
    lp->front->stats[S_TLS_CLEAN_CLOSES].fetch_add(
        1, std::memory_order_relaxed);
    a->SSL_shutdown(c->ssl);
    while (a->BIO_ctrl_pending(c->wbio) > 0) {
      char buf[4096];
      int n = a->BIO_read(c->wbio, buf, sizeof(buf));
      if (n <= 0) break;
      c->enc_out.append(buf, (size_t)n);
    }
    if (c->enc_off < c->enc_out.size()) {
      ssize_t r = send(c->fd, c->enc_out.data() + c->enc_off,
                       c->enc_out.size() - c->enc_off, MSG_NOSIGNAL);
      if (r > 0)
        lp->front->stats[S_BYTES_OUT].fetch_add(r, std::memory_order_relaxed);
    }
  }
  conn_destroy(lp, c, false);
}

// flush completed head-of-line responses into the socket
void conn_flush(Loop* lp, Conn* c) {
  while (!c->pipeline.empty() && c->pipeline.front()->done) {
    c->out += c->pipeline.front()->wire;
    if (c->pipeline.front()->close_after) c->closing = true;
    c->pipeline.pop_front();
  }
  if (c->ssl != nullptr) {
    tls_flush(lp, c);
    return;
  }
  while (c->out_off < c->out.size()) {
    ssize_t n = send(c->fd, c->out.data() + c->out_off,
                     c->out.size() - c->out_off, MSG_NOSIGNAL);
    if (n > 0) {
      c->out_off += (size_t)n;
      lp->front->stats[S_BYTES_OUT].fetch_add(n, std::memory_order_relaxed);
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (!c->want_write) {
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.fd = c->fd;
        epoll_ctl(lp->ep, EPOLL_CTL_MOD, c->fd, &ev);
        c->want_write = true;
      }
      return;
    }
    conn_destroy(lp, c, false);
    return;
  }
  c->out.clear();
  c->out_off = 0;
  if (c->want_write) {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = c->fd;
    epoll_ctl(lp->ep, EPOLL_CTL_MOD, c->fd, &ev);
    c->want_write = false;
  }
  if (c->closing && c->pipeline.empty()) conn_destroy(lp, c, false);
}

// TLS half of conn_flush: encrypt pending plaintext through SSL_write,
// drain the write BIO, and push ciphertext to the socket with the same
// EAGAIN→EPOLLOUT discipline as the plaintext path. c->out/c->out_off
// hold PLAINTEXT not yet consumed by SSL_write; enc_out/enc_off hold
// ciphertext not yet accepted by the kernel.
void tls_flush(Loop* lp, Conn* c) {
  TlsApi* a = tls_api();
  Front* f = lp->front;
  if (c->tls_established && !c->tls_shutdown_sent) {
    while (c->out_off < c->out.size()) {
      size_t chunk = c->out.size() - c->out_off;
      if (chunk > (1u << 20)) chunk = 1u << 20;
      a->ERR_clear_error();
      int n = a->SSL_write(c->ssl, c->out.data() + c->out_off, (int)chunk);
      if (n <= 0) break;  // WANT_READ mid-rekey: retry after next read
      c->out_off += (size_t)n;
    }
    if (c->out_off >= c->out.size()) {
      c->out.clear();
      c->out_off = 0;
    }
  }
  while (a->BIO_ctrl_pending(c->wbio) > 0) {
    char buf[16384];
    int n = a->BIO_read(c->wbio, buf, sizeof(buf));
    if (n <= 0) break;
    c->enc_out.append(buf, (size_t)n);
  }
  while (c->enc_off < c->enc_out.size()) {
    ssize_t n = send(c->fd, c->enc_out.data() + c->enc_off,
                     c->enc_out.size() - c->enc_off, MSG_NOSIGNAL);
    if (n > 0) {
      c->enc_off += (size_t)n;
      f->stats[S_BYTES_OUT].fetch_add(n, std::memory_order_relaxed);
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (!c->want_write) {
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.fd = c->fd;
        epoll_ctl(lp->ep, EPOLL_CTL_MOD, c->fd, &ev);
        c->want_write = true;
      }
      return;
    }
    conn_destroy(lp, c, false);
    return;
  }
  c->enc_out.clear();
  c->enc_off = 0;
  if (c->want_write) {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = c->fd;
    epoll_ctl(lp->ep, EPOLL_CTL_MOD, c->fd, &ev);
    c->want_write = false;
  }
  if (c->closing && c->pipeline.empty() && c->out_off >= c->out.size())
    tls_graceful_destroy(lp, c);
}

// queue an immediate (statically known) response, preserving pipeline order
void respond_static_idx(Loop* lp, Conn* c, int slot, int64_t actual_body) {
  Front* f = lp->front;
  const StaticResp& st = f->statics[slot];
  auto pr = std::make_unique<PendingResp>();
  pr->id = 0;
  pr->close_after = c->req_close;
  pr->http10 = c->http10;
  std::string body = st.body;
  if (slot == ST_413 && body.find("%lld") != std::string::npos) {
    char tmp[256];
    snprintf(tmp, sizeof(tmp), body.c_str(), (long long)actual_body);
    body = tmp;
  }
  fill_response(lp, pr.get(), st.status, st.content_type, body, 0,
                st.extra);
  c->pipeline.push_back(std::move(pr));
}

// hand the parsed request to Python via the submission ring
void submit_request(Loop* lp, Conn* c, const std::string& body,
                    int64_t t_first) {
  Front* f = lp->front;
  int64_t t0 = now_ns();
  uint64_t id = ((uint64_t)(lp->idx & 0x7F) << 56) | lp->next_seq++;
  auto pr = std::make_unique<PendingResp>();
  pr->id = id;
  pr->close_after = c->req_close;
  pr->http10 = c->http10;
  uint8_t* rec = nullptr;
  if (c->route == 1) {  // validate_raw: Python parses the raw body
    rec = build_record(id, K_RAW, false, c->policy_id, "", "", "", "",
                       c->traceparent, body, t_first, t0, now_ns());
  } else {
    CanonResult cr;
    // ensure_ascii escaping can expand multibyte UTF-8 up to 3x: a
    // canonical payload larger than max_body (or any field beyond the
    // u16 wire-length fields) ships the RAW body instead — fallback
    // records are bounded by max_body, so they always fit the Python
    // drainer's poll buffer and the record header
    bool canon_ok = canon_admission_review(body.data(), body.size(), cr) &&
                    cr.payload.size() <= (size_t)f->max_body &&
                    cr.uid.size() <= 0xFFFF && cr.ns.size() <= 0xFFFF &&
                    cr.op.size() <= 0xFFFF && cr.gvk.size() <= 0xFFFF;
    if (canon_ok) {
      f->stats[S_PARSED].fetch_add(1, std::memory_order_relaxed);
      rec = build_record(id, c->route == 2 ? K_AUDIT : K_VALIDATE, cr.has_ns,
                         c->policy_id, cr.uid, cr.ns, cr.op, cr.gvk,
                         c->traceparent, cr.payload, t_first, t0, now_ns());
    } else {
      f->stats[S_FALLBACKS].fetch_add(1, std::memory_order_relaxed);
      rec = build_record(id, c->route == 2 ? K_AUDIT_FB : K_VALIDATE_FB,
                         false, c->policy_id, "", "", "", "",
                         c->traceparent, body, t_first, t0, now_ns());
    }
  }
  if (rec == nullptr) {
    // a field overflowed its wire slot (build_record refuses to
    // truncate): answer 400 in-band — the request is malformed, and a
    // silent drop would read as a network fault
    f->stats[S_BAD_REQ].fetch_add(1, std::memory_order_relaxed);
    PendingResp* raw_pr = pr.get();
    c->pipeline.push_back(std::move(pr));
    const StaticResp& st = f->statics[ST_400];
    fill_response(lp, raw_pr, st.status, st.content_type, st.body, 0,
                  st.extra);
    f->stats[S_FRAMING_NS].fetch_add(now_ns() - t0,
                                     std::memory_order_relaxed);
    return;
  }
  int pushed = lp->ring.push(rec);
  if (pushed < 0) {
    free(rec);
    f->stats[S_RING_FULL].fetch_add(1, std::memory_order_relaxed);
    PendingResp* raw_pr = pr.get();
    c->pipeline.push_back(std::move(pr));
    const StaticResp& st = f->statics[ST_503];
    fill_response(lp, raw_pr, st.status, st.content_type, st.body, 0,
                  st.extra);
    f->stats[S_FRAMING_NS].fetch_add(now_ns() - t0,
                                     std::memory_order_relaxed);
    return;
  }
  f->stats[S_OUTSTANDING].fetch_add(1, std::memory_order_relaxed);
  lp->pending.emplace(id, std::make_pair(c, pr.get()));
  c->pipeline.push_back(std::move(pr));
  f->stats[S_FRAMING_NS].fetch_add(now_ns() - t0, std::memory_order_relaxed);
  (void)pushed;  // the drainer polls the rings at 1 ms ticks — no wake
                 // syscall per request (see push_comp for the rationale)
}

// finish the current request: route it, reset per-request parse state
void finish_request(Loop* lp, Conn* c, const std::string& body) {
  Front* f = lp->front;
  f->stats[S_REQUESTS].fetch_add(1, std::memory_order_relaxed);
  // flight recorder: the read-timeout clock doubles as the request's
  // arrival stamp (first byte of an incomplete request) — capture it
  // before the reset below zeroes it
  int64_t t_first = c->request_start_ns;
  // a request ARRIVED in full: reset the read-timeout clock so a
  // healthy client pipelining back-to-back requests (whose buffer
  // never drains to a clean boundary) is not reaped mid-stream; the
  // post-parse bookkeeping re-arms it from NOW for any partial tail
  c->request_start_ns = 0;
  // route misses FIRST: aiohttp 404/405s without ever reading the body,
  // so an oversized body on an unknown route must still answer 404
  if (c->route == -1) {
    f->stats[S_ROUTE_MISS].fetch_add(1, std::memory_order_relaxed);
    respond_static_idx(lp, c, ST_404, 0);
  } else if (c->route == -2) {
    f->stats[S_ROUTE_MISS].fetch_add(1, std::memory_order_relaxed);
    respond_static_idx(lp, c, ST_405, 0);
  } else if ((int64_t)body.size() > f->max_body ||
             c->total_body > f->max_body) {
    f->stats[S_OVERSIZE].fetch_add(1, std::memory_order_relaxed);
    respond_static_idx(lp, c, ST_413,
                       std::max((int64_t)body.size(), c->total_body));
  } else {
    submit_request(lp, c, body, t_first);
  }
  if (c->req_close || c->http10) c->closing = true;  // parse no further
  c->state = 0;
  c->http10 = false;
  c->req_close = false;
  c->chunked = false;
  c->content_length = -1;
  c->chunk_body.clear();
  c->ch_state = 0;
  c->ch_remaining = 0;
  c->total_body = 0;
  c->route = -1;
  c->policy_id.clear();
  c->traceparent.clear();
  c->expect_continue = false;
}

void bad_request(Loop* lp, Conn* c) {
  Front* f = lp->front;
  f->stats[S_BAD_REQ].fetch_add(1, std::memory_order_relaxed);
  f->stats[S_REQUESTS].fetch_add(1, std::memory_order_relaxed);
  c->req_close = true;
  respond_static_idx(lp, c, ST_400, 0);
  c->closing = true;
}

// case-insensitive ASCII compare
bool ieq(const char* a, size_t alen, const char* b) {
  size_t blen = strlen(b);
  if (alen != blen) return false;
  for (size_t i = 0; i < alen; i++)
    if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i]))
      return false;
  return true;
}

// Parse as many complete requests as the input buffer holds. Returns false
// when the connection was destroyed.
// graftcheck: wire-input
bool conn_parse(Loop* lp, Conn* c) {
  Front* f = lp->front;
  constexpr size_t MAX_HEAD = 64 * 1024;
  for (;;) {
    if (c->closing) break;  // drop pipelined bytes after a close-marked
                            // request — but still flush responses below
    const char* base = c->in.data();
    size_t avail = c->in.size() - c->off;
    if (c->state == 0) {
      if (avail == 0) break;
      const char* head = base + c->off;
      const char* hdr_end =
          (const char*)memmem(head, avail, "\r\n\r\n", 4);
      if (hdr_end == nullptr) {
        if (avail > MAX_HEAD) { bad_request(lp, c); continue; }
        break;  // need more bytes
      }
      int64_t t0 = now_ns();
      size_t head_len = (size_t)(hdr_end - head) + 4;
      // request line
      const char* eol = (const char*)memchr(head, '\r', head_len);
      const char* sp1 = (const char*)memchr(head, ' ', (size_t)(eol - head));
      if (sp1 == nullptr) { bad_request(lp, c); continue; }
      const char* sp2 = (const char*)memchr(
          sp1 + 1, ' ', (size_t)(eol - sp1 - 1));
      if (sp2 == nullptr) { bad_request(lp, c); continue; }
      std::string method(head, (size_t)(sp1 - head));
      std::string path(sp1 + 1, (size_t)(sp2 - sp1 - 1));
      std::string version(sp2 + 1, (size_t)(eol - sp2 - 1));
      bool ok_method = true;
      for (char ch : method)
        if (!(ch >= 'A' && ch <= 'Z')) ok_method = false;
      if (method.empty() || !ok_method) { bad_request(lp, c); continue; }
      if (version == "HTTP/1.0") c->http10 = true;
      else if (version != "HTTP/1.1") { bad_request(lp, c); continue; }
      // headers
      const char* hp = eol + 2;
      bool have_te = false;
      bool keep_alive_hdr = false;
      while (hp < hdr_end + 2) {
        const char* he = (const char*)memchr(
            hp, '\r', (size_t)(hdr_end + 2 - hp));
        if (he == nullptr || he == hp) break;
        const char* colon = (const char*)memchr(hp, ':', (size_t)(he - hp));
        if (colon == nullptr) { hp = he + 2; continue; }
        const char* v = colon + 1;
        while (v < he && (*v == ' ' || *v == '\t')) v++;
        size_t nlen = (size_t)(colon - hp), vlen = (size_t)(he - v);
        if (ieq(hp, nlen, "content-length")) {
          // duplicate Content-Length is a request-smuggling vector and
          // llhttp (the Python frontend's parser) rejects it — parity
          // demands a 400, not last-wins
          if (c->content_length >= 0) { bad_request(lp, c); goto next_iter; }
          char tmp[24];
          if (vlen == 0 || vlen >= sizeof(tmp)) { bad_request(lp, c); goto next_iter; }
          memcpy(tmp, v, vlen);
          tmp[vlen] = 0;
          char* endp = nullptr;
          long long cl = strtoll(tmp, &endp, 10);
          if (*endp != 0 || cl < 0) { bad_request(lp, c); goto next_iter; }
          c->content_length = cl;
        } else if (ieq(hp, nlen, "transfer-encoding")) {
          have_te = true;
          if (ieq(v, vlen, "chunked")) c->chunked = true;
        } else if (ieq(hp, nlen, "connection")) {
          if (ieq(v, vlen, "close")) c->req_close = true;
          else if (ieq(v, vlen, "keep-alive")) keep_alive_hdr = true;
        } else if (ieq(hp, nlen, "expect")) {
          if (ieq(v, vlen, "100-continue")) c->expect_continue = true;
        } else if (ieq(hp, nlen, "traceparent")) {
          // carried verbatim but GATED to printable ASCII (bounded: the
          // W3C form is 55 chars; a malformed oversize value is
          // dropped, never truncated into something that parses).
          // HTTP/1.1 field values legally carry obs-text bytes
          // 0x80-0xFF — those must never cross the ring, or Python's
          // strict decode would kill the drainer on attacker input.
          bool clean = vlen <= 128;
          for (size_t ti = 0; clean && ti < vlen; ti++) {
            unsigned char ch = (unsigned char)v[ti];
            if (ch < 0x20 || ch > 0x7e) clean = false;
          }
          if (clean) c->traceparent.assign(v, vlen);
        }
        hp = he + 2;
      }
      if (have_te && !c->chunked) { bad_request(lp, c); continue; }
      if (c->chunked && c->content_length >= 0) {
        bad_request(lp, c);  // CL + chunked: the other smuggling vector
        continue;
      }
      (void)keep_alive_hdr;  // HTTP/1.0 closes either way (finish_request)
      // routing (query strings stripped): one segment is a policy id,
      // two non-empty segments are "tenant/policy" (round-16 tenant
      // routing — the Python sink resolves the tenant and answers the
      // same 404 body as the aiohttp router for unknown names)
      size_t q = path.find('?');
      if (q != std::string::npos) path.resize(q);
      c->route = -1;
      const struct { const char* prefix; int route; } routes[] = {
          {"/validate_raw/", 1}, {"/validate/", 0}, {"/audit/", 2}};
      for (const auto& r : routes) {
        size_t pl = strlen(r.prefix);
        if (path.compare(0, pl, r.prefix) == 0 && path.size() > pl) {
          size_t slash = path.find('/', pl);
          bool one_seg = slash == std::string::npos;
          bool two_seg = !one_seg && slash > pl && slash + 1 < path.size() &&
                         path.find('/', slash + 1) == std::string::npos;
          if (one_seg || two_seg) {
            c->route = r.route;
            c->policy_id = path.substr(pl);
            break;
          }
        }
      }
      if (c->route >= 0 && c->policy_id.size() > 4096) {
        // a policy id is a (tenant-qualified) resource name — K8s names
        // top out at 253 chars. A multi-KB segment is abuse, and the
        // record header's u16 length slot must never be asked to carry
        // anything near the 64 KiB header cap: unknown-name 404, same
        // as the aiohttp router.
        c->route = -1;
        c->policy_id.clear();
      }
      if (c->route >= 0 && method != "POST") c->route = -2;
      c->off += head_len;
      f->stats[S_FRAMING_NS].fetch_add(now_ns() - t0,
                                       std::memory_order_relaxed);
      if (c->expect_continue && c->pipeline.empty() &&
          c->out.size() == c->out_off) {
        // interim response ONLY when nothing earlier is pending on this
        // connection: appending it with responses outstanding would
        // jump the pipeline's ordered slots. A pipelining client that
        // sent Expect alongside later requests already pushed its body;
        // RFC 7231 §5.1.1 forbids it waiting indefinitely for the 100.
        c->out += c->http10 ? "HTTP/1.0 100 Continue\r\n\r\n"
                            : "HTTP/1.1 100 Continue\r\n\r\n";
      }
      if (c->chunked) {
        c->state = 2;
      } else if (c->content_length > 0) {
        c->state = 1;
        c->total_body = c->content_length;
      } else {
        std::string empty;
        finish_request(lp, c, empty);
      }
      continue;
    }
    if (c->state == 1) {  // content-length body
      size_t need = (size_t)c->content_length;
      if (c->content_length > f->max_body) {
        // oversized declared body: drain from the wire WITHOUT buffering
        // (aiohttp keeps the connection usable after its 413), but bound
        // the drain — a multi-GB declaration answers 413 and closes
        if (c->content_length > f->max_body * 8 ||
            c->content_length > (int64_t)(64u << 20)) {
          c->req_close = true;
          std::string empty;
          finish_request(lp, c, empty);  // total_body carries the size
          continue;
        }
        if (c->ch_remaining == 0) c->ch_remaining = need;
        size_t take = avail < c->ch_remaining ? avail : c->ch_remaining;
        c->off += take;
        c->ch_remaining -= take;
        if (c->ch_remaining > 0) break;  // keep draining
        std::string empty;
        finish_request(lp, c, empty);
        continue;
      }
      if (avail < need) break;
      std::string body(base + c->off, need);
      c->off += need;
      finish_request(lp, c, body);
      continue;
    }
    // chunked body: size line -> data -> CRLF, 0-chunk then trailer
    // lines until an empty one. Decoded bytes accumulate in chunk_body
    // (capped just past max_body; the 413 text still needs the TOTAL).
    {
      bool fatal = false;
      for (;;) {
        const char* p = c->in.data() + c->off;
        const char* end = c->in.data() + c->in.size();
        if (c->ch_state == 0) {  // chunk-size line
          const char* nl =
              (const char*)memmem(p, (size_t)(end - p), "\r\n", 2);
          if (nl == nullptr) break;
          std::string sz(p, (size_t)(nl - p));
          size_t semi = sz.find(';');
          if (semi != std::string::npos) sz.resize(semi);
          char* endp = nullptr;
          unsigned long long v = strtoull(sz.c_str(), &endp, 16);
          if (endp == sz.c_str() || *endp != 0) { fatal = true; break; }
          c->off = (size_t)(nl + 2 - c->in.data());
          if (v == 0) { c->ch_state = 3; continue; }
          c->ch_remaining = (size_t)v;
          c->ch_state = 1;
          continue;
        }
        if (c->ch_state == 1) {  // chunk data
          size_t have = (size_t)(end - p);
          if (have == 0) break;
          size_t take = have < c->ch_remaining ? have : c->ch_remaining;
          if ((int64_t)(c->chunk_body.size() + take) <=
              lp->front->max_body + 4096)
            c->chunk_body.append(p, take);
          c->total_body += (int64_t)take;
          if (c->total_body > lp->front->max_body * 8 &&
              c->total_body > (int64_t)(64u << 20)) {
            fatal = true;  // unbounded chunk stream: stop counting, close
            break;
          }
          c->ch_remaining -= take;
          c->off += take;
          if (c->ch_remaining > 0) break;  // need more data
          c->ch_state = 2;
          continue;
        }
        if (c->ch_state == 2) {  // CRLF terminating the chunk data
          if (end - p < 2) break;
          if (p[0] != '\r' || p[1] != '\n') { fatal = true; break; }
          c->off += 2;
          c->ch_state = 0;
          continue;
        }
        // ch_state == 3: trailer lines until an empty one
        const char* nl =
            (const char*)memmem(p, (size_t)(end - p), "\r\n", 2);
        if (nl == nullptr) break;
        bool empty = (nl == p);
        c->off = (size_t)(nl + 2 - c->in.data());
        if (empty) {
          std::string body;
          body.swap(c->chunk_body);
          finish_request(lp, c, body);
          c->ch_state = 0;
          break;
        }
        continue;
      }
      if (fatal) { bad_request(lp, c); continue; }
      if (c->state == 2) break;  // body still incomplete: need more bytes
      continue;  // request finished: parse the next pipelined one
    }
  next_iter:
    continue;
  }
  // read-timeout bookkeeping: a request is "pending" while a body is
  // incomplete (state != 0) or a partial head sits unconsumed — the
  // clock starts at the first such observation, each completed request
  // zeroes it (finish_request), and it clears when the buffer drains to
  // a clean boundary; slowloris drips keep ONE request incomplete, so
  // their clock is never reset
  bool pending_req =
      !c->closing && (c->state != 0 || c->off < c->in.size());
  if (pending_req) {
    if (c->request_start_ns == 0) c->request_start_ns = now_ns();
  } else {
    c->request_start_ns = 0;
  }
  // compact the input buffer
  if (c->off == c->in.size()) {
    c->in.clear();
    c->off = 0;
  } else if (c->off > 1 << 16) {
    c->in.erase(0, c->off);
    c->off = 0;
  }
  conn_flush(lp, c);
  return true;
}

// --------------------------------------------------------- loop machinery --

// best-effort in-band reject for connections over the cap: one
// non-blocking send of a canned 503, then close — a silent close would
// read as a network fault, not an explicit server decision
void reject_over_cap(Front* f, int fd) {
  static const char kBody[] =
      "{\"message\": \"connection limit reached; retry later\", "
      "\"status\": 503}";
  char wire[256];
  int n = snprintf(wire, sizeof(wire),
                   "HTTP/1.1 503 Service Unavailable\r\n"
                   "Content-Type: application/json; charset=utf-8\r\n"
                   "Content-Length: %zu\r\nRetry-After: 1\r\n"
                   "Connection: close\r\n\r\n%s",
                   sizeof(kBody) - 1, kBody);
  // count BEFORE the send: the client's read of this 503 (or the EOF
  // from close) must never win a race against the counter — tests and
  // operators read stats the instant the rejection is observable
  f->stats[S_CONN_CAP].fetch_add(1, std::memory_order_relaxed);
  ssize_t r = send(fd, wire, (size_t)n, MSG_NOSIGNAL);
  (void)r;
  close(fd);
}

void do_accept(Loop* lp) {
  Front* f = lp->front;
  for (;;) {
    int fd = accept4(f->listen_fd, nullptr, nullptr,
                     SOCK_NONBLOCK | SOCK_CLOEXEC);
    if (fd < 0) break;  // EAGAIN / another loop won the race
    // pin the CURRENT TLS generation before the cap decision: an
    // over-cap TLS accept must still handshake, because its in-band 503
    // is unreadable until the session keys exist
    TlsCtx* tctx = nullptr;
    {
      std::lock_guard<std::mutex> g(f->tls_mu);
      if (f->tls_current != nullptr) {
        f->tls_current->refs.fetch_add(1, std::memory_order_relaxed);
        tctx = f->tls_current;
      }
    }
    int64_t cap = f->max_conns.load(std::memory_order_relaxed);
    int64_t live = f->live_conns.load(std::memory_order_relaxed);
    bool over_cap = cap > 0 && live >= cap;
    if (over_cap && tctx == nullptr) {
      reject_over_cap(f, fd);
      continue;
    }
    if (over_cap && live >= cap + 64) {
      // the close_notify-clean 503 needs a live handshake, which costs
      // state — past a bounded grace pool the only safe answer to a
      // connection flood is the plain close the cap exists to deliver
      close(fd);
      tls_ctx_unref(tctx);
      f->stats[S_CONN_CAP].fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    Conn* c = new Conn();
    c->fd = fd;
    c->last_activity_ns = now_ns();
    if (tctx != nullptr) {
      TlsApi* a = tls_api();
      void* ssl = a->SSL_new(tctx->ctx);
      void* rb = ssl != nullptr ? a->BIO_new(a->BIO_s_mem()) : nullptr;
      void* wb = rb != nullptr ? a->BIO_new(a->BIO_s_mem()) : nullptr;
      if (wb == nullptr) {
        if (rb != nullptr) a->BIO_free(rb);
        if (ssl != nullptr) a->SSL_free(ssl);
        tls_ctx_unref(tctx);
        close(fd);
        delete c;
        continue;
      }
      a->SSL_set_bio(ssl, rb, wb);  // ssl owns both BIOs from here
      a->SSL_set_accept_state(ssl);
      c->ssl = ssl;
      c->rbio = rb;
      c->wbio = wb;
      c->tls = tctx;
      c->accept_ns = now_ns();
      c->reject_after_handshake = over_cap;
      f->stats[S_TLS_CONNS].fetch_add(1, std::memory_order_relaxed);
      // `tls.handshake` failpoint: claim one injected failure slot
      long fn = f->tls_fail_next.load(std::memory_order_relaxed);
      while (fn != 0) {
        if (fn < 0) {
          c->tls_fail_injected = true;
          break;
        }
        if (f->tls_fail_next.compare_exchange_weak(
                fn, fn - 1, std::memory_order_relaxed)) {
          c->tls_fail_injected = true;
          break;
        }
      }
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    if (epoll_ctl(lp->ep, EPOLL_CTL_ADD, fd, &ev) != 0) {
      close(fd);
      if (c->ssl != nullptr) tls_api()->SSL_free(c->ssl);
      if (c->tls != nullptr) tls_ctx_unref(c->tls);
      delete c;
      continue;
    }
    lp->conns[fd] = c;
    f->live_conns.fetch_add(1, std::memory_order_relaxed);
    f->stats[S_CONNS].fetch_add(1, std::memory_order_relaxed);
  }
}

// TLS read path: pump ciphertext into the read BIO, run the handshake
// state machine until established, then SSL_read plaintext into the
// SAME c->in the plaintext parser consumes — everything downstream of
// the record layer is shared with the plaintext frontend byte for byte.
// graftcheck: wire-input
void tls_conn_read(Loop* lp, Conn* c) {
  Front* f = lp->front;
  TlsApi* a = tls_api();
  char buf[65536];
  c->last_activity_ns = now_ns();
  bool peer_closed = false;
  for (;;) {
    ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      f->stats[S_BYTES_IN].fetch_add(n, std::memory_order_relaxed);
      a->BIO_write(c->rbio, buf, (int)n);
      if (n < (ssize_t)sizeof(buf)) break;
      continue;
    }
    if (n == 0 || !(errno == EAGAIN || errno == EWOULDBLOCK)) {
      peer_closed = true;  // EOF and hard errors both end the conn below
      break;
    }
    break;
  }
  if (c->tls_fail_injected) {
    // `tls.handshake` failpoint: refuse the handshake outright — the
    // client observes a connection torn down mid-handshake, the server
    // accounts it as an injected failure, never a mystery
    f->stats[S_TLS_FAIL_INJECTED].fetch_add(1, std::memory_order_relaxed);
    f->stats[S_TLS_HS_FAIL].fetch_add(1, std::memory_order_relaxed);
    conn_destroy(lp, c, false);
    return;
  }
  if (!c->tls_established) {
    a->ERR_clear_error();
    int r = a->SSL_do_handshake(c->ssl);
    if (r == 1) {
      c->tls_established = true;
      f->stats[S_TLS_HS_OK].fetch_add(1, std::memory_order_relaxed);
      if (c->reject_after_handshake) {
        // over-cap accept: the 503 is finally READABLE — the same
        // message + Retry-After the plaintext cap sends, answered
        // in-band and closed with close_notify
        f->stats[S_CONN_CAP].fetch_add(1, std::memory_order_relaxed);
        c->req_close = true;
        auto pr = std::make_unique<PendingResp>();
        pr->id = 0;
        pr->close_after = true;
        fill_response(lp, pr.get(), 503,
                      "application/json; charset=utf-8",
                      "{\"message\": \"connection limit reached; retry "
                      "later\", \"status\": 503}",
                      1, "");
        c->pipeline.push_back(std::move(pr));
        c->closing = true;
        conn_flush(lp, c);  // flushes Finished + 503, then clean-closes
        return;
      }
    } else {
      int err = a->SSL_get_error(c->ssl, r);
      if (err != kSSL_ERROR_WANT_READ && err != kSSL_ERROR_WANT_WRITE) {
        // hard handshake failure (garbage record, protocol floor,
        // wrong-CA client cert): flush the pending alert so the peer
        // sees a TLS alert rather than a bare RST, count, drop
        f->stats[S_TLS_HS_FAIL].fetch_add(1, std::memory_order_relaxed);
        while (a->BIO_ctrl_pending(c->wbio) > 0) {
          int n = a->BIO_read(c->wbio, buf, sizeof(buf));
          if (n <= 0) break;
          c->enc_out.append(buf, (size_t)n);
        }
        if (c->enc_off < c->enc_out.size()) {
          ssize_t sr = send(c->fd, c->enc_out.data() + c->enc_off,
                            c->enc_out.size() - c->enc_off, MSG_NOSIGNAL);
          if (sr > 0)
            f->stats[S_BYTES_OUT].fetch_add(sr, std::memory_order_relaxed);
        }
        conn_destroy(lp, c, false);
        return;
      }
      if (peer_closed) {
        f->stats[S_TLS_HS_DISCONNECT].fetch_add(1,
                                                std::memory_order_relaxed);
        conn_destroy(lp, c, false);
        return;
      }
      conn_flush(lp, c);  // push ServerHello…Finished; wait for more
      return;
    }
  }
  // established: drain every full record into the plaintext buffer
  bool tls_eof = false;
  for (;;) {
    int n = a->SSL_read(c->ssl, buf, sizeof(buf));
    if (n > 0) {
      c->in.append(buf, (size_t)n);
      continue;
    }
    int err = a->SSL_get_error(c->ssl, n);
    if (err == kSSL_ERROR_WANT_READ || err == kSSL_ERROR_WANT_WRITE) break;
    tls_eof = true;  // close_notify (ZERO_RETURN) or corrupt record
    break;
  }
  if (peer_closed || tls_eof) {
    bool midbody = c->state != 0;
    conn_destroy(lp, c, midbody);
    return;
  }
  conn_parse(lp, c);  // flushes via conn_flush→tls_flush; may destroy
}

// graftcheck: wire-input
void conn_read(Loop* lp, Conn* c) {
  if (c->ssl != nullptr) {
    tls_conn_read(lp, c);
    return;
  }
  char buf[65536];
  c->last_activity_ns = now_ns();
  for (;;) {
    ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      lp->front->stats[S_BYTES_IN].fetch_add(n, std::memory_order_relaxed);
      c->in.append(buf, (size_t)n);
      if (n < (ssize_t)sizeof(buf)) break;
      continue;
    }
    if (n == 0) {
      // peer closed; a request cut off mid-body simply dies (the Python
      // frontend behaves the same way — no response to compare)
      bool midbody = c->state != 0;
      conn_destroy(lp, c, midbody);
      return;
    }
    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
    conn_destroy(lp, c, false);
    return;
  }
  conn_parse(lp, c);  // may destroy the conn via conn_flush
}

// reap abusive/idle connections (round 13): idle keep-alive conns past
// the idle timeout, and conns whose CURRENT request has been arriving
// for longer than the read timeout (slowloris drips). Runs ~1/s per
// loop — O(conns) at sweep cadence, not per tick.
void sweep_timeouts(Loop* lp, int64_t now) {
  Front* f = lp->front;
  int64_t idle = f->idle_timeout_ns.load(std::memory_order_relaxed);
  int64_t readt = f->read_timeout_ns.load(std::memory_order_relaxed);
  int64_t hst = f->tls_handshake_timeout_ns.load(std::memory_order_relaxed);
  if (idle <= 0 && readt <= 0 && hst <= 0) return;
  std::vector<Conn*> victims;
  std::vector<Conn*> hs_victims;
  for (auto& kv : lp->conns) {
    Conn* c = kv.second;
    // TLS handshake-arrival deadline: anchored at ACCEPT, never
    // refreshed — a dripped ClientHello is slowloris one layer down
    // and dies on the same absolute clock as a silent socket
    if (c->ssl != nullptr && !c->tls_established && hst > 0 &&
        now - c->accept_ns > hst) {
      hs_victims.push_back(c);
      continue;
    }
    if (readt > 0 && c->request_start_ns != 0 &&
        now - c->request_start_ns > readt) {
      victims.push_back(c);
      continue;
    }
    // idle applies only BETWEEN requests: nothing half-read and no
    // response outstanding (a conn waiting on a slow verdict is the
    // batcher deadline machinery's problem, not an idle abuser)
    if (idle > 0 && c->request_start_ns == 0 && c->pipeline.empty() &&
        now - c->last_activity_ns > idle) {
      victims.push_back(c);
    }
  }
  for (Conn* c : hs_victims) {
    f->stats[S_TLS_HS_TIMEOUT].fetch_add(1, std::memory_order_relaxed);
    conn_destroy(lp, c, false);
  }
  for (Conn* c : victims) {
    f->stats[S_IDLE_CLOSES].fetch_add(1, std::memory_order_relaxed);
    // a server-chosen close of an established TLS conn says so with
    // close_notify — reaped abusers still deserve a decodable EOF
    if (c->ssl != nullptr && c->tls_established)
      tls_graceful_destroy(lp, c);
    else
      conn_destroy(lp, c, false);
  }
}

void process_comps(Loop* lp) {
  Front* f = lp->front;
  Comp* c = lp->comps.take_all_reversed();
  if (c == nullptr) return;
  // two phases: fill every response, then flush each touched connection
  // ONCE — under pipelining a conn collects many completions per burst,
  // and send() is expensive on syscall-intercepting kernels
  std::vector<Conn*> touched;
  int64_t t0 = now_ns();
  while (c != nullptr) {
    Comp* nx = c->next;
    f->stats[S_OUTSTANDING].fetch_add(-1, std::memory_order_relaxed);
    auto it = lp->pending.find(c->req_id);
    if (it != lp->pending.end()) {
      Conn* conn = it->second.first;
      PendingResp* pr = it->second.second;
      lp->pending.erase(it);
      fill_response(lp, pr, c->status,
                    "application/json; charset=utf-8", c->body,
                    c->retry_after, "");
      if (!conn->flush_queued) {
        conn->flush_queued = true;
        touched.push_back(conn);
      }
    }
    delete c;
    c = nx;
  }
  f->stats[S_FRAMING_NS].fetch_add(now_ns() - t0, std::memory_order_relaxed);
  for (Conn* conn : touched) {
    conn->flush_queued = false;
    conn_flush(lp, conn);  // may destroy conn (it is not revisited)
  }
}

void loop_main(Loop* lp) {
  Front* f = lp->front;
  epoll_event evs[128];
  while (!f->stop.load(std::memory_order_acquire)) {
    if (f->stop_accepting.load(std::memory_order_relaxed) &&
        lp->listen_registered) {
      epoll_ctl(lp->ep, EPOLL_CTL_DEL, f->listen_fd, nullptr);
      lp->listen_registered = false;
    }
    // 1 ms tick: completions (and stop flags) are picked up by POLLING —
    // producers never pay a wake syscall (see push_comp)
    int n = epoll_wait(lp->ep, evs, 128, 1);
    process_comps(lp);
    {
      int64_t now = now_ns();
      if (now - lp->last_sweep_ns >= 1000000000ll) {
        lp->last_sweep_ns = now;
        sweep_timeouts(lp, now);
      }
    }
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == f->listen_fd) {
        if (!f->stop_accepting.load(std::memory_order_relaxed))
          do_accept(lp);
        continue;
      }
      if (fd == lp->comp_efd) {
        uint64_t v;
        ssize_t r = read(lp->comp_efd, &v, sizeof(v));
        (void)r;  // completions already drained above
        continue;
      }
      auto it = lp->conns.find(fd);
      if (it == lp->conns.end()) continue;
      Conn* c = it->second;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        // let recv() observe the condition (may still carry final bytes)
        conn_read(lp, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) {
        conn_flush(lp, c);
        if (lp->conns.find(fd) == lp->conns.end()) continue;  // destroyed
      }
      if (evs[i].events & EPOLLIN) conn_read(lp, c);
    }
  }
  // teardown: drop every connection (their futures were resolved — or
  // rejected — by the batcher shutdown before the loops are stopped)
  std::vector<Conn*> cs;
  cs.reserve(lp->conns.size());
  for (auto& kv : lp->conns) cs.push_back(kv.second);
  for (Conn* c : cs) conn_destroy(lp, c, false);
}

// Multi-shard completion contract (round 22, runtime/shards.py): with
// --serving-shards M > 1 completions for one frontend arrive from M
// independent dispatch/delivery threads plus the router's heartbeat
// thread (fence-time 503s). That is already safe here — the CompStack
// is a lock-free multi-producer stack and req_id routing is loop-local
// — but it relies on the Python side's exactly-once guarantee: a row's
// owner token (_Pending.owner) ensures at most one shard (or the
// router) ever calls complete()/fill for a given req_id, so this layer
// never needs dedup. Retry-After is written for any status when
// retry_after > 0 (429 shed and 503 fence share the path).
void push_comp(Front* f, uint64_t req_id, int status, int retry_after,
               std::string&& body) {
  int idx = (int)((req_id >> 56) & 0x7F);
  if (idx >= (int)f->loops.size()) return;
  Comp* c = new Comp{nullptr, req_id, status, retry_after, std::move(body)};
  // NO eventfd wake per completion: on syscall-intercepting kernels
  // (gVisor-class, ~10-25us/syscall) the wake dominated the whole
  // serving profile. The event loop polls the stack every iteration at
  // a 1 ms epoll timeout instead — bounded added latency, zero producer
  // syscalls. stop() still wakes the efd to exit promptly.
  f->loops[(size_t)idx]->comps.push(c);
}

}  // namespace

// ------------------------------------------------------------------ C ABI --

// Batch-granular native response assembly (round 19): parse ONE v2
// verdict record at buf+off (bounds-checked against len), advance off,
// and build the byte-exact json.dumps(AdmissionReviewResponse(...)
// .to_dict()) body — default separators, key order pinned to the Python
// to_dict() (graftcheck RS02 checks the literal key sequence below
// against models/admission.py). Record layout
// (runtime/native_frontend.py _BULK_REC — the one packing path):
//   u64 req_id | u8 allowed | u8 raw_shape | u8 flags | u8 n_warnings
//   | i32 code | i32 uid_len | i32 msg_len | i32 patch_len
//   | i32 reason_len | i32 n_causes
//   | uid | msg | patch | reason
//   | n_warnings x (u32 len | bytes)
//   | n_causes  x (i32 field_len | i32 msg_len | field | msg)
// -1 lengths mean the field is absent; flags bit0 = status object
// present (possibly empty), bit1 = warnings list present (possibly
// empty); a present patch always renders patchType "JSONPatch" (the
// Python packer refuses anything else). auditAnnotations never travels
// natively — the Python responder stays the oracle for it.
// graftcheck: abi(policy_server_tpu_torch/runtime/native_frontend.py:_BULK_REC)
// graftcheck: wire-input
static bool parse_verdict_record(const uint8_t* buf, int64_t len,
                                 int64_t& off, uint64_t& req_id,
                                 std::string& body) {
  if (off + 36 > len) return false;
  memcpy(&req_id, buf + off, 8);
  uint8_t allowed = buf[off + 8];
  uint8_t raw_shape = buf[off + 9];
  uint8_t flags = buf[off + 10];
  uint8_t n_warn = buf[off + 11];
  int32_t code, uid_len, msg_len, patch_len, reason_len, n_causes;
  memcpy(&code, buf + off + 12, 4);
  memcpy(&uid_len, buf + off + 16, 4);
  memcpy(&msg_len, buf + off + 20, 4);
  memcpy(&patch_len, buf + off + 24, 4);
  memcpy(&reason_len, buf + off + 28, 4);
  memcpy(&n_causes, buf + off + 32, 4);
  off += 36;
  if (uid_len < 0) return false;
  auto take = [&](int32_t n, const uint8_t*& p) -> bool {
    if (n < 0) {
      p = nullptr;
      return true;
    }
    if (off + n > len) return false;
    p = buf + off;
    off += n;
    return true;
  };
  const uint8_t *uid, *msg, *patch, *reason;
  if (!take(uid_len, uid) || !take(msg_len, msg) ||
      !take(patch_len, patch) || !take(reason_len, reason))
    return false;
  // variable tails parsed in layout order BEFORE building (the body
  // interleaves them differently than the wire does). Every
  // caller-supplied length/count is bounds-checked against the buffer
  // BEFORE any allocation or pointer math — httpfront_render_verdict
  // is exported for arbitrary test/fuzz input and must answer
  // malformed records with false, never a crash (a u32 warning length
  // >= 2^31 must not wrap into take()'s signed "absent" sentinel, and
  // an n_causes count must not drive a giant reserve()).
  std::vector<std::pair<int64_t, const uint8_t*>> warns;
  warns.reserve(n_warn);
  for (uint8_t wi = 0; wi < n_warn; wi++) {
    if (off + 4 > len) return false;
    uint32_t wlen;
    memcpy(&wlen, buf + off, 4);
    off += 4;
    if ((int64_t)wlen > len - off) return false;
    warns.emplace_back((int64_t)wlen, buf + off);
    off += (int64_t)wlen;
  }
  std::vector<std::array<std::pair<int32_t, const uint8_t*>, 2>> causes;
  if (n_causes > 0) {
    if ((int64_t)n_causes * 8 > len - off) return false;  // 8 B/cause min
    causes.reserve((size_t)n_causes);
  }
  for (int32_t ci = 0; ci < n_causes; ci++) {
    if (off + 8 > len) return false;
    int32_t flen, mlen;
    memcpy(&flen, buf + off, 4);
    memcpy(&mlen, buf + off + 4, 4);
    off += 8;
    const uint8_t *fld, *cmsg;
    if (!take(flen, fld) || !take(mlen, cmsg)) return false;
    causes.push_back({std::make_pair(flen, fld), std::make_pair(mlen, cmsg)});
  }
  std::string resp;
  resp.reserve(160 + (size_t)uid_len + (size_t)(msg_len > 0 ? msg_len : 0) +
               (size_t)(patch_len > 0 ? patch_len : 0));
  resp += "{\"uid\": ";
  py_escape(std::string((const char*)uid, (size_t)uid_len), resp);
  resp += ", \"allowed\": ";
  resp += allowed ? "true" : "false";
  if (patch_len >= 0) {
    resp += ", \"patchType\": \"JSONPatch\", \"patch\": ";
    py_escape(std::string((const char*)patch, (size_t)patch_len), resp);
  }
  if (flags & 1) {
    resp += ", \"status\": {";
    bool first = true;
    auto sep = [&]() {
      if (!first) resp += ", ";
      first = false;
    };
    if (msg_len >= 0) {
      sep();
      resp += "\"message\": ";
      py_escape(std::string((const char*)msg, (size_t)msg_len), resp);
    }
    if (code >= 0) {
      sep();
      char tmp[24];
      snprintf(tmp, sizeof(tmp), "\"code\": %d", code);
      resp += tmp;
    }
    if (reason_len >= 0) {
      sep();
      resp += "\"reason\": ";
      py_escape(std::string((const char*)reason, (size_t)reason_len), resp);
    }
    if (n_causes >= 0) {
      sep();
      resp += "\"details\": {\"causes\": [";
      for (size_t ci = 0; ci < causes.size(); ci++) {
        if (ci) resp += ", ";
        resp += "{";
        int32_t flen = causes[ci][0].first, mlen = causes[ci][1].first;
        if (flen >= 0) {
          resp += "\"field\": ";
          py_escape(
              std::string((const char*)causes[ci][0].second, (size_t)flen),
              resp);
        }
        if (mlen >= 0) {
          if (flen >= 0) resp += ", ";
          resp += "\"message\": ";
          py_escape(
              std::string((const char*)causes[ci][1].second, (size_t)mlen),
              resp);
        }
        resp += "}";
      }
      resp += "]}";
    }
    resp += "}";
  }
  if (flags & 2) {
    resp += ", \"warnings\": [";
    for (size_t wi = 0; wi < warns.size(); wi++) {
      if (wi) resp += ", ";
      py_escape(std::string((const char*)warns[wi].second,
                            (size_t)warns[wi].first),
                resp);
    }
    resp += "]";
  }
  resp += "}";
  if (raw_shape)
    body = "{\"response\": " + resp + "}";
  else
    body =
        "{\"apiVersion\": \"admission.k8s.io/v1\", \"kind\": "
        "\"AdmissionReview\", \"response\": " +
        resp + "}";
  return true;
}

extern "C" {

// listen_fd: a bound+listening non-blocking socket the CALLER owns (Python
// creates it with SO_REUSEPORT so prefork processes can share the port).
void* httpfront_create(int listen_fd, int n_loops, int64_t max_body,
                       const char* server_hdr, int ring_bits) {
  if (n_loops < 1) n_loops = 1;
  if (n_loops > 64) n_loops = 64;
  if (ring_bits < 8) ring_bits = 8;
  if (ring_bits > 16) ring_bits = 16;
  Front* f = new Front();
  f->listen_fd = listen_fd;
  f->n_loops = n_loops;
  f->max_body = max_body;
  f->server_hdr = server_hdr ? server_hdr : "policy-server-tpu";
  f->sub_efd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  if (f->sub_efd < 0) {
    delete f;
    return nullptr;
  }
  for (int i = 0; i < n_loops; i++) {
    auto lp = std::make_unique<Loop>((size_t)ring_bits);
    lp->front = f;
    lp->idx = i;
    lp->ep = epoll_create1(EPOLL_CLOEXEC);
    lp->comp_efd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    if (lp->ep < 0 || lp->comp_efd < 0) {
      if (lp->ep >= 0) close(lp->ep);
      if (lp->comp_efd >= 0) close(lp->comp_efd);
      close(f->sub_efd);
      delete f;
      return nullptr;
    }
    f->loops.push_back(std::move(lp));
  }
  return f;
}

// Connection-abuse hardening knobs (0 disables each): idle keep-alive
// timeout, per-request read (header+body arrival) timeout, and the max
// concurrent connection cap (over-cap accepts answer an in-band 503 and
// close, counted). Callable before start() or live — the loops read the
// atomics on every sweep/accept.
void httpfront_configure(void* h, int64_t idle_timeout_ms,
                         int64_t read_timeout_ms, int64_t max_conns) {
  Front* f = (Front*)h;
  f->idle_timeout_ns.store(
      idle_timeout_ms > 0 ? idle_timeout_ms * 1000000ll : 0,
      std::memory_order_relaxed);
  f->read_timeout_ns.store(
      read_timeout_ms > 0 ? read_timeout_ms * 1000000ll : 0,
      std::memory_order_relaxed);
  f->max_conns.store(max_conns > 0 ? max_conns : 0,
                     std::memory_order_relaxed);
}

void httpfront_set_static(void* h, int slot, int status,
                          const char* content_type, const char* body,
                          int64_t body_len, const char* extra_headers) {
  Front* f = (Front*)h;
  if (slot < 0 || slot >= ST_MAX) return;
  StaticResp& st = f->statics[slot];
  st.status = status;
  st.content_type = content_type ? content_type : "text/plain; charset=utf-8";
  st.body.assign(body ? body : "", body ? (size_t)body_len : 0);
  st.extra = extra_headers ? extra_headers : "";
}

int httpfront_start(void* h) {
  Front* f = (Front*)h;
  for (auto& lp : f->loops) {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = f->listen_fd;
    if (epoll_ctl(lp->ep, EPOLL_CTL_ADD, f->listen_fd, &ev) != 0) return -1;
    lp->listen_registered = true;
    ev = epoll_event{};
    ev.events = EPOLLIN;
    ev.data.fd = lp->comp_efd;
    if (epoll_ctl(lp->ep, EPOLL_CTL_ADD, lp->comp_efd, &ev) != 0) return -1;
  }
  for (auto& lp : f->loops) {
    Loop* raw = lp.get();
    lp->thr = std::thread([raw] { loop_main(raw); });
  }
  return 0;
}

void httpfront_stop_accepting(void* h) {
  Front* f = (Front*)h;
  f->stop_accepting.store(true, std::memory_order_relaxed);
  for (auto& lp : f->loops) wake_fd(lp->comp_efd);
}

void httpfront_stop(void* h) {
  Front* f = (Front*)h;
  f->stop.store(true, std::memory_order_release);
  for (auto& lp : f->loops) wake_fd(lp->comp_efd);
  wake_fd(f->sub_efd);
  for (auto& lp : f->loops)
    if (lp->thr.joinable()) lp->thr.join();
}

void httpfront_destroy(void* h) {
  Front* f = (Front*)h;
  for (auto& lp : f->loops) {
    // free undrained submission records and unprocessed completions
    for (uint8_t* rec = lp->ring.pop(); rec != nullptr; rec = lp->ring.pop())
      free(rec);
    Comp* c = lp->comps.take_all_reversed();
    while (c != nullptr) {
      Comp* nx = c->next;
      delete c;
      c = nx;
    }
    close(lp->ep);
    close(lp->comp_efd);
  }
  close(f->sub_efd);
  {
    std::lock_guard<std::mutex> g(f->tls_mu);
    if (f->tls_current != nullptr) {
      tls_ctx_unref(f->tls_current);
      f->tls_current = nullptr;
    }
  }
  delete f;
}

// Drain parsed requests into `buf` (concatenated records, each prefixed by
// its u32 total_len). Blocks up to timeout_ms when nothing is pending.
// Returns bytes written, 0 on timeout, -1 once stopped AND fully drained.
// graftcheck: wire-input
int64_t httpfront_poll(void* h, uint8_t* buf, int64_t cap, int timeout_ms) {
  Front* f = (Front*)h;
  int64_t deadline = now_ns() + (int64_t)timeout_ms * 1000000ll;
  for (;;) {
    uint64_t v;
    ssize_t r = read(f->sub_efd, &v, sizeof(v));  // stop()-wake drain
    (void)r;
    int64_t written = 0;
    for (auto& lp : f->loops) {
      for (;;) {
        uint8_t* rec = lp->ring.peek();
        if (rec == nullptr) break;
        uint32_t len;
        memcpy(&len, rec, sizeof(len));
        if ((int64_t)len > cap) {
          // defense-in-depth: a record the poll buffer can never hold
          // (submit_request's fallback bound should make this
          // unreachable) must not wedge the ring head forever — drop
          // it and answer the request in-band
          uint64_t req_id;
          memcpy(&req_id, rec + 4, sizeof(req_id));
          lp->ring.advance();
          free(rec);
          push_comp(f, req_id, 500,
                    0, "{\"message\": \"Something went wrong\", "
                       "\"status\": 500}");
          continue;
        }
        if (written + (int64_t)len > cap) break;
        memcpy(buf + written, rec, len);
        written += len;
        lp->ring.advance();
        free(rec);
      }
      if (written >= cap) break;
    }
    if (written > 0) return written;
    if (f->stop.load(std::memory_order_acquire)) return -1;
    if (now_ns() >= deadline) return 0;
    // producers do NOT wake the efd per request (syscalls are expensive
    // on sandboxed kernels): sleep one tick and re-scan. The efd only
    // carries the stop() wake, which cuts the final tick short.
    pollfd pfd{f->sub_efd, POLLIN, 0};
    (void)poll(&pfd, 1, 1);
  }
}

// Complete with a Python-rendered JSON body (error paths, mutations,
// warnings — anything the native serializer does not cover).
void httpfront_complete(void* h, uint64_t req_id, int status,
                        const uint8_t* body, int64_t body_len,
                        int retry_after) {
  Front* f = (Front*)h;
  f->stats[S_PY_SER].fetch_add(1, std::memory_order_relaxed);
  push_comp(f, req_id, status, retry_after,
            std::string((const char*)body, (size_t)body_len));
}

// Batch-granular completion fill (round 12; v2 records round 19): one
// call per dispatched batch. `buf` is the packed little-endian record
// sequence documented at parse_verdict_record — the Python side builds
// it once per batch and pays ONE ctypes crossing + ONE frontend lock
// instead of one per request, and the full response shape (patches,
// warnings, status reason/details tables) renders natively.
// graftcheck: wire-input
void httpfront_complete_verdict_bulk(void* h, const uint8_t* buf,
                                     int64_t len, int64_t count) {
  Front* f = (Front*)h;
  int64_t t0 = now_ns();
  int64_t off = 0;
  int64_t done = 0;
  uint64_t req_id;
  std::string body;
  while (done < count) {
    if (!parse_verdict_record(buf, len, off, req_id, body)) break;
    push_comp(f, req_id, 200, 0, std::move(body));
    done++;
  }
  f->stats[S_NATIVE_SER].fetch_add(done, std::memory_order_relaxed);
  f->stats[S_FRAMING_NS].fetch_add(now_ns() - t0, std::memory_order_relaxed);
}

// Differential-corpus export (tests/test_native_assembly.py): render ONE
// v2 verdict record's response body into `out` without touching any
// connection state. Returns the body length, or -1 on malformed input /
// insufficient capacity. This is the SAME parse+emit path serving uses,
// so the byte-exactness the corpus proves is the byte-exactness
// production emits.
// graftcheck: wire-input
int64_t httpfront_render_verdict(const uint8_t* buf, int64_t len,
                                 uint8_t* out, int64_t cap) {
  int64_t off = 0;
  uint64_t rid;
  std::string body;
  if (!parse_verdict_record(buf, len, off, rid, body)) return -1;
  if ((int64_t)body.size() > cap) return -1;
  memcpy(out, body.data(), body.size());
  return (int64_t)body.size();
}

int64_t httpfront_outstanding(void* h) {
  return ((Front*)h)->stats[S_OUTSTANDING].load(std::memory_order_relaxed);
}

// ------------------------------------------------------------- TLS C ABI --

// 1 when the dlopen'd OpenSSL binding resolved completely; 0 otherwise
// (httpfront_tls_error says why). The Python caller uses a 0 to degrade
// LOUDLY to the aiohttp TLS frontend — never to serve plaintext.
int httpfront_tls_available(void) { return tls_api()->ok ? 1 : 0; }

const char* httpfront_tls_error(void) {
  if (!tls_api()->ok) return tls_api()->err.c_str();
  return g_tls_err;
}

// Build one SSL_CTX generation from PEM bytes (certs.py's last-good
// identity snapshot): cert_pem may carry leaf+chain; a non-empty ca_pem
// turns on mTLS with CPython's CERT_REQUIRED semantics (verify peer,
// fail the handshake without a client cert; no CA-name hints — the
// ssl.SSLContext oracle sends none either, keeping handshake
// transcripts comparable). Returns an opaque refcounted handle or null
// with httpfront_tls_error set.
void* httpfront_tls_ctx_create(const uint8_t* cert_pem, int64_t cert_len,
                               const uint8_t* key_pem, int64_t key_len,
                               const uint8_t* ca_pem, int64_t ca_len) {
  TlsApi* a = tls_api();
  if (!a->ok) {
    snprintf(g_tls_err, sizeof(g_tls_err), "%s", a->err.c_str());
    return nullptr;
  }
  a->ERR_clear_error();
  void* ctx = a->SSL_CTX_new(a->TLS_server_method());
  if (ctx == nullptr) {
    set_tls_err("SSL_CTX_new failed");
    return nullptr;
  }
  // TLS 1.2 floor, matching ssl.SSLContext's webhook posture
  a->SSL_CTX_ctrl(ctx, kSSL_CTRL_SET_MIN_PROTO_VERSION, kTLS1_2_VERSION,
                  nullptr);
  bool ok = true;
  void* bio = a->BIO_new_mem_buf(cert_pem, (int)cert_len);
  void* leaf =
      bio != nullptr ? a->PEM_read_bio_X509(bio, nullptr, nullptr, nullptr)
                     : nullptr;
  if (leaf == nullptr) {
    set_tls_err("identity PEM holds no certificate");
    ok = false;
  } else {
    if (a->SSL_CTX_use_certificate(ctx, leaf) != 1) {
      set_tls_err("SSL_CTX_use_certificate failed");
      ok = false;
    }
    a->X509_free(leaf);
    while (ok) {  // remaining PEM blocks are the chain, ctx takes them
      void* extra = a->PEM_read_bio_X509(bio, nullptr, nullptr, nullptr);
      if (extra == nullptr) {
        a->ERR_clear_error();  // expected end-of-PEM parse error
        break;
      }
      if (a->SSL_CTX_ctrl(ctx, kSSL_CTRL_EXTRA_CHAIN_CERT, 0, extra) != 1) {
        a->X509_free(extra);
        set_tls_err("SSL_CTX add chain cert failed");
        ok = false;
      }
    }
  }
  if (bio != nullptr) a->BIO_free(bio);
  if (ok) {
    bio = a->BIO_new_mem_buf(key_pem, (int)key_len);
    void* pkey =
        bio != nullptr
            ? a->PEM_read_bio_PrivateKey(bio, nullptr, nullptr, nullptr)
            : nullptr;
    if (pkey == nullptr) {
      set_tls_err("identity PEM holds no private key");
      ok = false;
    } else {
      if (a->SSL_CTX_use_PrivateKey(ctx, pkey) != 1 ||
          a->SSL_CTX_check_private_key(ctx) != 1) {
        set_tls_err("private key does not match certificate");
        ok = false;
      }
      a->EVP_PKEY_free(pkey);
    }
    if (bio != nullptr) a->BIO_free(bio);
  }
  if (ok && ca_pem != nullptr && ca_len > 0) {
    void* store = a->SSL_CTX_get_cert_store(ctx);
    bio = a->BIO_new_mem_buf(ca_pem, (int)ca_len);
    int added = 0;
    for (;;) {
      void* x = bio != nullptr
                    ? a->PEM_read_bio_X509(bio, nullptr, nullptr, nullptr)
                    : nullptr;
      if (x == nullptr) {
        a->ERR_clear_error();
        break;
      }
      if (a->X509_STORE_add_cert(store, x) == 1) added++;
      a->X509_free(x);
    }
    if (bio != nullptr) a->BIO_free(bio);
    if (added == 0) {
      set_tls_err("client-CA PEM holds no certificate");
      ok = false;
    } else {
      a->SSL_CTX_set_verify(
          ctx, kSSL_VERIFY_PEER | kSSL_VERIFY_FAIL_IF_NO_PEER_CERT,
          nullptr);
    }
  }
  if (!ok) {
    a->SSL_CTX_free(ctx);
    return nullptr;
  }
  TlsCtx* t = new TlsCtx();
  t->ctx = ctx;
  return t;
}

void httpfront_tls_ctx_free(void* tctx) { tls_ctx_unref((TlsCtx*)tctx); }

// Atomically swap the generation NEW accepts handshake under; takes its
// own reference (the caller's handle stays valid until tls_ctx_free).
// Established connections keep draining on the generation they pinned
// at accept — hot rotation never cuts a live session. Null disables TLS
// for new connections.
void httpfront_set_tls(void* h, void* tctx) {
  Front* f = (Front*)h;
  TlsCtx* t = (TlsCtx*)tctx;
  if (t != nullptr) t->refs.fetch_add(1, std::memory_order_relaxed);
  TlsCtx* old = nullptr;
  {
    std::lock_guard<std::mutex> g(f->tls_mu);
    old = f->tls_current;
    f->tls_current = t;
  }
  if (old != nullptr) tls_ctx_unref(old);
}

// Handshake-arrival deadline (ms; 0 disables): measured from ACCEPT,
// never refreshed by arriving bytes — the TLS-layer slowloris clock.
void httpfront_tls_configure(void* h, int64_t handshake_timeout_ms) {
  Front* f = (Front*)h;
  f->tls_handshake_timeout_ns.store(
      handshake_timeout_ms > 0 ? handshake_timeout_ms * 1000000ll : 0,
      std::memory_order_relaxed);
}

// `tls.handshake` failpoint backend: fail the next n handshakes (n>0),
// every handshake (-1), or disarm (0). Failures are torn down before
// any handshake progress and counted under tls_fail_injected.
void httpfront_tls_fail_handshakes(void* h, long n) {
  ((Front*)h)->tls_fail_next.store(n, std::memory_order_relaxed);
}

// Capability probe for kTLS offload after the userspace handshake: the
// loaded OpenSSL must be a 3.x kTLS build (SSL_sendfile present).
// Against 1.1 this answers 0 and the Python side LOGS the probe result
// — an explicit no, never a silent downgrade.
int httpfront_ktls_supported(void) {
  TlsApi* a = tls_api();
  return (a->ok && a->ktls) ? 1 : 0;
}

void httpfront_stats(void* h, int64_t* out, int cap) {
  // cap is the caller's buffer size: the Python side allocates it from
  // its own constant, so a future STAT_N bump here must never write
  // past what the caller actually handed us
  Front* f = (Front*)h;
  int n = cap < STAT_N ? cap : STAT_N;
  for (int i = 0; i < n; i++)
    out[i] = f->stats[i].load(std::memory_order_relaxed);
}

}  // extern "C"
