// kwok_tpu native ingest: watch-event extraction + canonical fingerprints.
//
// The engine's ingest edge was the scale wall (at 50k pods the tick thread
// spent ~85% of its time in per-event json.loads + repair-path render/merge
// on events that are echoes of the engine's own patches). This library
// parses a watch-event line ONCE in C++ and returns:
//
//   - the routing fields the engine needs (type, namespace, name, nodeName,
//     deletion/finalizer flags),
//   - order-insensitive canonical fingerprints of the subtrees whose change
//     forces full (Python) processing: status, status-minus-conditions
//     (nodes: the reference's no-op check pins conditions, so heartbeat
//     echoes only differ there — node_controller.go:377), spec, and the
//     selector-relevant metadata (labels+annotations+deletion+finalizers).
//
// The engine then DROPS events whose fingerprints prove the reference's
// render->merge->compare pipeline would conclude "no patch needed", and
// fully parses only the survivors. Dropping is always the conservative
// direction: any mismatch or parse surprise routes to the Python path.
//
// Fingerprint: objects combine members with XOR (insertion-order
// invariant: the server may store keys in a different order than our
// renderer emits), arrays combine in order, scalars hash their raw token
// text. Two serializations of the same document agree as long as they
// escape strings identically — when they don't, fingerprints differ and
// the engine just takes the slow path.
//
// Build: part of libkwokcodec.so (see native/__init__.py _build).

#include <climits>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
  }
  bool at(char c) { return p < end && *p == c; }
  void expect(char c) {
    if (at(c)) p++;
    else ok = false;
  }
};

constexpr uint64_t FNV_OFFSET = 1469598103934665603ull;
constexpr uint64_t FNV_PRIME = 1099511628211ull;
constexpr uint64_t OBJ_SEED = 0x9e3779b97f4a7c15ull;
constexpr uint64_t ARR_SEED = 0xc2b2ae3d27d4eb4full;

inline uint64_t fnv(const char* s, int64_t n, uint64_t h = FNV_OFFSET) {
  for (int64_t i = 0; i < n; i++) {
    h ^= (unsigned char)s[i];
    h *= FNV_PRIME;
  }
  return h;
}

inline uint64_t mix(uint64_t a, uint64_t b) {
  uint64_t x = a ^ (b + 0x9e3779b97f4a7c15ull + (a << 6) + (a >> 2));
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  return x;
}

// Raw string token: bytes between the quotes, escapes NOT decoded.
// Returns [start, len) into the buffer; cursor ends after closing quote.
bool raw_string(Cursor& c, const char** start, int64_t* len) {
  if (!c.at('"')) {
    c.ok = false;
    return false;
  }
  c.p++;
  *start = c.p;
  while (c.p < c.end) {
    if (*c.p == '\\') {
      c.p += 2;  // an escape at the very end leaves p past end: clamped below
      continue;
    }
    if (*c.p == '"') {
      *len = c.p - *start;
      c.p++;
      return true;
    }
    c.p++;
  }
  // unterminated (a line cut mid-string): no length to hand out, and the
  // cursor stays inside the line
  c.p = c.end;
  *len = 0;
  c.ok = false;
  return false;
}

uint64_t fp_value(Cursor& c);

uint64_t fp_object(Cursor& c) {
  c.expect('{');
  c.ws();
  uint64_t h = OBJ_SEED;
  if (c.at('}')) {
    c.p++;
    return h;
  }
  while (c.ok) {
    c.ws();
    const char* ks;
    int64_t kn;
    if (!raw_string(c, &ks, &kn)) return h;
    c.ws();
    c.expect(':');
    c.ws();
    uint64_t kv = mix(fnv(ks, kn), fp_value(c));
    h ^= kv;  // XOR: member order must not matter
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect('}');
  return h;
}

uint64_t fp_array(Cursor& c) {
  c.expect('[');
  c.ws();
  uint64_t h = ARR_SEED;
  if (c.at(']')) {
    c.p++;
    return h;
  }
  while (c.ok) {
    c.ws();
    h = mix(h, fp_value(c));  // order matters for arrays
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect(']');
  return h;
}

uint64_t fp_value(Cursor& c) {
  c.ws();
  if (c.p >= c.end) {
    c.ok = false;
    return 0;
  }
  switch (*c.p) {
    case '{': return fp_object(c);
    case '[': return fp_array(c);
    case '"': {
      const char* s;
      int64_t n;
      if (!raw_string(c, &s, &n)) return 0;  // unterminated: c.ok is false
      return fnv(s, n) ^ 0x5bd1e995u;
    }
    default: {
      const char* s = c.p;
      while (c.p < c.end && *c.p != ',' && *c.p != '}' && *c.p != ']' &&
             *c.p != ' ' && *c.p != '\t' && *c.p != '\n' && *c.p != '\r')
        c.p++;
      return fnv(s, c.p - s);
    }
  }
}

void skip_value(Cursor& c) {
  c.ws();
  if (c.p >= c.end) {
    c.ok = false;
    return;
  }
  switch (*c.p) {
    case '{': {
      c.p++;
      int depth = 1;
      while (c.p < c.end && depth) {
        if (*c.p == '"') {
          const char* s;
          int64_t n;
          raw_string(c, &s, &n);
          continue;
        }
        if (*c.p == '{') depth++;
        else if (*c.p == '}') depth--;
        c.p++;
      }
      if (depth) c.ok = false;
      return;
    }
    case '[': {
      c.p++;
      int depth = 1;
      while (c.p < c.end && depth) {
        if (*c.p == '"') {
          const char* s;
          int64_t n;
          raw_string(c, &s, &n);
          continue;
        }
        if (*c.p == '[') depth++;
        else if (*c.p == ']') depth--;
        c.p++;
      }
      if (depth) c.ok = false;
      return;
    }
    case '"': {
      const char* s;
      int64_t n;
      raw_string(c, &s, &n);
      return;
    }
    default:
      while (c.p < c.end && *c.p != ',' && *c.p != '}' && *c.p != ']' &&
             *c.p != ' ' && *c.p != '\t' && *c.p != '\n' && *c.p != '\r')
        c.p++;
  }
}

struct Span {
  const char* p = nullptr;
  int64_t n = 0;
  bool present() const { return p != nullptr; }
};

// zlib-compatible CRC-32 (IEEE, reflected): the routing hash MUST equal
// Python's zlib.crc32 over the same bytes, because rowpool.shard_of is the
// key->lane contract the lane pools are built on. Table built on first use.
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

const uint32_t* crc32_table() {
  // C++11 magic static: ctypes drops the GIL around kwok_parse_events,
  // so two engines in one process can race the first use — a plain
  // ready-flag would let a thread read the table before its stores are
  // visible and route a key to the wrong lane
  static const Crc32Table table;
  return table.t;
}

inline uint32_t crc32_update(uint32_t crc, const char* p, int64_t n) {
  const uint32_t* t = crc32_table();
  for (int64_t i = 0; i < n; i++)
    crc = t[(crc ^ (unsigned char)p[i]) & 0xffu] ^ (crc >> 8);
  return crc;
}

// shard_of(key, n) for the two key shapes the row pools use: node keys are
// the name; pod keys are (namespace or "default", name) joined by \x1f —
// exactly rowpool.shard_of's "\x1f".join(...).encode(). Raw token bytes are
// what the Python router hashes too (decode("utf-8")/encode() round-trips
// them), so the mapping is provably unchanged.
inline int32_t shard_of_event(const Span& ns, const Span& name,
                              int kind_is_pods, int32_t n_shards) {
  if (n_shards <= 1) return 0;
  uint32_t crc = 0xffffffffu;
  if (kind_is_pods) {
    if (ns.n > 0) crc = crc32_update(crc, ns.p, ns.n);
    else crc = crc32_update(crc, "default", 7);
    crc = crc32_update(crc, "\x1f", 1);
  }
  crc = crc32_update(crc, name.p, name.n);
  return (int32_t)((crc ^ 0xffffffffu) % (uint32_t)n_shards);
}

bool span_eq(const Span& s, const char* lit) {
  int64_t n = (int64_t)strlen(lit);
  return s.n == n && memcmp(s.p, lit, n) == 0;
}

// One parsed watch event (or list item).
struct Event {
  Span type;       // ADDED / MODIFIED / DELETED / ...
  Span name, ns, node_name, phase, pod_ip, host_ip, creation;
  bool has_deletion = false;
  bool has_finalizers = false;
  bool has_readiness_gates = false;
  bool status_scalar_only = true;  // keys subset of {phase,hostIP,podIP,startTime}
  uint64_t fp_status = 0;
  uint64_t fp_status_nc = 0;  // status minus top-level "conditions"
  uint64_t fp_spec = 0;
  uint64_t fp_meta_sel = 0;   // labels+annotations+deletion+finalizers
  int64_t rv = 0;             // metadata.resourceVersion (0 if absent)
  std::vector<std::pair<Span, Span>> containers;       // (name, image)
  std::vector<std::pair<Span, Span>> init_containers;  // (name, image)
  std::vector<Span> true_conditions;                   // types with status True
  bool ok = false;
};

// Fingerprint an array of container objects while extracting (name, image)
// span pairs — same fp algorithm as fp_array/fp_object.
uint64_t fp_container_array(Cursor& c,
                            std::vector<std::pair<Span, Span>>* out) {
  c.ws();
  if (!c.at('[')) return fp_value(c);
  c.p++;
  uint64_t h = ARR_SEED;
  c.ws();
  if (c.at(']')) {
    c.p++;
    return h;
  }
  while (c.ok) {
    c.ws();
    if (!c.at('{')) {
      h = mix(h, fp_value(c));
    } else {
      c.p++;
      uint64_t eh = OBJ_SEED;
      Span cname, cimage;
      c.ws();
      if (c.at('}')) {
        c.p++;
      } else {
        while (c.ok) {
          c.ws();
          const char* ks;
          int64_t kn;
          if (!raw_string(c, &ks, &kn)) break;
          c.ws();
          c.expect(':');
          c.ws();
          Span key{ks, kn};
          if (span_eq(key, "name") && c.at('"')) {
            raw_string(c, &cname.p, &cname.n);
            eh ^= mix(fnv(ks, kn), fnv(cname.p, cname.n) ^ 0x5bd1e995u);
          } else if (span_eq(key, "image") && c.at('"')) {
            raw_string(c, &cimage.p, &cimage.n);
            eh ^= mix(fnv(ks, kn), fnv(cimage.p, cimage.n) ^ 0x5bd1e995u);
          } else {
            eh ^= mix(fnv(ks, kn), fp_value(c));
          }
          c.ws();
          if (c.at(',')) {
            c.p++;
            continue;
          }
          break;
        }
        c.expect('}');
      }
      if (out) out->emplace_back(cname, cimage);
      h = mix(h, eh);
    }
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect(']');
  return h;
}

// Fingerprint the conditions array while collecting the True-status types.
uint64_t fp_conditions_array(Cursor& c, std::vector<Span>* out) {
  c.ws();
  if (!c.at('[')) return fp_value(c);
  c.p++;
  uint64_t h = ARR_SEED;
  c.ws();
  if (c.at(']')) {
    c.p++;
    return h;
  }
  while (c.ok) {
    c.ws();
    if (!c.at('{')) {
      h = mix(h, fp_value(c));
    } else {
      c.p++;
      uint64_t eh = OBJ_SEED;
      Span ctype, cstatus;
      c.ws();
      if (c.at('}')) {
        c.p++;
      } else {
        while (c.ok) {
          c.ws();
          const char* ks;
          int64_t kn;
          if (!raw_string(c, &ks, &kn)) break;
          c.ws();
          c.expect(':');
          c.ws();
          Span key{ks, kn};
          if (span_eq(key, "type") && c.at('"')) {
            raw_string(c, &ctype.p, &ctype.n);
            eh ^= mix(fnv(ks, kn), fnv(ctype.p, ctype.n) ^ 0x5bd1e995u);
          } else if (span_eq(key, "status") && c.at('"')) {
            raw_string(c, &cstatus.p, &cstatus.n);
            eh ^= mix(fnv(ks, kn), fnv(cstatus.p, cstatus.n) ^ 0x5bd1e995u);
          } else {
            eh ^= mix(fnv(ks, kn), fp_value(c));
          }
          c.ws();
          if (c.at(',')) {
            c.p++;
            continue;
          }
          break;
        }
        c.expect('}');
      }
      if (out && ctype.present() && span_eq(cstatus, "True"))
        out->push_back(ctype);
      h = mix(h, eh);
    }
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect(']');
  return h;
}

// Fingerprint the status object while noting phase/podIP/hostIP spans and
// computing the minus-conditions variant.
void walk_status(Cursor& c, Event& ev) {
  c.ws();
  if (!c.at('{')) {  // status may be null/absent-shaped
    ev.fp_status = fp_value(c);
    ev.fp_status_nc = ev.fp_status;
    return;
  }
  c.p++;
  uint64_t h = OBJ_SEED, hnc = OBJ_SEED;
  c.ws();
  if (c.at('}')) {
    c.p++;
    ev.fp_status = h;
    ev.fp_status_nc = hnc;
    return;
  }
  while (c.ok) {
    c.ws();
    const char* ks;
    int64_t kn;
    if (!raw_string(c, &ks, &kn)) break;
    c.ws();
    c.expect(':');
    c.ws();
    Span key{ks, kn};
    if (span_eq(key, "phase") && c.at('"')) {
      raw_string(c, &ev.phase.p, &ev.phase.n);
      uint64_t kv = mix(fnv(ks, kn), fnv(ev.phase.p, ev.phase.n) ^ 0x5bd1e995u);
      h ^= kv;
      hnc ^= kv;
    } else if (span_eq(key, "podIP") && c.at('"')) {
      raw_string(c, &ev.pod_ip.p, &ev.pod_ip.n);
      uint64_t kv =
          mix(fnv(ks, kn), fnv(ev.pod_ip.p, ev.pod_ip.n) ^ 0x5bd1e995u);
      h ^= kv;
      hnc ^= kv;
    } else if (span_eq(key, "hostIP") && c.at('"')) {
      raw_string(c, &ev.host_ip.p, &ev.host_ip.n);
      uint64_t kv =
          mix(fnv(ks, kn), fnv(ev.host_ip.p, ev.host_ip.n) ^ 0x5bd1e995u);
      h ^= kv;
      hnc ^= kv;
    } else if (span_eq(key, "conditions")) {
      uint64_t vfp = fp_conditions_array(c, &ev.true_conditions);
      h ^= mix(fnv(ks, kn), vfp);  // excluded from hnc by definition
      ev.status_scalar_only = false;
    } else {
      uint64_t vfp = fp_value(c);
      uint64_t kv = mix(fnv(ks, kn), vfp);
      h ^= kv;
      hnc ^= kv;
      if (!span_eq(key, "startTime")) ev.status_scalar_only = false;
    }
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect('}');
  ev.fp_status = h;
  ev.fp_status_nc = hnc;
}

void walk_metadata(Cursor& c, Event& ev) {
  c.ws();
  if (!c.at('{')) {
    skip_value(c);
    return;
  }
  c.p++;
  uint64_t sel = OBJ_SEED;
  c.ws();
  if (c.at('}')) {
    c.p++;
    ev.fp_meta_sel = sel;
    return;
  }
  while (c.ok) {
    c.ws();
    const char* ks;
    int64_t kn;
    if (!raw_string(c, &ks, &kn)) break;
    c.ws();
    c.expect(':');
    c.ws();
    Span key{ks, kn};
    if (span_eq(key, "name") && c.at('"')) {
      raw_string(c, &ev.name.p, &ev.name.n);
    } else if (span_eq(key, "namespace") && c.at('"')) {
      raw_string(c, &ev.ns.p, &ev.ns.n);
    } else if (span_eq(key, "creationTimestamp") && c.at('"')) {
      raw_string(c, &ev.creation.p, &ev.creation.n);
    } else if (span_eq(key, "resourceVersion") && c.at('"')) {
      // parsed HERE, at metadata's own nesting depth: a raw substring
      // scan can latch an annotation literally named resourceVersion
      // when annotations serialize before metadata.resourceVersion
      // (insertion-ordered servers do this). Server-stamped digits;
      // anything non-numeric stays 0.
      Span rvs;
      raw_string(c, &rvs.p, &rvs.n);
      int64_t v = 0;
      bool num = rvs.n > 0;
      for (int64_t j = 0; j < rvs.n && num; j++) {
        char ch = rvs.p[j];
        if (ch < '0' || ch > '9' ||
            v > (INT64_MAX - (ch - '0')) / 10) {
          // non-digit, or the value would overflow int64 (etcd revisions
          // are int64; anything wider is garbage): leave rv = 0 rather
          // than latch a wrapped/negative resume revision
          num = false;
        } else {
          v = v * 10 + (ch - '0');
        }
      }
      if (num) ev.rv = v;
    } else if (span_eq(key, "deletionTimestamp")) {
      ev.has_deletion = !(c.p + 4 <= c.end && memcmp(c.p, "null", 4) == 0);
      skip_value(c);
    } else if (span_eq(key, "finalizers")) {
      const char* before = c.p;
      skip_value(c);
      // non-empty array?
      for (const char* q = before; q < c.p; q++) {
        if (*q == '[') continue;
        if (*q == ' ' || *q == '\n' || *q == '\t' || *q == '\r') continue;
        ev.has_finalizers = (*q != ']');
        break;
      }
      sel ^= mix(fnv(ks, kn), fnv(before, c.p - before));
    } else if (span_eq(key, "labels") || span_eq(key, "annotations")) {
      uint64_t vfp = fp_value(c);
      sel ^= mix(fnv(ks, kn), vfp);
    } else {
      skip_value(c);
    }
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect('}');
  sel = mix(sel, (uint64_t)ev.has_deletion << 1 | (uint64_t)ev.has_finalizers);
  ev.fp_meta_sel = sel;
}

void walk_spec(Cursor& c, Event& ev) {
  c.ws();
  if (!c.at('{')) {
    ev.fp_spec = fp_value(c);
    return;
  }
  c.p++;
  uint64_t h = OBJ_SEED;
  c.ws();
  if (c.at('}')) {
    c.p++;
    ev.fp_spec = h;
    return;
  }
  while (c.ok) {
    c.ws();
    const char* ks;
    int64_t kn;
    if (!raw_string(c, &ks, &kn)) break;
    c.ws();
    c.expect(':');
    c.ws();
    Span key{ks, kn};
    if (span_eq(key, "nodeName") && c.at('"')) {
      raw_string(c, &ev.node_name.p, &ev.node_name.n);
      h ^= mix(fnv(ks, kn),
               fnv(ev.node_name.p, ev.node_name.n) ^ 0x5bd1e995u);
    } else if (span_eq(key, "containers")) {
      h ^= mix(fnv(ks, kn), fp_container_array(c, &ev.containers));
    } else if (span_eq(key, "initContainers")) {
      h ^= mix(fnv(ks, kn), fp_container_array(c, &ev.init_containers));
    } else if (span_eq(key, "readinessGates")) {
      const char* before = c.p;
      uint64_t vfp = fp_value(c);
      h ^= mix(fnv(ks, kn), vfp);
      for (const char* q = before; q < c.p; q++) {
        if (*q == '[') continue;
        if (*q == ' ' || *q == '\n' || *q == '\t' || *q == '\r') continue;
        ev.has_readiness_gates = (*q != ']');
        break;
      }
    } else {
      uint64_t vfp = fp_value(c);
      h ^= mix(fnv(ks, kn), vfp);
    }
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect('}');
  ev.fp_spec = h;
}

// Parse {"type":"...","object":{...}} (a watch line) or a bare object (a
// List item). Populates ev; ev.ok=false routes the caller to Python.
void parse_event(const char* data, int64_t n, Event& ev) {
  Cursor c{data, data + n};
  c.ws();
  if (!c.at('{')) return;
  c.p++;
  bool saw_object = false;
  while (c.ok) {
    c.ws();
    const char* ks;
    int64_t kn;
    if (!raw_string(c, &ks, &kn)) break;
    c.ws();
    c.expect(':');
    c.ws();
    Span key{ks, kn};
    if (span_eq(key, "type") && c.at('"')) {
      raw_string(c, &ev.type.p, &ev.type.n);
    } else if (span_eq(key, "object")) {
      // nested object document
      c.ws();
      if (!c.at('{')) {
        skip_value(c);
      } else {
        saw_object = true;
        c.p++;
        while (c.ok) {
          c.ws();
          const char* oks;
          int64_t okn;
          if (!raw_string(c, &oks, &okn)) break;
          c.ws();
          c.expect(':');
          Span okey{oks, okn};
          if (span_eq(okey, "metadata")) walk_metadata(c, ev);
          else if (span_eq(okey, "spec")) walk_spec(c, ev);
          else if (span_eq(okey, "status")) walk_status(c, ev);
          else skip_value(c);
          c.ws();
          if (c.at(',')) {
            c.p++;
            continue;
          }
          break;
        }
        c.expect('}');
      }
    } else if (span_eq(key, "metadata")) {
      // bare object form (List item)
      walk_metadata(c, ev);
      saw_object = true;
    } else if (span_eq(key, "spec")) {
      walk_spec(c, ev);
      saw_object = true;
    } else if (span_eq(key, "status")) {
      walk_status(c, ev);
      saw_object = true;
    } else {
      skip_value(c);
    }
    c.ws();
    if (c.at(',')) {
      c.p++;
      continue;
    }
    break;
  }
  c.expect('}');
  ev.ok = c.ok && saw_object && ev.name.present();
}

}  // namespace

extern "C" {

// Parse n event lines (concatenated, offsets delimit). Fixed-width outputs
// per event; string fields are copied into str_out with per-event offsets
// for (type, ns, name, nodeName, phase, podIP, hostIP, creationTimestamp,
// containers, initContainers, trueConditions) — 11 strings per event, so
// str_off has 11*n+1 entries. Containers are "name\x1fimage" records
// joined by \x1e (the codec renderer's input format); trueConditions are
// condition types with status True joined by \x1f. Returns total string
// bytes needed (if > str_cap, call again with a bigger buffer).
// flags bit 0 = parse ok, 1 = has_deletion, 2 = has_finalizers,
// 3 = has_readiness_gates, 4 = status has scalar-replace keys only;
// bits 5-6 = event type code (1 ADDED, 2 MODIFIED, 3 DELETED, 0 other).
//
// Pre-partitioned routing (ABI 7): with n_shards >= 1 the parser also
// computes each event's lane (shard_of_event — the same crc32 mapping as
// rowpool.shard_of) and counting-sorts routable records into per-lane
// contiguous index runs, so the engine's router hands each lane ONE
// zero-copy sub-batch instead of hashing+dispatching per event in Python:
//   shard_out[i]: lane id >= 0, or -1 (record without a name, or with
//                 JSON escapes in ns/name — either way only the Python
//                 router can place it), -2 (ERROR event), -3 (BOOKMARK)
//   lane_idx[ /  lane_off ]: routable record indexes partitioned by lane
//                 (stable: original order within each lane); lane_off has
//                 n_shards+1 entries
//   route_info: [0] the resume revision a full Python walk would commit:
//               the latest metadata rv, ZEROED once an ERROR appears
//               (rv_dead — nothing before or after a stream error
//               commits), [1] index of the first ERROR event or -1,
//               [2] bookmark count,
//               [3] routable count, [4] nameless-record count
// With n_shards == 0 the four routing outputs may be null (legacy paths).
int64_t kwok_parse_events(
    const char* blob, const int64_t* off, int32_t n,
    uint64_t* fp_status, uint64_t* fp_status_nc, uint64_t* fp_spec,
    uint64_t* fp_meta_sel, uint8_t* flags, int64_t* rv_out,
    char* str_out, int64_t str_cap, int64_t* str_off,
    int32_t kind_is_pods, int32_t n_shards,
    int32_t* shard_out, int32_t* lane_idx, int64_t* lane_off,
    int64_t* route_info) {
  int64_t used = 0;
  auto put_bytes = [&](const char* p, int64_t len) {
    if (p && len > 0) {
      if (used + len <= str_cap) memcpy(str_out + used, p, len);
      used += len;
    }
  };
  auto put = [&](const Span& s, int64_t slot) {
    str_off[slot] = used;
    put_bytes(s.p, s.n);
  };
  auto put_ctrs = [&](const std::vector<std::pair<Span, Span>>& cs,
                      int64_t slot) {
    str_off[slot] = used;
    for (size_t j = 0; j < cs.size(); j++) {
      if (j) put_bytes("\x1e", 1);
      put_bytes(cs[j].first.p, cs[j].first.n);
      put_bytes("\x1f", 1);
      put_bytes(cs[j].second.p, cs[j].second.n);
    }
  };
  auto has_esc = [](const Span& s) {
    return s.p && s.n > 0 && memchr(s.p, '\\', (size_t)s.n) != nullptr;
  };
  int64_t latest_rv = 0;
  int64_t first_error = -1;
  int64_t bookmarks = 0;
  int64_t routable = 0;
  int64_t nameless = 0;
  for (int32_t i = 0; i < n; i++) {
    Event ev;
    parse_event(blob + off[i], off[i + 1] - off[i], ev);
    fp_status[i] = ev.fp_status;
    fp_status_nc[i] = ev.fp_status_nc;
    fp_spec[i] = ev.fp_spec;
    fp_meta_sel[i] = ev.fp_meta_sel;
    rv_out[i] = ev.rv;
    uint8_t tcode = 0;
    if (span_eq(ev.type, "ADDED")) tcode = 1;
    else if (span_eq(ev.type, "MODIFIED")) tcode = 2;
    else if (span_eq(ev.type, "DELETED")) tcode = 3;
    if (n_shards >= 1) {
      int32_t shard;
      if (span_eq(ev.type, "ERROR")) {
        shard = -2;
        if (first_error < 0) {
          first_error = i;
          // match the Python walk exactly: an ERROR zeroes the pending
          // resume revision (rv_dead) — the pre-error rv must not be
          // committable either
          latest_rv = 0;
        }
      } else if (span_eq(ev.type, "BOOKMARK")) {
        shard = -3;
        bookmarks++;
      } else if (ev.name.n > 0 &&
                 !memchr(ev.name.p, '\\', (size_t)ev.name.n) &&
                 !(ev.ns.n > 0 &&
                   memchr(ev.ns.p, '\\', (size_t)ev.ns.n))) {
        shard = shard_of_event(ev.ns, ev.name, kind_is_pods, n_shards);
        routable++;
      } else {
        // no name, or JSON escapes in ns/name: the Python router hashes
        // the DECODED string while we'd hash raw token bytes — the same
        // key could land on two different lanes across the fast/slow
        // paths. Classify as unrouteable so the whole batch takes the
        // per-record Python walk (one router, one mapping).
        shard = -1;
        nameless++;
      }
      shard_out[i] = shard;
      // the resume-revision walk _drain_flush_kind used to do per record:
      // nothing after a stream ERROR counts
      if (ev.rv && first_error < 0) latest_rv = ev.rv;
    }
    // JSON escapes in any extracted string downgrade the record: the
    // fast path ships raw token bytes, which would mis-render escaped
    // values (the Python side used to re-scan every field for this;
    // doing it here keeps `flags` authoritative so echo-dropped events
    // never materialize their strings at all). Escapes in the container/
    // condition blobs additionally invalidate the scalar-status claim.
    bool esc_str = has_esc(ev.type) || has_esc(ev.ns) || has_esc(ev.name) ||
                   has_esc(ev.node_name) || has_esc(ev.phase) ||
                   has_esc(ev.pod_ip) || has_esc(ev.host_ip) ||
                   has_esc(ev.creation);
    bool esc_blob = false;
    for (const auto& pr : ev.containers)
      esc_blob = esc_blob || has_esc(pr.first) || has_esc(pr.second);
    for (const auto& pr : ev.init_containers)
      esc_blob = esc_blob || has_esc(pr.first) || has_esc(pr.second);
    for (const auto& s : ev.true_conditions)
      esc_blob = esc_blob || has_esc(s);
    uint8_t f = (uint8_t)(ev.ok | (ev.has_deletion << 1) |
                          (ev.has_finalizers << 2) |
                          (ev.has_readiness_gates << 3) |
                          (ev.status_scalar_only << 4));
    if (esc_str || esc_blob) f = (uint8_t)(f & ~1u);
    if (esc_blob) f = (uint8_t)(f & ~16u);
    f = (uint8_t)(f | (tcode << 5));
    flags[i] = f;
    int64_t base = (int64_t)i * 11;
    put(ev.type, base + 0);
    put(ev.ns, base + 1);
    put(ev.name, base + 2);
    put(ev.node_name, base + 3);
    put(ev.phase, base + 4);
    put(ev.pod_ip, base + 5);
    put(ev.host_ip, base + 6);
    put(ev.creation, base + 7);
    put_ctrs(ev.containers, base + 8);
    put_ctrs(ev.init_containers, base + 9);
    str_off[base + 10] = used;
    for (size_t j = 0; j < ev.true_conditions.size(); j++) {
      if (j) put_bytes("\x1f", 1);
      put_bytes(ev.true_conditions[j].p, ev.true_conditions[j].n);
    }
  }
  str_off[(int64_t)n * 11] = used;
  if (n_shards >= 1) {
    // counting sort of routable records into per-lane contiguous runs
    // (stable: original order within each lane == the order the Python
    // per-event router would have enqueued them)
    for (int32_t s = 0; s <= n_shards; s++) lane_off[s] = 0;
    for (int32_t i = 0; i < n; i++)
      if (shard_out[i] >= 0) lane_off[shard_out[i] + 1]++;
    for (int32_t s = 0; s < n_shards; s++) lane_off[s + 1] += lane_off[s];
    std::vector<int64_t> cursor(lane_off, lane_off + n_shards);
    for (int32_t i = 0; i < n; i++) {
      int32_t s = shard_out[i];
      if (s >= 0) lane_idx[cursor[s]++] = i;
    }
    route_info[0] = latest_rv;
    route_info[1] = first_error;
    route_info[2] = bookmarks;
    route_info[3] = routable;
    route_info[4] = nameless;
  }
  return used;
}

// Fingerprint the "status" subtree of each rendered patch body
// ({"status":{...}}), with the SAME algorithm the event parser uses — the
// engine stores these as the expected post-patch status fingerprint.
void kwok_fingerprint_statuses(const char* blob, const int64_t* off,
                               int32_t n, uint64_t* out) {
  for (int32_t i = 0; i < n; i++) {
    Cursor c{blob + off[i], blob + off[i + 1]};
    c.ws();
    uint64_t fp = 0;
    if (c.at('{')) {
      c.p++;
      while (c.ok) {
        c.ws();
        const char* ks;
        int64_t kn;
        if (!raw_string(c, &ks, &kn)) break;
        c.ws();
        c.expect(':');
        if (kn == 6 && memcmp(ks, "status", 6) == 0) {
          Event ev;
          walk_status(c, ev);
          fp = ev.fp_status;
        } else {
          skip_value(c);
        }
        c.ws();
        if (c.at(',')) {
          c.p++;
          continue;
        }
        break;
      }
    }
    out[i] = fp;
  }
}

}  // extern "C"

// --------------------------------------------------------------- watch IO
// Native watch-line reader: owns the socket AFTER the Python client has
// completed the HTTP handshake (headers consumed; any body bytes already
// buffered on the Python side are handed over verbatim). De-chunks the
// transfer encoding and returns BATCHES of newline-delimited event lines
// per call — the Python per-line chunked-read loop (http.client readline,
// one lock dance + several method calls per event) was the largest
// remaining per-event Python term on the ingest edge. Parsing semantics
// are untouched: lines go to the same EventParser, ERROR handling and
// resume-revision bookkeeping stay in the engine.

#include <errno.h>
#include <poll.h>
#include <sys/socket.h>

#include <string>

namespace {

struct WatchReader {
  int fd;
  std::string in;    // raw socket bytes, not yet de-chunked
  size_t in_off = 0;
  std::string body;  // de-chunked bytes pending line split
  size_t body_off = 0;
  // -1: awaiting a chunk-size line; -2: awaiting the CRLF after a chunk
  // payload; >=0: payload bytes left in the current chunk
  long long chunk_left = -1;
  bool identity = false;  // no Transfer-Encoding: body runs to EOF
  bool eof = false;
};

// moves complete chunks from `in` to `body`; tolerant of any chunk/event
// alignment (an event may span chunks; a chunk may carry many events)
void dechunk(WatchReader& r) {
  if (r.identity) {
    r.body.append(r.in, r.in_off, std::string::npos);
    r.in.clear();
    r.in_off = 0;
    return;
  }
  while (r.in_off < r.in.size()) {
    if (r.chunk_left == -1) {
      size_t crlf = r.in.find("\r\n", r.in_off);
      if (crlf == std::string::npos) break;  // size line incomplete
      long long size = 0;
      bool any = false;
      for (size_t p = r.in_off; p < crlf; p++) {
        char c = r.in[p];
        int v;
        if (c >= '0' && c <= '9') v = c - '0';
        else if (c >= 'a' && c <= 'f') v = c - 'a' + 10;
        else if (c >= 'A' && c <= 'F') v = c - 'A' + 10;
        else break;  // chunk extension (";...") or junk: stop at it
        size = size * 16 + v;
        any = true;
      }
      r.in_off = crlf + 2;
      if (!any || size == 0) {
        // malformed size line or the terminating 0-chunk (trailers
        // ignored): the stream is over either way
        r.eof = true;
        r.in.clear();
        r.in_off = 0;
        return;
      }
      r.chunk_left = size;
    } else if (r.chunk_left > 0) {
      size_t avail = r.in.size() - r.in_off;
      size_t take = avail < (size_t)r.chunk_left ? avail : (size_t)r.chunk_left;
      r.body.append(r.in, r.in_off, take);
      r.in_off += take;
      r.chunk_left -= (long long)take;
      if (r.chunk_left == 0) r.chunk_left = -2;
      if (r.in_off >= r.in.size()) break;
    } else {  // -2: CRLF after payload
      if (r.in.size() - r.in_off < 2) break;
      r.in_off += 2;
      r.chunk_left = -1;
    }
  }
  if (r.in_off) {
    r.in.erase(0, r.in_off);
    r.in_off = 0;
  }
}

constexpr const char* kErrPrefix = "{\"type\":\"ERROR\"";
constexpr size_t kErrPrefixLen = 15;

}  // namespace

extern "C" {

void* kwok_watch_open(int fd, const char* initial, int64_t n, int identity) {
  auto* r = new WatchReader();
  r->fd = fd;
  r->identity = identity != 0;
  if (initial && n > 0) r->in.assign(initial, (size_t)n);
  return r;
}

void kwok_watch_close(void* h) { delete static_cast<WatchReader*>(h); }

// Returns: >0 = number of lines written to out/out_off (off has n+1
// entries, lines are \n- and \r-stripped); 0 = timeout, nothing ready;
// -1 = end of stream (no more lines will ever come; a partial trailing
// line is dropped — the resume revision replays it); -2 = a single line
// exceeds out_cap, *need holds the required capacity. *err is set to 1
// when the LAST returned line matched the ERROR-event prefix (no further
// lines are consumed past it this call).
int64_t kwok_watch_read(void* h, int timeout_ms, char* out, int64_t out_cap,
                        int64_t* out_off, int64_t max_lines, int32_t* err,
                        int64_t* need) {
  auto* r = static_cast<WatchReader*>(h);
  *err = 0;
  *need = 0;
  int64_t n = 0;
  int64_t used = 0;
  out_off[0] = 0;
  for (;;) {
    dechunk(*r);
    // split body into lines
    while (n < max_lines) {
      size_t nl = r->body.find('\n', r->body_off);
      if (nl == std::string::npos) break;
      size_t start = r->body_off;
      size_t end = nl;
      if (end > start && r->body[end - 1] == '\r') end--;
      size_t len = end - start;
      if (len == 0) {  // blank keep-alive line
        r->body_off = nl + 1;
        continue;
      }
      if (used + (int64_t)len > out_cap) {
        if (n == 0) {
          *need = (int64_t)len;
          return -2;
        }
        goto done;  // deliver what fits; rest next call
      }
      bool is_err = len >= kErrPrefixLen &&
                    memcmp(r->body.data() + start, kErrPrefix,
                           kErrPrefixLen) == 0;
      memcpy(out + used, r->body.data() + start, len);
      used += len;
      n++;
      out_off[n] = used;
      r->body_off = nl + 1;
      if (is_err) {
        *err = 1;
        goto done;  // nothing past a stream error is consumed this call
      }
    }
    if (n > 0) goto done;
    if (r->eof) return -1;
    // nothing complete buffered: wait for the socket
    struct pollfd pfd{r->fd, POLLIN, 0};
    int pr = poll(&pfd, 1, timeout_ms);
    if (pr == 0) return 0;  // timeout
    if (pr < 0) {
      if (errno == EINTR) return 0;  // PEP-475: a signal is not a hangup
      r->eof = true;
      return -1;
    }
    char tmp[65536];
    ssize_t got = recv(r->fd, tmp, sizeof tmp, 0);
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) {
      r->eof = true;
      // fall through once more: the final dechunk may complete lines
      dechunk(*r);
      continue;
    }
    r->in.append(tmp, (size_t)got);
  }
done:
  if (r->body_off > (1u << 20) ||
      (r->body_off && r->body_off == r->body.size())) {
    r->body.erase(0, r->body_off);
    r->body_off = 0;
  }
  return n;
}

}  // extern "C"
