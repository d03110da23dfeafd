// kwok_tpu native codec: batched JSON egress rendering.
//
// The host-side hot path of the engine is turning dirty rows into
// Kubernetes status-patch JSON (the replacement for the reference's
// per-object template rendering, pkg/kwok/controllers/renderer.go:49-89).
// Python dict building + json.dumps dominates at O(100k) rows; this
// library assembles the same bytes in one pass over flat blobs.
//
// Deliberately k8s-agnostic: all strings (condition metadata, phase names,
// timestamps, ips, container specs) arrive as caller-provided blobs with
// offset arrays, so the JSON *shape* lives here and the vocabulary stays in
// Python (kwok_tpu/edge/render.py is the semantic source of truth; parity
// is enforced by tests/test_native.py).
//
// Memory contract: every function returns the total bytes required. If that
// exceeds out_cap nothing useful is in `out`; the caller re-allocates and
// calls again. Per-row boundaries are written to out_off[0..n] so callers
// can slice row i as out[out_off[i]:out_off[i+1]].
//
// Build: g++ -O2 -shared -fPIC -o libkwokcodec.so codec.cc  (see __init__.py)

#include <cstdint>
#include <cstring>

namespace {

struct Buf {
  char* out;
  int64_t cap;
  int64_t len;  // bytes written (capped) — `need` tracks true size

  inline void put(const char* s, int64_t n) {
    if (len + n <= cap) {
      std::memcpy(out + len, s, n);
    }
    len += n;
  }
  inline void put(char c) {
    if (len + 1 <= cap) {
      out[len] = c;
    }
    len += 1;
  }
  inline void lit(const char* s) { put(s, (int64_t)std::strlen(s)); }

  // JSON-escaped string content (no surrounding quotes).
  void esc(const char* s, int64_t n) {
    static const char hex[] = "0123456789abcdef";
    for (int64_t i = 0; i < n; i++) {
      unsigned char c = (unsigned char)s[i];
      switch (c) {
        case '"': lit("\\\""); break;
        case '\\': lit("\\\\"); break;
        case '\n': lit("\\n"); break;
        case '\r': lit("\\r"); break;
        case '\t': lit("\\t"); break;
        default:
          if (c < 0x20) {
            char u[7] = {'\\', 'u', '0', '0', hex[c >> 4], hex[c & 15], 0};
            put(u, 6);
          } else {
            put((char)c);
          }
      }
    }
  }
  inline void qesc(const char* s, int64_t n) {
    put('"');
    esc(s, n);
    put('"');
  }
};

struct Slices {
  const char* blob;
  const int64_t* off;
  inline const char* ptr(int64_t i) const { return blob + off[i]; }
  inline int64_t len(int64_t i) const { return off[i + 1] - off[i]; }
};

inline void put_kv(Buf& b, const char* key, const char* v, int64_t vn) {
  b.put('"');
  b.lit(key);
  b.lit("\":");
  b.qesc(v, vn);
}

// containerStatuses / initContainerStatuses array CONTENT (no brackets)
// from packed records "name\x1fimage\x1e...". init=true renders the
// terminated-Completed init-container shape regardless of kind. ONE copy
// shared by the legacy batch renderer and the template splicer, so the
// two paths cannot drift byte-wise. `ready` is passed separately from
// `kind`: render.py marks containers ready ONLY in phase Running, while
// the container STATE tracks terminated-vs-running — the legacy caller
// collapses the two (its historical shape), the template caller bakes
// ready per phase at compile time, matching render.py exactly.
void put_containers(Buf& b, const char* cs, int64_t cn, uint8_t kind,
                    bool ready, const char* st, int64_t stn, bool init) {
  int64_t pos = 0;
  bool first = true;
  while (pos < cn) {
    const char* rec = cs + pos;
    const char* rec_end = (const char*)std::memchr(rec, '\x1e', cn - pos);
    int64_t rec_len = rec_end ? rec_end - rec : cn - pos;
    const char* sep = (const char*)std::memchr(rec, '\x1f', rec_len);
    int64_t name_len = sep ? sep - rec : rec_len;
    const char* img = sep ? sep + 1 : rec + rec_len;
    int64_t img_len = sep ? rec + rec_len - img : 0;
    if (!first) b.put(',');
    first = false;
    b.lit("{\"image\":");
    b.qesc(img, img_len);
    b.lit(",\"name\":");
    b.qesc(rec, name_len);
    if (init) {
      b.lit(
          ",\"ready\":true,\"restartCount\":0,\"state\":{\"terminated\":"
          "{\"exitCode\":0,\"finishedAt\":");
      b.qesc(st, stn);
      b.lit(",\"reason\":\"Completed\",\"startedAt\":");
      b.qesc(st, stn);
      b.lit("}}}");
    } else {
      b.lit(",\"ready\":");
      b.lit(ready ? "true" : "false");
      b.lit(",\"restartCount\":0,\"state\":");
      if (kind == 0) {
        b.lit("{\"running\":{\"startedAt\":");
        b.qesc(st, stn);
        b.lit("}}");
      } else {
        b.lit("{\"terminated\":{\"exitCode\":");
        b.lit(kind == 1 ? "0" : "1");
        b.lit(",\"finishedAt\":");
        b.qesc(st, stn);
        b.lit(",\"reason\":");
        b.lit(kind == 1 ? "\"Completed\"" : "\"Error\"");
        b.lit(",\"startedAt\":");
        b.qesc(st, stn);
        b.lit("}}");
      }
      b.put('}');
    }
    pos += rec_len + (rec_end ? 1 : 0);
  }
}

}  // namespace

// cross-TU internals of libkwokcodec.so (same shared object):
// the canonical status fingerprint (ingest.cc) and the prefixed batch
// send (pump.cc) the fused emit call composes with.
extern "C" void kwok_fingerprint_statuses(const char* blob,
                                          const int64_t* off, int32_t n,
                                          uint64_t* out);
extern "C" int64_t kwok_pump_send2(
    int64_t handle, int32_t n, const char* method, const char* base,
    int64_t base_len, const char* path_blob, const int64_t* path_off,
    const char* suffix, int64_t suffix_len, const char* ctype,
    int64_t ctype_len, const char* body_blob, const int64_t* body_off,
    int32_t* status_out);

extern "C" {

// {"conditions":[{lastHeartbeatTime,lastTransitionTime,message,reason,
//                 status,type} x n_conds]}
// cond_meta holds 3*n_conds strings laid out (type, reason, message) per
// condition; status of condition j for row i = bit j of cond_bits[i].
int64_t kwok_render_heartbeats(
    int32_t n_rows, const uint32_t* cond_bits, int32_t n_conds,
    const char* cond_meta_blob, const int64_t* cond_meta_off,
    const char* now, int32_t now_len,
    const char* start_blob, const int64_t* start_off,
    char* out, int64_t out_cap, int64_t* out_off) {
  Buf b{out, out_cap, 0};
  Slices meta{cond_meta_blob, cond_meta_off};
  Slices start{start_blob, start_off};
  for (int32_t i = 0; i < n_rows; i++) {
    out_off[i] = b.len;
    b.lit("{\"status\":{\"conditions\":[");
    uint32_t bits = cond_bits[i];
    for (int32_t j = 0; j < n_conds; j++) {
      if (j) b.put(',');
      b.lit("{\"lastHeartbeatTime\":");
      b.qesc(now, now_len);
      b.lit(",\"lastTransitionTime\":");
      b.qesc(start.ptr(i), start.len(i));
      b.put(',');
      put_kv(b, "message", meta.ptr(3 * j + 2), meta.len(3 * j + 2));
      b.put(',');
      put_kv(b, "reason", meta.ptr(3 * j + 1), meta.len(3 * j + 1));
      b.lit(",\"status\":");
      b.lit((bits >> j) & 1 ? "\"True\"" : "\"False\"");
      b.lit(",\"type\":");
      b.qesc(meta.ptr(3 * j), meta.len(3 * j));
      b.put('}');
    }
    b.lit("]}}");
  }
  out_off[n_rows] = b.len;
  return b.len;
}

// Full pod status patch per row:
// {"status":{"conditions":[3],"containerStatuses":[...],
//   "initContainerStatuses":[...],"hostIP","podIP","phase","startTime"}}
// phase_kind: 0 = running-like, 1 = terminated-ok, 2 = terminated-error.
// Container specs per row: fields separated by \x1f, containers by \x1e
// ("name\x1fimage\x1ename\x1fimage").
int64_t kwok_render_pod_statuses(
    int32_t n_rows, const uint8_t* phase_kind, const uint32_t* cond_bits,
    const char* phase_blob, const int64_t* phase_off,
    int32_t n_conds,
    const char* cond_names_blob, const int64_t* cond_names_off,
    const char* host_blob, const int64_t* host_off,
    const char* pod_blob, const int64_t* pod_off,
    const char* start_blob, const int64_t* start_off,
    const char* ctr_blob, const int64_t* ctr_off,
    const char* ictr_blob, const int64_t* ictr_off,
    char* out, int64_t out_cap, int64_t* out_off) {
  Buf b{out, out_cap, 0};
  Slices phase{phase_blob, phase_off};
  Slices cname{cond_names_blob, cond_names_off};
  Slices host{host_blob, host_off};
  Slices pod{pod_blob, pod_off};
  Slices start{start_blob, start_off};
  Slices ctr{ctr_blob, ctr_off};
  Slices ictr{ictr_blob, ictr_off};

  for (int32_t i = 0; i < n_rows; i++) {
    out_off[i] = b.len;
    const char* st = start.ptr(i);
    int64_t stn = start.len(i);
    uint8_t kind = phase_kind[i];

    b.lit("{\"status\":{\"conditions\":[");
    uint32_t bits = cond_bits[i];
    for (int32_t j = 0; j < n_conds; j++) {
      if (j) b.put(',');
      b.lit("{\"lastTransitionTime\":");
      b.qesc(st, stn);
      b.lit(",\"status\":");
      b.lit((bits >> j) & 1 ? "\"True\"" : "\"False\"");
      b.lit(",\"type\":");
      b.qesc(cname.ptr(j), cname.len(j));
      b.put('}');
    }
    b.lit("],\"containerStatuses\":[");
    put_containers(b, ctr.ptr(i), ctr.len(i), kind, kind == 0, st, stn,
                   false);
    b.lit("],\"initContainerStatuses\":[");
    put_containers(b, ictr.ptr(i), ictr.len(i), kind, kind == 0, st, stn,
                   true);
    b.lit("],\"hostIP\":");
    b.qesc(host.ptr(i), host.len(i));
    b.lit(",\"podIP\":");
    b.qesc(pod.ptr(i), pod.len(i));
    b.lit(",\"phase\":");
    b.qesc(phase.ptr(i), phase.len(i));
    b.lit(",\"startTime\":");
    b.qesc(st, stn);
    b.lit("}}");
  }
  out_off[n_rows] = b.len;
  return b.len;
}

// AOT-template emit (ISSUE 14): splice per-row values into the compiled
// patch-body templates (models/compiler.py EmitTemplates wire format) and
// — when `pump` names an open pump — ship the whole batch in the SAME
// call, so a dirty-row batch goes template -> body slab -> wire without
// re-entering Python.
//
// Segment codes (keep in lockstep with compiler.py EMIT_*):
//   0 literal [seg_a=lit offset, seg_b=len]   1 start time ("" -> now)
//   2 hostIP   3 podIP   4 containers   5 init containers
//   6 condition status '"True"'/'"False"' from cond bit seg_a
//
// Memory contract: same as the renderers above — returns total body
// bytes required; if that exceeds out_cap NOTHING was fingerprinted or
// sent (the caller re-allocates and calls again), so the send happens
// exactly once. On success fp_out[i] (when non-null) carries each body's
// canonical status fingerprint (ingest.cc's algorithm — the echo-drop
// seed), and with a pump the batch is sent as
// "PATCH {base}{path[i]}{suffix}" with content type `ctype`, statuses in
// status_out (pump.cc failure contract: 0 = connection death).
int64_t kwok_emit_pods(
    int64_t pump, int32_t n_rows,
    const int32_t* tpl_id, const uint32_t* cond_bits,
    const char* lit_blob, const int32_t* seg_code, const int64_t* seg_a,
    const int64_t* seg_b, const int64_t* tpl_off, const uint8_t* tpl_kind,
    const uint8_t* tpl_ready,
    const char* host_blob, const int64_t* host_off,
    const char* pod_blob, const int64_t* pod_off,
    const char* start_blob, const int64_t* start_off,
    const char* ctr_blob, const int64_t* ctr_off,
    const char* ictr_blob, const int64_t* ictr_off,
    const char* now, int32_t now_len,
    char* out, int64_t out_cap, int64_t* out_off,
    uint64_t* fp_out,
    const char* base, int64_t base_len,
    const char* path_blob, const int64_t* path_off,
    const char* suffix, int64_t suffix_len,
    const char* ctype, int64_t ctype_len,
    int32_t* status_out) {
  Buf b{out, out_cap, 0};
  Slices host{host_blob, host_off};
  Slices pod{pod_blob, pod_off};
  Slices start{start_blob, start_off};
  Slices ctr{ctr_blob, ctr_off};
  Slices ictr{ictr_blob, ictr_off};
  for (int32_t i = 0; i < n_rows; i++) {
    out_off[i] = b.len;
    int32_t t = tpl_id[i];
    const char* st = start.ptr(i);
    int64_t stn = start.len(i);
    if (stn == 0) {  // absent creationTimestamp: the batch-hoisted now
      st = now;
      stn = now_len;
    }
    uint8_t kind = tpl_kind[t];
    bool ready = tpl_ready[t] != 0;
    uint32_t bits = cond_bits[i];
    for (int64_t s = tpl_off[t]; s < tpl_off[t + 1]; s++) {
      switch (seg_code[s]) {
        case 0: b.put(lit_blob + seg_a[s], seg_b[s]); break;
        case 1: b.esc(st, stn); break;
        case 2: b.esc(host.ptr(i), host.len(i)); break;
        case 3: b.esc(pod.ptr(i), pod.len(i)); break;
        case 4: put_containers(b, ctr.ptr(i), ctr.len(i), kind, ready, st,
                               stn, false); break;
        case 5: put_containers(b, ictr.ptr(i), ictr.len(i), kind, ready,
                               st, stn, true); break;
        case 6: b.lit((bits >> seg_a[s]) & 1 ? "\"True\"" : "\"False\"");
                break;
      }
    }
  }
  out_off[n_rows] = b.len;
  if (b.len > out_cap) return b.len;  // nothing fingerprinted, nothing sent
  if (fp_out) kwok_fingerprint_statuses(out, out_off, n_rows, fp_out);
  if (pump && status_out) {
    kwok_pump_send2(pump, n_rows, "PATCH", base, base_len, path_blob,
                    path_off, suffix, suffix_len, ctype, ctype_len, out,
                    out_off, status_out);
  }
  return b.len;
}

// Keep in lockstep with ABI_VERSION in native/__init__.py — a mismatch
// triggers delete+rebuild loops (and bricks hosts without a compiler).
// ABI 9: kwok_emit_pods (AOT-template splice + fused pump send) and
// pump.cc kwok_pump_send2.
int32_t kwok_codec_abi_version() { return 9; }

}  // extern "C"
