// kwok-mock-apiserver: native in-memory kube-apiserver for the mock runtime.
//
// The Python HttpFakeApiserver (kwok_tpu/edge/mockserver.py) is the semantic
// source of truth; this binary speaks the same wire protocol at native
// speed so the lab apiserver is never the wall when benchmarking the
// engine's watch/patch edge (SURVEY.md §7 "Hard parts": the edge, not the
// math, is the bottleneck; the reference sidesteps it by being slow).
// kwokctl's mock runtime prefers this binary when a compiler is available
// and falls back to the Python shim otherwise; both serve:
//
//   GET    /healthz                      -> "ok"
//   GET    /snapshot                     -> whole-store dump (mock etcdctl)
//   POST   /restore                      -> replace store, close watches
//   GET    /api/v1[/namespaces/NS]/KIND              list (+watch=true)
//   GET    /api/v1[/namespaces/NS]/KIND/NAME         get
//   POST   /api/v1[/namespaces/NS]/KIND              create
//   PATCH  /api/v1[/namespaces/NS]/KIND/NAME[/status] strategic-merge status
//                                                     / merge-patch meta+spec
//   DELETE /api/v1[/namespaces/NS]/KIND/NAME         (graceful for pods)
//
// Concurrency model: thread-per-connection (connection counts are bounded:
// engine watches + patch pool + loaders), one store mutex. Each watch event
// is serialized ONCE and the bytes shared across all matching watchers.
// JSON numbers are kept as raw token text end-to-end so stored objects
// round-trip byte-exactly.
//
// Build: g++ -O2 -std=c++17 -pthread -o kwok-mock-apiserver apiserver.cc

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <chrono>
#include <thread>
#include <utility>
#include <vector>

// ---------------------------------------------------------------- JSON DOM

struct JVal;
using JObj = std::vector<std::pair<std::string, JVal>>;  // insertion order

struct JVal {
  enum Type : uint8_t { NUL, BOOL, NUM, STR, ARR, OBJ } type = NUL;
  bool b = false;
  std::string s;  // STR: decoded text; NUM: raw token text
  std::vector<JVal> arr;
  JObj obj;

  bool is_obj() const { return type == OBJ; }
  const JVal* find(const std::string& k) const {
    if (type != OBJ) return nullptr;
    for (const auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  JVal* find(const std::string& k) {
    if (type != OBJ) return nullptr;
    for (auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  JVal& set(const std::string& k, JVal v) {
    if (JVal* e = find(k)) {
      *e = std::move(v);
      return *e;
    }
    obj.emplace_back(k, std::move(v));
    return obj.back().second;
  }
  JVal& get_or_insert_obj(const std::string& k) {
    if (JVal* e = find(k)) {
      if (e->type != OBJ) *e = JVal{OBJ};
      return *e;
    }
    JVal v;
    v.type = OBJ;
    obj.emplace_back(k, std::move(v));
    return obj.back().second;
  }
  void erase(const std::string& k) {
    if (type != OBJ) return;
    for (auto it = obj.begin(); it != obj.end(); ++it)
      if (it->first == k) {
        obj.erase(it);
        return;
      }
  }
  static JVal str(std::string v) {
    JVal j;
    j.type = STR;
    j.s = std::move(v);
    return j;
  }
  static JVal num_raw(std::string v) {
    JVal j;
    j.type = NUM;
    j.s = std::move(v);
    return j;
  }
};

// --- parser (recursive descent; tolerant of whitespace; \uXXXX -> UTF-8)

struct JParser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit JParser(const std::string& text)
      : p(text.data()), end(text.data() + text.size()) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
  }
  bool lit(const char* s, size_t n) {
    if ((size_t)(end - p) < n || std::memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }

  JVal parse() {
    ws();
    JVal v = value();
    ws();
    if (p != end) ok = false;
    return v;
  }

  JVal value() {
    if (p >= end) {
      ok = false;
      return {};
    }
    switch (*p) {
      case '{':
        return object();
      case '[':
        return array();
      case '"': {
        JVal v;
        v.type = JVal::STR;
        v.s = string();
        return v;
      }
      case 't':
        if (lit("true", 4)) {
          JVal v;
          v.type = JVal::BOOL;
          v.b = true;
          return v;
        }
        break;
      case 'f':
        if (lit("false", 5)) {
          JVal v;
          v.type = JVal::BOOL;
          v.b = false;
          return v;
        }
        break;
      case 'n':
        if (lit("null", 4)) return {};
        break;
      default:
        if (*p == '-' || (*p >= '0' && *p <= '9')) return number();
    }
    ok = false;
    return {};
  }

  JVal number() {
    const char* s = p;
    if (p < end && *p == '-') p++;
    while (p < end && ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' ||
                       *p == 'E' || *p == '+' || *p == '-'))
      p++;
    JVal v;
    v.type = JVal::NUM;
    v.s.assign(s, p - s);
    return v;
  }

  // the length of the well-formed UTF-8 sequence at p (a lead byte of 2
  // to 4 bytes), or 0: truncated, a stray continuation byte, an overlong
  // form or past U+10FFFF. An encoded surrogate passes, as Python's
  // json.loads takes it from bytes
  static size_t utf8_len(const char* p, const char* end) {
    unsigned char c = (unsigned char)p[0];
    size_t n = c >= 0xC2 && c <= 0xDF ? 2 : c >= 0xE0 && c <= 0xEF ? 3
             : c >= 0xF0 && c <= 0xF4 ? 4 : 0;
    if (!n || (size_t)(end - p) < n) return 0;
    for (size_t i = 1; i < n; i++)
      if (((unsigned char)p[i] & 0xC0) != 0x80) return 0;
    unsigned char c1 = (unsigned char)p[1];
    if ((c == 0xE0 && c1 < 0xA0) || (c == 0xF0 && c1 < 0x90) ||
        (c == 0xF4 && c1 > 0x8F))
      return 0;
    return n;
  }

  std::string string() {
    std::string out;
    if (p >= end || *p != '"') {
      ok = false;
      return out;
    }
    p++;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        p++;
        if (p >= end) break;
        switch (*p) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            unsigned cp = hex4();
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[1] == '\\' &&
                p[2] == 'u') {
              p += 2;
              unsigned lo = hex4();
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            }
            append_utf8(out, cp);
            break;
          }
          default: ok = false;
        }
        p++;
      } else if ((unsigned char)*p < 0x80) {
        out += *p++;
      } else {
        // JSON text is UTF-8: a malformed sequence (a garbled byte) makes
        // the body unparseable, as Python's json.loads finds it, instead
        // of landing in the store and in every later LIST
        size_t n = utf8_len(p, end);
        if (!n) {
          ok = false;
          return out;
        }
        out.append(p, n);
        p += n;
      }
    }
    if (p < end) p++;  // closing quote
    else ok = false;
    return out;
  }

  unsigned hex4() {
    unsigned v = 0;
    for (int i = 0; i < 4 && p + 1 < end; i++) {
      p++;
      char c = *p;
      v <<= 4;
      if (c >= '0' && c <= '9') v |= c - '0';
      else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
      else ok = false;
    }
    return v;
  }

  static void append_utf8(std::string& out, unsigned cp) {
    if (cp < 0x80) {
      out += (char)cp;
    } else if (cp < 0x800) {
      out += (char)(0xC0 | (cp >> 6));
      out += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += (char)(0xE0 | (cp >> 12));
      out += (char)(0x80 | ((cp >> 6) & 0x3F));
      out += (char)(0x80 | (cp & 0x3F));
    } else {
      out += (char)(0xF0 | (cp >> 18));
      out += (char)(0x80 | ((cp >> 12) & 0x3F));
      out += (char)(0x80 | ((cp >> 6) & 0x3F));
      out += (char)(0x80 | (cp & 0x3F));
    }
  }

  JVal object() {
    JVal v;
    v.type = JVal::OBJ;
    p++;  // {
    ws();
    if (p < end && *p == '}') {
      p++;
      return v;
    }
    while (p < end) {
      ws();
      std::string k = string();
      ws();
      if (p >= end || *p != ':') {
        ok = false;
        return v;
      }
      p++;
      ws();
      v.obj.emplace_back(std::move(k), value());
      ws();
      if (p < end && *p == ',') {
        p++;
        continue;
      }
      break;
    }
    if (p < end && *p == '}') p++;
    else ok = false;
    return v;
  }

  JVal array() {
    JVal v;
    v.type = JVal::ARR;
    p++;  // [
    ws();
    if (p < end && *p == ']') {
      p++;
      return v;
    }
    while (p < end) {
      ws();
      v.arr.push_back(value());
      ws();
      if (p < end && *p == ',') {
        p++;
        continue;
      }
      break;
    }
    if (p < end && *p == ']') p++;
    else ok = false;
    return v;
  }
};

static void json_escape(std::string& out, const std::string& s) {
  static const char hex[] = "0123456789abcdef";
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          out += "\\u00";
          out += hex[c >> 4];
          out += hex[c & 15];
        } else {
          out += (char)c;
        }
    }
  }
}

static void serialize(const JVal& v, std::string& out) {
  switch (v.type) {
    case JVal::NUL: out += "null"; break;
    case JVal::BOOL: out += v.b ? "true" : "false"; break;
    case JVal::NUM: out += v.s; break;
    case JVal::STR:
      out += '"';
      json_escape(out, v.s);
      out += '"';
      break;
    case JVal::ARR: {
      out += '[';
      for (size_t i = 0; i < v.arr.size(); i++) {
        if (i) out += ',';
        serialize(v.arr[i], out);
      }
      out += ']';
      break;
    }
    case JVal::OBJ: {
      out += '{';
      for (size_t i = 0; i < v.obj.size(); i++) {
        if (i) out += ',';
        out += '"';
        json_escape(out, v.obj[i].first);
        out += "\":";
        serialize(v.obj[i].second, out);
      }
      out += '}';
      break;
    }
  }
}

static std::string dumps(const JVal& v) {
  std::string out;
  serialize(v, out);
  return out;
}

// ------------------------------------------------------------- selectors

// Label-selector grammar mirror of kwok_tpu/edge/selectors.py: `k=v`,
// `k==v`, `k!=v`, `k in (a,b)`, `k notin (a,b)`, `k`, `!k`, comma-joined.
struct LabelReq {
  enum Op { EQ, NE, IN, NOTIN, EXISTS, NOTEXISTS } op;
  std::string key;
  std::vector<std::string> values;

  bool matches(const JVal* labels) const {
    const JVal* v = labels ? labels->find(key) : nullptr;
    bool present = v != nullptr && v->type == JVal::STR;
    switch (op) {
      case EXISTS: return v != nullptr;
      case NOTEXISTS: return v == nullptr;
      case EQ:
      case IN: {
        if (!present) return false;
        for (const auto& x : values)
          if (x == v->s) return true;
        return false;
      }
      case NE:
      case NOTIN: {
        if (!present) return true;  // absent matches != / notin
        for (const auto& x : values)
          if (x == v->s) return false;
        return true;
      }
    }
    return false;
  }
};

static std::string strip(const std::string& s) {
  size_t a = s.find_first_not_of(" \t");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t");
  return s.substr(a, b - a + 1);
}

static std::vector<std::string> split_top_level(const std::string& s) {
  std::vector<std::string> parts;
  int depth = 0;
  std::string cur;
  for (char ch : s) {
    if (ch == '(') depth++;
    else if (ch == ')') depth--;
    if (ch == ',' && depth == 0) {
      std::string t = strip(cur);
      if (!t.empty()) parts.push_back(t);
      cur.clear();
    } else {
      cur += ch;
    }
  }
  std::string t = strip(cur);
  if (!t.empty()) parts.push_back(t);
  return parts;
}

struct LabelSel {
  std::vector<LabelReq> reqs;
  bool parsed = false;  // false => no selector (match everything)

  static LabelSel parse(const std::string& s) {
    LabelSel sel;
    std::string t = strip(s);
    if (t.empty()) return sel;
    sel.parsed = true;
    for (const std::string& part : split_top_level(t)) {
      LabelReq r;
      size_t sp = part.find(' ');
      // `key in (a,b)` / `key notin (a,b)`
      if (sp != std::string::npos) {
        std::string key = strip(part.substr(0, sp));
        std::string rest = strip(part.substr(sp));
        bool isin = rest.rfind("in", 0) == 0 && rest.find('(') != std::string::npos;
        bool isnot = rest.rfind("notin", 0) == 0;
        if ((isin || isnot) && key.find('=') == std::string::npos &&
            key.find('!') == std::string::npos) {
          size_t lp = rest.find('('), rp = rest.rfind(')');
          if (lp != std::string::npos && rp != std::string::npos && rp > lp) {
            r.key = key;
            r.op = isnot ? LabelReq::NOTIN : LabelReq::IN;
            std::string vals = rest.substr(lp + 1, rp - lp - 1);
            size_t pos = 0;
            while (pos <= vals.size()) {
              size_t c = vals.find(',', pos);
              std::string v =
                  strip(vals.substr(pos, c == std::string::npos ? c : c - pos));
              if (!v.empty()) r.values.push_back(v);
              if (c == std::string::npos) break;
              pos = c + 1;
            }
            sel.reqs.push_back(std::move(r));
            continue;
          }
        }
      }
      size_t ne = part.find("!=");
      size_t ee = part.find("==");
      size_t e = part.find('=');
      if (ne != std::string::npos) {
        r.key = strip(part.substr(0, ne));
        r.op = LabelReq::NE;
        r.values.push_back(strip(part.substr(ne + 2)));
      } else if (ee != std::string::npos) {
        r.key = strip(part.substr(0, ee));
        r.op = LabelReq::EQ;
        r.values.push_back(strip(part.substr(ee + 2)));
      } else if (e != std::string::npos) {
        r.key = strip(part.substr(0, e));
        r.op = LabelReq::EQ;
        r.values.push_back(strip(part.substr(e + 1)));
      } else if (!part.empty() && part[0] == '!') {
        r.key = strip(part.substr(1));
        r.op = LabelReq::NOTEXISTS;
      } else {
        r.key = part;
        r.op = LabelReq::EXISTS;
      }
      sel.reqs.push_back(std::move(r));
    }
    return sel;
  }

  bool matches(const JVal& obj) const {
    if (!parsed) return true;
    const JVal* meta = obj.find("metadata");
    const JVal* labels = meta ? meta->find("labels") : nullptr;
    for (const auto& r : reqs)
      if (!r.matches(labels)) return false;
    return true;
  }
};

// fieldSelector: comma-joined `path=value` / `path!=value` terms; missing
// fields stringify to "" (kwok_tpu/edge/kubeclient.py match_field_selector).
static std::string field_str(const JVal& obj, const std::string& path) {
  const JVal* cur = &obj;
  size_t pos = 0;
  while (pos <= path.size()) {
    size_t dot = path.find('.', pos);
    std::string part =
        path.substr(pos, dot == std::string::npos ? dot : dot - pos);
    if (cur->type != JVal::OBJ) return "";
    cur = cur->find(strip(part));
    if (!cur) return "";
    if (dot == std::string::npos) break;
    pos = dot + 1;
  }
  switch (cur->type) {
    case JVal::STR: return cur->s;
    case JVal::NUM: return cur->s;
    case JVal::BOOL: return cur->b ? "True" : "False";  // Python str(bool)
    default: return "";
  }
}

static bool match_field_selector(const JVal& obj, const std::string& sel) {
  if (sel.empty()) return true;
  size_t pos = 0;
  while (pos <= sel.size()) {
    size_t c = sel.find(',', pos);
    std::string term =
        strip(sel.substr(pos, c == std::string::npos ? c : c - pos));
    if (!term.empty()) {
      size_t ne = term.find("!=");
      if (ne != std::string::npos) {
        std::string path = term.substr(0, ne);
        std::string val = term.substr(ne + 2);
        if (field_str(obj, path) == val) return false;
      } else {
        size_t ee = term.find("==");
        size_t e = term.find('=');
        std::string path, val;
        if (ee != std::string::npos) {
          path = term.substr(0, ee);
          val = term.substr(ee + 2);
        } else if (e != std::string::npos) {
          path = term.substr(0, e);
          val = term.substr(e + 1);
        } else {
          goto next;
        }
        // mirror Python's path.rstrip("=") on the `=` split
        while (!path.empty() && path.back() == '=') path.pop_back();
        if (field_str(obj, path) != val) return false;
      }
    }
  next:
    if (c == std::string::npos) break;
    pos = c + 1;
  }
  return true;
}

// ------------------------------------------------------- strategic merge

// Mirrors kwok_tpu/edge/merge.py: object merge with null deletion; list
// merge by key `type` for fields `conditions`/`addresses`; everything else
// replaces atomically. `$patch: replace`/`$patch: delete` directives follow
// the real apiserver's strategicpatch for these shapes (merge.py docstring);
// unknown directive values are dropped tolerantly.
static bool merge_list_field(const std::string& field) {
  return field == "conditions" || field == "addresses";
}

static const JVal* patch_directive(const JVal& v) {
  const JVal* d = v.type == JVal::OBJ ? v.find("$patch") : nullptr;
  return (d && d->type == JVal::STR) ? d : nullptr;
}

// True when a patch subtree carries no $patch markers and no nulls — the
// common case, letting insertion skip the sanitizing rebuild.
static bool patch_clean(const JVal& v) {
  if (v.type == JVal::OBJ) {
    for (const auto& kv : v.obj)
      if (kv.first == "$patch" || kv.second.type == JVal::NUL ||
          !patch_clean(kv.second))
        return false;
    return true;
  }
  if (v.type == JVal::ARR) {
    for (const auto& e : v.arr)
      if (!patch_clean(e)) return false;
    return true;
  }
  return true;
}

// A patch subtree inserted where the original has no value: stored objects
// must never contain $patch markers or nulls (mirrors merge.py _sanitize /
// strategicpatch IgnoreUnmatchedNulls). Known divergence from upstream
// removeDirectives, shared by all three in-repo implementations (see the
// merge.py _sanitize docstring): a fresh-inserted $patch:delete map becomes
// {} and directive-carrying merge-list elements are dropped, where upstream
// merely strips the marker and keeps the content.
static JVal sanitize_patch(const JVal& v, const std::string& field) {
  if (patch_clean(v)) return v;
  if (v.type == JVal::OBJ) {
    const JVal* d = patch_directive(v);
    if (d && d->s == "delete") {
      JVal out;
      out.type = JVal::OBJ;
      return out;
    }
    JVal out;
    out.type = JVal::OBJ;
    for (const auto& kv : v.obj) {
      if (kv.first == "$patch" || kv.second.type == JVal::NUL) continue;
      out.obj.emplace_back(kv.first, sanitize_patch(kv.second, kv.first));
    }
    return out;
  }
  if (v.type == JVal::ARR && merge_list_field(field)) {
    JVal out;
    out.type = JVal::ARR;
    for (const auto& e : v.arr) {
      if (e.type == JVal::OBJ && e.find("$patch")) continue;
      out.arr.push_back(sanitize_patch(e, ""));
    }
    return out;
  }
  return v;  // scalars and atomic lists: opaque values, taken verbatim
}

static JVal merge_value(const JVal& orig, const JVal& patch,
                        const std::string& field) {
  if (patch.type == JVal::OBJ && orig.type == JVal::OBJ) {
    if (const JVal* d = patch_directive(patch)) {
      if (d->s == "replace") {
        JVal out;
        out.type = JVal::OBJ;
        for (const auto& kv : patch.obj) {
          if (kv.first == "$patch" || kv.second.type == JVal::NUL) continue;
          out.obj.emplace_back(kv.first, sanitize_patch(kv.second, kv.first));
        }
        return out;
      }
      if (d->s == "delete") {
        JVal out;
        out.type = JVal::OBJ;
        return out;
      }
    }
    JVal out = orig;
    for (const auto& kv : patch.obj) {
      if (kv.first == "$patch") continue;  // unknown directive: dropped
      if (kv.second.type == JVal::NUL) {
        out.erase(kv.first);
      } else if (JVal* cur = out.find(kv.first)) {
        *cur = merge_value(*cur, kv.second, kv.first);
      } else {
        out.obj.emplace_back(kv.first, sanitize_patch(kv.second, kv.first));
      }
    }
    return out;
  }
  if (patch.type == JVal::ARR && orig.type == JVal::ARR &&
      merge_list_field(field)) {
    // a `$patch: replace` element -> the patch's non-directive elements
    // replace the list wholesale
    for (const auto& item : patch.arr) {
      const JVal* d = patch_directive(item);
      if (d && d->s == "replace") {
        JVal out;
        out.type = JVal::ARR;
        for (const auto& it : patch.arr)
          if (!(it.type == JVal::OBJ && it.find("$patch")))
            out.arr.push_back(sanitize_patch(it, ""));
        return out;
      }
    }
    // strategicpatch applies every $patch:delete to the ORIGINAL before
    // merging any non-directive element, so a delete never removes an
    // element the same patch adds
    std::vector<std::string> deleted;
    for (const auto& item : patch.arr) {
      const JVal* d = patch_directive(item);
      const JVal* ik = item.type == JVal::OBJ ? item.find("type") : nullptr;
      if (d && d->s == "delete" && ik && ik->type == JVal::STR)
        deleted.push_back(ik->s);
    }
    JVal out = orig;
    if (!deleted.empty()) {
      auto& v = out.arr;
      v.erase(std::remove_if(v.begin(), v.end(),
                             [&](const JVal& e) {
                               const JVal* ek = e.type == JVal::OBJ
                                                    ? e.find("type")
                                                    : nullptr;
                               return ek && ek->type == JVal::STR &&
                                      std::find(deleted.begin(), deleted.end(),
                                                ek->s) != deleted.end();
                             }),
              v.end());
    }
    for (const auto& item : patch.arr) {
      if (item.type == JVal::OBJ && item.find("$patch")) continue;
      const JVal* ik = item.type == JVal::OBJ ? item.find("type") : nullptr;
      bool key_is_str = ik && ik->type == JVal::STR;
      bool merged = false;
      if (key_is_str) {
        for (auto& existing : out.arr) {
          const JVal* ek =
              existing.type == JVal::OBJ ? existing.find("type") : nullptr;
          if (ek && ek->type == JVal::STR && ek->s == ik->s) {
            existing = merge_value(existing, item, "");
            merged = true;
            break;
          }
        }
      }
      if (!merged) out.arr.push_back(sanitize_patch(item, ""));
    }
    return out;
  }
  // type-mismatch / scalar / atomic-list replacement: sanitized like
  // missing-key insertions
  return sanitize_patch(patch, field);
}

// ----------------------------------------------------------------- store

static std::string now_rfc3339() {
  time_t t = time(nullptr);
  struct tm tm_;
  gmtime_r(&t, &tm_);
  char buf[32];
  strftime(buf, sizeof buf, "%Y-%m-%dT%H:%M:%SZ", &tm_);
  return buf;
}

using Key = std::pair<std::string, std::string>;  // (namespace-or-"", name)

// Copy-on-write store entry: immutable once published, serialized at
// publish time. Readers (LIST/GET/snapshot at 1M objects) snapshot the
// shared_ptrs under the store mutex and do ALL matching/serialization
// outside it — a full-population LIST must never starve writers (measured:
// serializing 1M pods under the lock stalled every patch for seconds and
// timed out the engine's pump).
struct Entry {
  JVal obj;
  std::string bytes;
};
using EntryPtr = std::shared_ptr<const Entry>;

static EntryPtr publish(JVal obj) {
  auto e = std::make_shared<Entry>();
  e->obj = std::move(obj);
  e->bytes = dumps(e->obj);
  return e;
}

// bounded per-watcher send buffer: a consumer that stops reading has its
// watch TERMINATED (kwok_watch_terminations_total{reason="slow"}, the
// watch cache's slow-consumer termination) instead of pinning unbounded
// memory; the client re-lists/resumes (410-class recovery). Mirrors
// mockserver.py WATCH_BACKLOG; same env override; <= 0 disables the cap.
static long watch_backlog() {
  static const long bl = [] {
    const char* v = getenv("KWOK_TPU_WATCH_BACKLOG");
    return v && *v ? atol(v) : 16384L;
  }();
  return bl;
}

// kwok_watch_terminations_total{reason=}: slow-consumer closes happen in
// Watch::push (no App pointer there), timeoutSeconds expiries in the
// writer loop; one store per process, so file-scope atomics suffice.
static std::atomic<long> g_watch_term_slow{0};
static std::atomic<long> g_watch_term_deadline{0};

// ---------------------------------------------------------- phase timing
// (ISSUE 11) Per-request phase attribution, parity-pinned with
// kwok_tpu/telemetry/apiserver_metrics.py: family names, HELP text,
// bucket labels and the full phase/verb sample matrix are byte-identical
// across the two servers (tests/test_native_apiserver.py masks only the
// values). Clock stamps are gated by KWOK_TPU_APISERVER_TIMING (default
// on; "0" makes every request pay exactly one cached-bool branch); the
// fanout-push counter and the backlog peak watermark stay on — they are
// single relaxed atomics per queued event and the fleet gate's
// bounded-buffer proof must not depend on the timing knob.

static bool timing_enabled() {
  static const bool on = [] {
    const char* v = getenv("KWOK_TPU_APISERVER_TIMING");
    return !(v && v[0] == '0' && v[1] == '\0');
  }();
  return on;
}

static inline uint64_t now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static double wall_unix_s() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// fixed bucket ladder (seconds, here as ns): telemetry.apiserver_metrics
// TIMING_BUCKETS — the `le` strings below are the canonical label bytes
static const int N_TBUCKETS = 17;
static const uint64_t TBUCKET_NS[N_TBUCKETS] = {
    5000ull,      10000ull,     25000ull,     50000ull,     100000ull,
    250000ull,    500000ull,    1000000ull,   2500000ull,   5000000ull,
    10000000ull,  25000000ull,  50000000ull,  100000000ull, 250000000ull,
    500000000ull, 1000000000ull};
static const char* TBUCKET_LE[N_TBUCKETS] = {
    "5e-06", "1e-05", "2.5e-05", "5e-05", "0.0001", "0.00025", "0.0005",
    "0.001", "0.0025", "0.005",  "0.01",  "0.025",  "0.05",    "0.1",
    "0.25",  "0.5",   "1"};

struct PhaseHist {
  std::atomic<uint64_t> buckets[N_TBUCKETS + 1] = {};
  std::atomic<uint64_t> sum_ns{0};
  std::atomic<uint64_t> count{0};
  void observe_ns(uint64_t ns) {
    int i = 0;
    while (i < N_TBUCKETS && ns > TBUCKET_NS[i]) i++;  // le inclusive
    buckets[i].fetch_add(1, std::memory_order_relaxed);
    sum_ns.fetch_add(ns, std::memory_order_relaxed);
    count.fetch_add(1, std::memory_order_relaxed);
  }
};

enum {
  PH_READ_HEADERS = 0,
  PH_READ_BODY,
  PH_PARSE,
  PH_COMMIT,
  PH_ENCODE,
  PH_FANOUT,
  N_PHASES,
};
static const char* PHASE_NAMES[N_PHASES] = {
    "read_headers", "read_body", "parse", "commit", "encode", "fanout"};
static const int N_VERBS = 6;
static const char* VERB_NAMES[N_VERBS] = {"get",   "list",   "create",
                                          "patch", "delete", "other"};
static PhaseHist g_phase_hist[N_PHASES];
static PhaseHist g_verb_hist[N_VERBS];
static std::atomic<long> g_fanout_pushes{0};
static std::atomic<long> g_backlog_peak{0};

static void peak_update(long depth) {
  long prev = g_backlog_peak.load(std::memory_order_relaxed);
  while (depth > prev &&
         !g_backlog_peak.compare_exchange_weak(prev, depth)) {
  }
}

// Per-request phase accumulator: boundary stamps shared between adjacent
// phases (mark() is one clock read), so a timed unary request costs a
// handful of clock reads total; disabled => `on` stays false everywhere.
struct PhaseTimer {
  bool on = false;
  // set by handlers only when the body parse SUCCEEDED — a malformed
  // body contributes no parse sample, mirroring the Python mock (whose
  // _BadBody raise precedes its parse stamp)
  bool parsed = false;
  uint64_t last = 0;
  double us[N_PHASES] = {0, 0, 0, 0, 0, 0};
  void mark(int phase) {
    if (!on) return;
    uint64_t now = now_ns();
    us[phase] += (double)(now - last) / 1000.0;
    last = now;
  }
};

// flight recorder: a bounded ring of recent request records, dumped via
// GET /debug/flight (schema shared with the Python mock and validated by
// kwok_tpu/telemetry/timeline.check_flight)
static const size_t FLIGHT_CAPACITY = 1024;
struct FlightRec {
  std::string method, path, band;
  int status = 0;
  double ts_unix = 0;
  double total_us = 0;
  double phases_us[N_PHASES] = {0, 0, 0, 0, 0, 0};
};
static std::mutex g_flight_mu;  // leaf: nothing acquired under it
static std::deque<FlightRec> g_flight;
static long g_flight_captured = 0;

static void flight_record(FlightRec rec) {
  std::lock_guard<std::mutex> lk(g_flight_mu);
  g_flight_captured++;
  if (g_flight.size() >= FLIGHT_CAPACITY) g_flight.pop_front();
  g_flight.push_back(std::move(rec));
}

// kwok_watch_cursor_lag_events (ISSUE 16): final ring-cursor lag per
// watch close — the census histogram the C10k reactor rewrite is graded
// against. Bucket bounds/label bytes mirror telemetry/apiserver_metrics
// LAG_EVENT_BUCKETS; observed under the store's ring_mu (relaxed atomics
// so the /metrics render needs no lock).
static const int N_LBUCKETS = 13;
static const long LBUCKET_EV[N_LBUCKETS] = {1,   2,   4,   8,    16,   32,
                                            64,  128, 256, 512,  1024, 2048,
                                            4096};
static const char* LBUCKET_LE[N_LBUCKETS] = {
    "1",   "2",   "4",   "8",    "16",   "32",  "64",
    "128", "256", "512", "1024", "2048", "4096"};
static std::atomic<uint64_t> g_lag_buckets[N_LBUCKETS + 1] = {};
static std::atomic<uint64_t> g_lag_sum{0};
static std::atomic<uint64_t> g_lag_count{0};

static void lag_observe(long events) {
  if (events < 0) events = 0;
  int i = 0;
  while (i < N_LBUCKETS && events > LBUCKET_EV[i]) i++;  // le inclusive
  g_lag_buckets[i].fetch_add(1, std::memory_order_relaxed);
  g_lag_sum.fetch_add((uint64_t)events, std::memory_order_relaxed);
  g_lag_count.fetch_add(1, std::memory_order_relaxed);
}

static std::string flight_dump_json() {
  std::string out = "{\"server\":\"native\",\"timing_enabled\":";
  out += timing_enabled() ? "true" : "false";
  out += ",\"ring_capacity\":" + std::to_string(FLIGHT_CAPACITY);
  std::lock_guard<std::mutex> lk(g_flight_mu);
  out += ",\"captured\":" + std::to_string(g_flight_captured);
  out += ",\"records\":[";
  char num[64];
  bool first = true;
  for (const auto& r : g_flight) {
    if (!first) out += ',';
    first = false;
    out += "{\"method\":\"";
    json_escape(out, r.method);
    out += "\",\"path\":\"";
    json_escape(out, r.path);
    out += "\",\"status\":" + std::to_string(r.status);
    out += ",\"band\":\"";
    json_escape(out, r.band);
    out += "\"";
    snprintf(num, sizeof num, ",\"ts_unix\":%.6f", r.ts_unix);
    out += num;
    snprintf(num, sizeof num, ",\"total_us\":%.3f", r.total_us);
    out += num;
    out += ",\"phases_us\":{";
    for (int p = 0; p < N_PHASES; p++) {
      if (p) out += ',';
      out += "\"";
      out += PHASE_NAMES[p];
      snprintf(num, sizeof num, "\":%.3f", r.phases_us[p]);
      out += num;
    }
    out += "}}";
  }
  out += "]}";
  return out;
}

// A watch is a CURSOR into the store's serialize-once broadcast ring
// (ISSUE 13): the store encodes each event exactly once into the shared
// ring; every watch stream thread reads forward from its own cursor and
// filters on its own time (kind / selectors / bookmark opt-in), so the
// per-watcher encode+push loop left the commit path entirely. A watch
// whose cursor falls more than watch_backlog() events behind the ring
// head is closed terminated_slow — PR 8's bounded-backlog drop/close
// semantics folded into ring-cursor lag. All fields below `replay` are
// guarded by the store's ring/clock mutex (Store::mu).
struct Watch {
  int kind;  // 0 nodes, 1 pods
  std::string field_sel;
  LabelSel label_sel;
  // opted into periodic BOOKMARK events (allowWatchBookmarks=true)
  bool bookmarks = false;
  // resume replay (watch-cache gap): exempt from the lag cap — the gap
  // is bounded by rv_window() already, and capping it would terminate
  // every resume whose gap exceeds the backlog (a loop). Filled before
  // the watch is registered, so no reader races it.
  std::vector<std::shared_ptr<const std::string>> replay;
  // guarded by Store::mu from here on
  uint64_t cursor = 0;  // next ring sequence this stream will read
  // a graceful close still delivers events sequenced before the stop
  // point; a slow termination drops the backlog (cursor jumps to head)
  uint64_t stop_seq = UINT64_MAX;
  bool closed = false;
  // set when the server closed this watch because its ring-cursor lag
  // exceeded the cap (the writer distinguishes it from a shutdown close)
  bool terminated_slow = false;
  // wall stamp of registration — GET /debug/watchers age_s
  double created_unix = 0;
  // live replay-backlog size for the census: the replay vector itself is
  // drained by the stream thread OUTSIDE the ring lock, so the census
  // reads this atomic instead of racing the vector
  std::atomic<long> replay_pending{0};
};

// core/v1 kinds plus rbac.authorization.k8s.io/v1 (served with bootstrap
// policy under --authorization; mirrors mockserver.py KINDS)
static const int NKINDS = 7;
// order matters: pods must stay index 1 (graceful-delete special case);
// indexes 2-5 are the rbac group, everything else is core/v1
static const char* KIND_NAMES[NKINDS] = {
    "nodes",        "pods",         "roles",    "rolebindings",
    "clusterroles", "clusterrolebindings",      "events",
};
static int kind_index(const std::string& kind) {
  for (int i = 0; i < NKINDS; i++)
    if (kind == KIND_NAMES[i]) return i;
  return -1;
}

// the real apiserver expires events on a ~1h etcd lease (--event-ttl,
// re-leased on every write); the mock bounds the events store by count
// instead — the least-recently-WRITTEN event (smallest resourceVersion) is
// evicted on insert — so long soaks with a real scheduler can't grow it
// without bound. Mirrors mockserver.py EVENTS_CAP; same env override;
// cap <= 0 means unbounded.
static int events_cap() {
  static const int cap = [] {
    const char* v = getenv("KWOK_TPU_EVENTS_CAP");
    return v && *v ? atoi(v) : 4096;
  }();
  return cap;
}

// watch-cache window: recent events retained for resourceVersion-resumed
// watches. Resuming below the window gets the real apiserver's 410 Gone
// ("too old resource version", etcd compaction semantics); <= 0 disables
// the cache so every resume expires. Mirrors mockserver.py RV_WINDOW.
static std::atomic<int>& rv_window_cell() {
  static std::atomic<int> w{[] {
    const char* v = getenv("KWOK_TPU_RV_WINDOW");
    return v && *v ? atoi(v) : 4096;
  }()};
  return w;
}
// the drift rig's POST /rig/window sets it (--rig-routes)
static int rv_window() { return rv_window_cell().load(std::memory_order_relaxed); }

// --rig-routes: serve the drift rig's /rig/ routes (rig_route below)
static bool g_rig_routes = false;

// watch-cache entry: ring position is the store clock at emit time (NOT
// the object's own rv — events-cap evictions re-emit old objects and the
// replay filter needs monotonic positions)
struct Hist {
  int64_t rv;
  int kind;
  std::string type;
  EntryPtr e;
};

// url-safe base64 for the opaque list continue token (the real
// apiserver's continue is base64 too; raw NULs don't survive shells/JSON)
static const char B64URL[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_";

static std::string b64url_encode(const std::string& in) {
  std::string out;
  out.reserve((in.size() + 2) / 3 * 4);
  size_t i = 0;
  while (i + 3 <= in.size()) {
    uint32_t v = (uint8_t)in[i] << 16 | (uint8_t)in[i + 1] << 8 |
                 (uint8_t)in[i + 2];
    out += B64URL[v >> 18];
    out += B64URL[(v >> 12) & 63];
    out += B64URL[(v >> 6) & 63];
    out += B64URL[v & 63];
    i += 3;
  }
  if (i + 1 == in.size()) {
    uint32_t v = (uint8_t)in[i] << 16;
    out += B64URL[v >> 18];
    out += B64URL[(v >> 12) & 63];
    out += "==";
  } else if (i + 2 == in.size()) {
    uint32_t v = (uint8_t)in[i] << 16 | (uint8_t)in[i + 1] << 8;
    out += B64URL[v >> 18];
    out += B64URL[(v >> 12) & 63];
    out += B64URL[(v >> 6) & 63];
    out += '=';
  }
  return out;
}

static bool b64url_decode(const std::string& in, std::string& out) {
  static int8_t rev[256];
  static bool init = [] {
    for (int i = 0; i < 256; i++) rev[i] = -1;
    for (int i = 0; i < 64; i++) rev[(uint8_t)B64URL[i]] = (int8_t)i;
    return true;
  }();
  (void)init;
  out.clear();
  uint32_t acc = 0;
  int bits = 0;
  for (char c : in) {
    if (c == '=') break;
    int8_t v = rev[(uint8_t)c];
    if (v < 0) return false;
    acc = acc << 6 | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out += (char)((acc >> bits) & 0xff);
    }
  }
  return true;
}

// Undo record: the entry's state BEFORE the event at `rv` (nullptr =
// absent). Bounded by the same window as the watch cache, it lets a
// paginated LIST reconstruct the store as of a continue token's revision
// — the consistent snapshot the real apiserver reads from etcd MVCC.
struct Undo {
  int64_t rv;
  int kind;
  Key key;
  EntryPtr prev;
};

// coordination.k8s.io/v1 Lease record (ISSUE 12): the leadership plane's
// minimal dialect, mirrored byte-for-byte with mockserver.py's lease_*
// methods (parity twins in tests/test_native_apiserver.py). Wall epochs
// are kept alongside the rendered RFC3339 stamps so expiry arithmetic
// never re-parses a timestamp; the SERVER clock is the one authority.
// Leases live outside the watch/snapshot machinery by design: leadership
// is polled, never watched, and a restored store must not resurrect an
// old holder.
struct LeaseRec {
  std::string holder;
  long duration = 0;          // leaseDurationSeconds
  double acquire = 0, renew = 0;  // wall epochs (server clock)
  long transitions = 0;       // leaseTransitions
  std::string created, uid;
  int64_t rv = 0;
  std::string acquire_str, renew_str;
};

static std::string lease_render(const std::string& ns,
                                const std::string& name,
                                const LeaseRec& L) {
  std::string out =
      "{\"kind\":\"Lease\",\"apiVersion\":\"coordination.k8s.io/v1\","
      "\"metadata\":{\"name\":\"";
  json_escape(out, name);
  out += "\",\"namespace\":\"";
  json_escape(out, ns);
  out += "\",\"creationTimestamp\":\"" + L.created + "\",\"uid\":\"" +
         L.uid + "\",\"resourceVersion\":\"" + std::to_string(L.rv) +
         "\"},\"spec\":{\"holderIdentity\":\"";
  json_escape(out, L.holder);
  out += "\",\"leaseDurationSeconds\":" + std::to_string(L.duration) +
         ",\"acquireTime\":\"" + L.acquire_str + "\",\"renewTime\":\"" +
         L.renew_str + "\",\"leaseTransitions\":" +
         std::to_string(L.transitions) + "}}";
  return out;
}

// (holderIdentity, leaseDurationSeconds) from a request body's spec,
// tolerantly — a garbled duration reads as 0 (Python int() parity on the
// shapes our clients send).
static void lease_spec_fields(const JVal& body, std::string& holder,
                              long& duration) {
  holder.clear();
  duration = 0;
  const JVal* spec = body.is_obj() ? body.find("spec") : nullptr;
  if (!spec || !spec->is_obj()) return;
  const JVal* h = spec->find("holderIdentity");
  if (h && h->type == JVal::STR) holder = h->s;
  const JVal* d = spec->find("leaseDurationSeconds");
  if (d && (d->type == JVal::NUM || d->type == JVal::STR))
    duration = atol(d->s.c_str());
}

// server-clock expiry: vacant (no holder) counts as expired; otherwise a
// lease expires once renewTime + duration has passed (duration <= 0 =
// instantly reacquirable). Mirrors mockserver.FakeKube._lease_expired.
static bool lease_expired(const LeaseRec& L, double now) {
  if (L.holder.empty()) return true;
  return now >= L.renew + (double)(L.duration > 0 ? L.duration : 0);
}

// One (kind, namespace) store partition (ISSUE 13): its own mutex + map,
// so concurrent writers to different shards stop serializing on one
// index. Shard mutexes never nest with each other; the only nesting is
// shard -> Store::mu (the ring/clock lock) inside a commit. Cross-shard
// reads (LIST/snapshot) walk shards sequentially and reconcile through
// the undo log.
struct Shard {
  std::mutex smu;
  std::map<std::string, EntryPtr> objs;  // name -> published entry
};
using ShardPtr = std::shared_ptr<Shard>;

// One broadcast-ring entry: the event line is encoded exactly once and
// shared by every watcher whose cursor passes it; `e` is kept for the
// watcher-side selector match (immutable entry, no copies).
struct RingEv {
  int kind;
  bool bookmark;
  EntryPtr e;  // null for bookmarks
  std::shared_ptr<const std::string> line;
};

struct Store {
  // clock lock: revision allocation, watch cache (history), undo log,
  // per-kind counts + phase index. Acquired UNDER a shard's smu inside
  // commits (shard -> mu), never the other way around.
  std::mutex mu;
  // broadcast-ring lock: the ring itself, the watch registry and every
  // cursor. Acquired UNDER mu inside commits (shard -> mu -> ring_mu)
  // and ALONE by watcher threads — so a thousand watchers draining the
  // ring never contend with the clock lock a commit is serializing on.
  std::mutex ring_mu;
  std::condition_variable ring_cv;  // paired with ring_mu
  // shard registry (ns -> shard per kind); shards_mu guards creation
  // only and is never held together with any other lock
  std::mutex shards_mu;
  std::map<std::string, ShardPtr> shards[NKINDS];
  // coordination.k8s.io/v1 (ISSUE 12): leases + fencing live under their
  // own lease_mu, held ACROSS a fenced write's whole mutation (lease ->
  // shard -> mu) so a takeover PATCH can never interleave between the
  // fence check and the commit (the PR 12 contract, sharded edition)
  std::mutex lease_mu;
  std::map<Key, LeaseRec> leases;
  int64_t rv = 0;
  // watch registry + live count per kind: under ring_mu
  std::vector<std::shared_ptr<Watch>> watches;
  long kind_watchers[NKINDS] = {};
  // everything at or below compacted_rv is gone from history: resumes
  // below it answer 410, expired continue tokens too
  std::deque<Hist> history;
  std::deque<Undo> undo;
  int64_t compacted_rv = 0;
  // incremental status.phase counts per kind: lets a limit=1 progress
  // poll (fieldSelector=status.phase=X) report remainingItemCount without
  // the O(store) post-cut scan — at 50k pods a rig polling every 200 ms
  // was a measurable apiserver CPU term. Kept under mu (with rv) so the
  // count a LIST reads is consistent with its list revision.
  std::map<std::string, long> phase_idx[NKINDS];
  long obj_count[NKINDS] = {};  // per-kind population, under mu
  // the serialize-once broadcast ring (under ring_mu): base =
  // ring_next - ring.size(); trimmed to the slowest live cursor,
  // bounded by watch_backlog()
  std::deque<RingEv> ring;
  uint64_t ring_next = 0;
  uint64_t ring_min = 0;  // lazily-recomputed min live cursor estimate
  long encode_total = 0;  // kwok_watch_encode_total: one per ring append

  ShardPtr shard_of(int kind, const std::string& ns, bool create = true) {
    std::lock_guard<std::mutex> lk(shards_mu);
    auto it = shards[kind].find(ns);
    if (it != shards[kind].end()) return it->second;
    if (!create) return nullptr;
    auto sh = std::make_shared<Shard>();
    shards[kind][ns] = sh;
    return sh;
  }

  // (ns, shard) pairs in namespace order — concatenating their sorted
  // names yields the kind's global (ns, name) key order
  std::vector<std::pair<std::string, ShardPtr>> kind_shards(int kind) {
    std::lock_guard<std::mutex> lk(shards_mu);
    return {shards[kind].begin(), shards[kind].end()};
  }

  // caller holds mu; from/to are the entry leaving/entering the store
  void idx_adjust(int kind, const EntryPtr& from, const EntryPtr& to) {
    if (from) {
      std::string p = field_str(from->obj, "status.phase");
      auto it = phase_idx[kind].find(p);
      if (it != phase_idx[kind].end() && --it->second <= 0)
        phase_idx[kind].erase(it);
    }
    if (to) phase_idx[kind][field_str(to->obj, "status.phase")]++;
  }

  // caller holds ring_mu: close one watch (graceful or slow). A slow
  // termination drops the backlog (cursor jumps to head — 410-class
  // recovery); a graceful stop still delivers events queued before the
  // stop point. Wake-ups are the caller's job (ring_cv.notify_all after
  // the mu hold, or batched per commit).
  void close_watch_locked(const std::shared_ptr<Watch>& w, bool slow) {
    if (w->closed) return;
    w->closed = true;
    // census: the stream's FINAL lag, observed before any cursor jump (a
    // slow close records the overflow that killed it, a graceful close
    // the tail it still had to drain) — mirrors mockserver.py
    lag_observe((long)(ring_next - w->cursor));
    kind_watchers[w->kind]--;
    if (slow) {
      w->terminated_slow = true;
      w->cursor = ring_next;
      w->stop_seq = w->cursor;
      g_watch_term_slow.fetch_add(1);
    } else {
      w->stop_seq = ring_next;
    }
  }

  // caller holds ring_mu: trim consumed ring entries and enforce the cap.
  // Entries every live watcher consumed are dropped; once the ring
  // outgrows watch_backlog() the lagging watchers (cursor more than the
  // cap behind) are slow-closed and their backlog reclaimed. The peak
  // watermark records the deepest retained lag, clamped to the cap on a
  // termination, so fleet-check's gate (peak <= cap) keeps its meaning.
  void ring_trim_locked() {
    long cap = watch_backlog();
    while (!ring.empty()) {
      uint64_t base = ring_next - ring.size();
      if (ring_min <= base) {
        uint64_t m = ring_next;
        for (const auto& w : watches)
          if (!w->closed && w->cursor < m) m = w->cursor;
        ring_min = m;
      }
      if (ring_min > base) {
        ring.pop_front();
        continue;
      }
      if (cap > 0 && (long)ring.size() > cap) {
        bool lagged = false;
        for (const auto& w : watches)
          if (!w->closed && (long)(ring_next - w->cursor) > cap) {
            close_watch_locked(w, /*slow=*/true);
            lagged = true;
          }
        ring_min = 0;
        peak_update(cap);
        if (!lagged) break;  // safety: nobody to blame, stop trimming
        continue;
      }
      peak_update((long)ring.size());
      break;
    }
  }

  // caller holds the owning shard's smu (same-key writes stay totally
  // ordered) AND mu: allocate the revision, stamp it, serialize ONCE,
  // record watch cache + undo + counts, append the broadcast ring.
  // Returns the published entry; the caller installs it in the shard
  // map (or erased it already, for DELETED). `fanout_us` (timing on)
  // accumulates the one encode+append — the serialize-once cost the
  // old per-watcher loop paid per watcher.
  EntryPtr commit_locked(int kind, const char* type, JVal obj,
                         const Key& key, EntryPtr prev, double* fanout_us,
                         const Shard* owner, bool stamp_uid = false) {
    rv++;
    JVal& meta = obj.get_or_insert_obj("metadata");
    if (stamp_uid && !meta.find("uid"))
      meta.set("uid", JVal::str("uid-" + std::to_string(rv)));
    meta.set("resourceVersion", JVal::str(std::to_string(rv)));
    EntryPtr e = publish(std::move(obj));
    if (owner) {
      // a restore may have swapped the shard registry while this write
      // held its (now orphaned) shard. The client sees what the old
      // one-lock store gave — committed, then wiped by the restore —
      // so answer with the published entry but record NOTHING: no
      // counts (the restore reset them), no watch-cache/undo entry
      // (compacted), no ring event (watchers were closed); a ghost
      // event here is the silent divergence the drift auditor hunts.
      std::lock_guard<std::mutex> sg(shards_mu);
      auto sit = shards[kind].find(key.first);
      if (sit == shards[kind].end() || sit->second.get() != owner)
        return e;
    }
    bool deleted = strcmp(type, "DELETED") == 0;
    idx_adjust(kind, prev, deleted ? nullptr : e);
    if (!prev && !deleted) obj_count[kind]++;
    if (deleted) obj_count[kind]--;
    if (rv_window() > 0) {
      history.push_back({rv, kind, type, e});
      undo.push_back({rv, kind, key, std::move(prev)});
      while ((int)history.size() > rv_window()) {
        compacted_rv = std::max(compacted_rv, history.front().rv);
        history.pop_front();
      }
      while (!undo.empty() && undo.front().rv <= compacted_rv)
        undo.pop_front();
    }
    {
      // fanout (ISSUE 13): ONE encode + ring append per event no matter
      // how many watchers consume it. The push counter counts the
      // deliveries the shared bytes fan out to (events x live watchers
      // of the kind), so fanout_sum / fanout_total is the AMORTIZED
      // per-watcher cost; always on, clocks gated. ring_mu nests under
      // mu here (shard -> mu -> ring_mu) and is the ONLY lock watcher
      // threads ever take — their drains never stall the clock lock.
      uint64_t f0 = fanout_us ? now_ns() : 0;
      std::lock_guard<std::mutex> rl(ring_mu);
      if (kind_watchers[kind] > 0) {
        ring.push_back({kind, false, e, event_line(type, e)});
        ring_next++;
        encode_total++;
        g_fanout_pushes.fetch_add(kind_watchers[kind],
                                  std::memory_order_relaxed);
        ring_trim_locked();
        if (fanout_us) *fanout_us += (double)(now_ns() - f0) / 1000.0;
      }
    }
    return e;
  }

  static std::shared_ptr<const std::string> event_line(const char* type,
                                                       const EntryPtr& e) {
    std::string ev = "{\"type\":\"";
    ev += type;
    ev += "\",\"object\":";
    ev += e->bytes;
    ev += "}\n";
    return std::make_shared<const std::string>(std::move(ev));
  }

  // One BOOKMARK ring event (current store revision) per kind with
  // opted-in live watches — the watch cache's periodic rv-advance for
  // quiet watchers, encoded once per kind no matter the cohort size.
  // Object carries ONLY kind/apiVersion/metadata.resourceVersion, like
  // the real apiserver's (mirrors mockserver.py emit_bookmarks).
  int emit_bookmarks() {
    // object kind names + groups by KIND_NAMES index
    static const char* OBJ_KINDS[NKINDS] = {
        "Node",        "Pod",         "Role",    "RoleBinding",
        "ClusterRole", "ClusterRoleBinding",     "Event",
    };
    int sent = 0;
    {
      std::lock_guard<std::mutex> lk(mu);
      std::string rvs = std::to_string(rv);
      std::lock_guard<std::mutex> rl(ring_mu);
      long opted[NKINDS] = {};
      for (const auto& w : watches) {
        if (w->closed || !w->bookmarks) continue;
        opted[w->kind]++;
        sent++;
      }
      for (int k = 0; k < NKINDS; k++) {
        if (!opted[k]) continue;
        bool rbac = k >= 2 && k <= 5;
        std::string ev = "{\"type\":\"BOOKMARK\",\"object\":{\"kind\":\"";
        ev += OBJ_KINDS[k];
        ev += rbac ? "\",\"apiVersion\":\"rbac.authorization.k8s.io/v1\""
                   : "\",\"apiVersion\":\"v1\"";
        ev += ",\"metadata\":{\"resourceVersion\":\"" + rvs + "\"}}}\n";
        ring.push_back({k, true, nullptr,
                        std::make_shared<const std::string>(std::move(ev))});
        ring_next++;
        encode_total++;
      }
      if (sent) ring_trim_locked();
    }
    if (sent) ring_cv.notify_all();
    return sent;
  }

  static Key obj_key(const JVal& obj) {
    const JVal* meta = obj.find("metadata");
    const JVal* ns = meta ? meta->find("namespace") : nullptr;
    const JVal* name = meta ? meta->find("name") : nullptr;
    return {ns && ns->type == JVal::STR ? ns->s : "",
            name && name->type == JVal::STR ? name->s : ""};
  }
};

// ----------------------------------------------------------- HTTP server

struct Request {
  std::string method;
  std::string path;     // without query
  std::string query;    // raw query string
  std::string body;
  std::string auth;     // Authorization header (bearer-token authn)
  // X-Kwok-Lease-Holder: the fencing claim ("ns/name/holder") a mutating
  // request rides under; empty = unfenced (zero cost). Mirrors
  // mockserver.py FENCING_HEADER.
  std::string lease_holder;
  bool close = false;   // Connection: close
  // body handling is split from header parsing so max-inflight admission
  // can hold a band slot ACROSS the body read (a request is in flight
  // from its headers on, like the real apiserver's filter chain) and a
  // rejected request can still drain its body to keep the keep-alive
  // pipeline parseable
  size_t content_len = 0;
  bool body_read = false;
  // phase-timing boundary stamps (0 = timing off): first request bytes,
  // headers parsed, body consumed
  uint64_t t_start = 0;
  uint64_t t_hdr = 0;
  uint64_t t_body = 0;
};

static bool send_all(int fd, const char* data, size_t n) {
  while (n > 0) {
    ssize_t w = send(fd, data, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    data += w;
    n -= (size_t)w;
  }
  return true;
}

// Per-connection buffered IO. `in` carries pipelined request bytes behind
// a consumed-prefix offset (erasing the prefix per request is O(buffered)
// — quadratic under the pump's deep pipelines); `out` accumulates queued
// responses that flush in ONE send when the pipeline drains (the syscall-
// per-response pattern dominated apiserver CPU in live soaks).
struct ConnIO {
  int fd;
  std::string in;
  size_t off = 0;  // start of unconsumed bytes in `in`
  std::string out;

  bool flush() {
    if (out.empty()) return true;
    bool ok = send_all(fd, out.data(), out.size());
    out.clear();
    return ok;
  }
  // flush queued responses, then read more: only called when `in` lacks a
  // complete request, i.e. exactly when the pipeline has drained
  bool fill() {
    if (!flush()) return false;
    char tmp[65536];
    ssize_t n = recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) return false;
    in.append(tmp, n);
    return true;
  }
};

// Parses one request's head block (request line + headers) into req;
// shared by the blocking reader and the batch collector's buffered peek.
static bool parse_request_head(const std::string& head, Request& req) {
  size_t line_end = head.find("\r\n");
  std::string line = head.substr(0, line_end);
  size_t sp1 = line.find(' ');
  size_t sp2 = line.rfind(' ');
  if (sp1 == std::string::npos || sp2 <= sp1) return false;
  req.method = line.substr(0, sp1);
  std::string uri = line.substr(sp1 + 1, sp2 - sp1 - 1);
  size_t qm = uri.find('?');
  req.path = qm == std::string::npos ? uri : uri.substr(0, qm);
  req.query = qm == std::string::npos ? "" : uri.substr(qm + 1);

  size_t content_len = 0;
  req.close = false;
  req.auth.clear();
  req.lease_holder.clear();
  size_t pos = line_end == std::string::npos ? head.size() : line_end + 2;
  while (pos < head.size()) {
    size_t e = head.find("\r\n", pos);
    if (e == std::string::npos) e = head.size();
    std::string h = head.substr(pos, e - pos);
    pos = e + 2;
    size_t colon = h.find(':');
    if (colon == std::string::npos) continue;
    std::string k = h.substr(0, colon);
    std::transform(k.begin(), k.end(), k.begin(), ::tolower);
    std::string v = strip(h.substr(colon + 1));
    if (k == "content-length") content_len = (size_t)atoll(v.c_str());
    else if (k == "authorization") req.auth = v;
    else if (k == "x-kwok-lease-holder") req.lease_holder = v;
    else if (k == "connection") {
      std::transform(v.begin(), v.end(), v.begin(), ::tolower);
      if (v == "close") req.close = true;
    }
  }
  req.content_len = content_len;
  req.body.clear();
  req.body_read = false;
  return true;
}

// Reads one HTTP/1.1 request from the connection's pipelined buffer.
static bool read_request(ConnIO& io, Request& req) {
  // read_headers starts at the request's FIRST bytes (buffered for a
  // pipelined request, or the first fill otherwise) — keep-alive idle
  // time between requests is never attributed to the phase
  bool timed = timing_enabled();
  req.t_start = req.t_hdr = req.t_body = 0;
  if (timed && io.off < io.in.size()) req.t_start = now_ns();
  size_t hdr_end;
  while ((hdr_end = io.in.find("\r\n\r\n", io.off)) == std::string::npos) {
    if (io.off) {  // compact the consumed prefix before growing
      io.in.erase(0, io.off);
      io.off = 0;
    }
    if (io.in.size() > (32u << 20)) return false;
    if (!io.fill()) return false;
    if (timed && !req.t_start) req.t_start = now_ns();
  }
  std::string head = io.in.substr(io.off, hdr_end - io.off);
  if (!parse_request_head(head, req)) return false;
  io.off = hdr_end + 4;  // body bytes are consumed by read_body
  if (req.t_start) req.t_hdr = now_ns();
  return true;
}

// The batch collector's peek: parses the NEXT pipelined request ONLY
// when its head block AND body are already fully buffered — never a
// socket read, so collecting a batch can't stall behind a slow sender.
// Consumes the request from the buffer on success (headers + body).
static bool peek_buffered_request(ConnIO& io, Request& req) {
  size_t hdr_end = io.in.find("\r\n\r\n", io.off);
  if (hdr_end == std::string::npos) return false;
  Request tmp;
  tmp.t_start = tmp.t_hdr = tmp.t_body = 0;
  bool timed = timing_enabled();
  if (timed) tmp.t_start = now_ns();
  if (!parse_request_head(io.in.substr(io.off, hdr_end - io.off), tmp))
    return false;  // the blocking reader will hit the same bytes and close
  size_t total = hdr_end + 4 + tmp.content_len;
  if (io.in.size() < total) return false;
  tmp.body = io.in.substr(hdr_end + 4, tmp.content_len);
  tmp.body_read = true;
  if (tmp.t_start) tmp.t_hdr = tmp.t_body = now_ns();
  io.off = total;
  req = std::move(tmp);
  return true;
}


// Completes a request by reading its body off the pipeline (must be
// called exactly once per read_request before the next read_request, or
// the pipeline would parse body bytes as the next request's headers).
static bool read_body(ConnIO& io, Request& req) {
  if (req.body_read) return true;
  req.body_read = true;
  size_t total = io.off + req.content_len;
  while (io.in.size() < total) {
    if (!io.fill()) return false;
  }
  req.body = io.in.substr(io.off, req.content_len);
  io.off = total;
  if (io.off == io.in.size()) {
    io.in.clear();
    io.off = 0;
  } else if (io.off > (1u << 20)) {
    io.in.erase(0, io.off);
    io.off = 0;
  }
  if (req.t_start) req.t_body = now_ns();
  return true;
}

// Queues one response on the connection's out-buffer; flushed in one send
// when the request pipeline drains (ConnIO::fill) or past the size cap.
static bool queue_response(ConnIO& io, int code, const std::string& body,
                           const char* extra_headers = "",
                           const char* content_type = "application/json") {
  const char* reason = code == 200   ? "OK"
                       : code == 201 ? "Created"
                       : code == 401 ? "Unauthorized"
                       : code == 404 ? "Not Found"
                       : code == 429 ? "Too Many Requests"
                                     : "Error";
  char head[384];
  int hn = snprintf(head, sizeof head,
                    "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n%s"
                    "Content-Length: %zu\r\n\r\n",
                    code, reason, content_type, extra_headers, body.size());
  io.out.append(head, hn);
  io.out += body;
  // bound queued-response memory (large LIST pages): flush early
  if (io.out.size() > (4u << 20)) return io.flush();
  return true;
}

static std::string url_decode(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (size_t i = 0; i < s.size(); i++) {
    if (s[i] == '%' && i + 2 < s.size()) {
      auto hexv = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
      };
      int hi = hexv(s[i + 1]), lo = hexv(s[i + 2]);
      if (hi >= 0 && lo >= 0) {
        out += (char)((hi << 4) | lo);
        i += 2;
        continue;
      }
    }
    out += s[i] == '+' ? ' ' : s[i];
  }
  return out;
}

static std::map<std::string, std::string> parse_query(const std::string& q) {
  std::map<std::string, std::string> out;
  size_t pos = 0;
  while (pos <= q.size()) {
    size_t amp = q.find('&', pos);
    std::string kv = q.substr(pos, amp == std::string::npos ? amp : amp - pos);
    if (!kv.empty()) {
      size_t e = kv.find('=');
      if (e == std::string::npos) out[url_decode(kv)] = "";
      else out[url_decode(kv.substr(0, e))] = url_decode(kv.substr(e + 1));
    }
    if (amp == std::string::npos) break;
    pos = amp + 1;
  }
  return out;
}

// path: /api/v1[/namespaces/NS]/(nodes|pods)[/NAME][/status]
struct PathMatch {
  bool ok = false;
  int kind = -1;
  std::string ns, name;
  bool status = false;
  bool binding = false;
  bool log = false;  // pods/NAME/log (GET-only; answers the kwok dialect)
};

static PathMatch match_path(const std::string& path) {
  PathMatch m;
  const std::string core = "/api/v1";
  const std::string rbac = "/apis/rbac.authorization.k8s.io/v1";
  // a real v1.19+ kube-scheduler records events via events.k8s.io/v1; both
  // groups route to the one events store (the real apiserver mirrors them)
  const std::string evg = "/apis/events.k8s.io/v1";
  std::string rest;
  bool is_rbac = false;
  bool is_events_group = false;
  if (path.rfind(rbac, 0) == 0) {
    rest = path.substr(rbac.size());
    is_rbac = true;
  } else if (path.rfind(evg, 0) == 0) {
    rest = path.substr(evg.size());
    is_events_group = true;
  } else if (path.rfind(core, 0) == 0) {
    rest = path.substr(core.size());
  } else {
    return m;
  }
  std::vector<std::string> parts;
  size_t pos = 0;
  while (pos < rest.size()) {
    if (rest[pos] == '/') {
      pos++;
      continue;
    }
    size_t slash = rest.find('/', pos);
    parts.push_back(
        rest.substr(pos, slash == std::string::npos ? slash : slash - pos));
    if (slash == std::string::npos) break;
    pos = slash + 1;
  }
  size_t i = 0;
  if (i + 1 < parts.size() && parts[i] == "namespaces") {
    m.ns = url_decode(parts[i + 1]);
    i += 2;
  }
  if (i >= parts.size()) return m;
  m.kind = kind_index(parts[i]);
  if (m.kind < 0) return m;
  // group membership: nodes/pods/events live under /api/v1, rbac kinds
  // under /apis/rbac.authorization.k8s.io/v1, events also under
  // /apis/events.k8s.io/v1 (mirrors mockserver.py)
  if (is_events_group) {
    if (m.kind != 6) return m;
  } else if (is_rbac != (m.kind >= 2 && m.kind <= 5)) {
    return m;
  }
  i++;
  if (i < parts.size()) {
    m.name = url_decode(parts[i]);
    i++;
  }
  if (i < parts.size()) {
    // subresources exist only where the real apiserver serves them:
    // status under nodes/pods, binding under pods (404 otherwise)
    if (parts[i] == "status" && m.kind <= 1) m.status = true;
    else if (parts[i] == "binding" && m.kind == 1) m.binding = true;
    else if (parts[i] == "log" && m.kind == 1) m.log = true;
    else return m;
    i++;
  }
  if (i != parts.size()) return m;
  m.ok = true;
  return m;
}

// A request the batched write transaction may absorb: a plain create /
// bind / patch / delete on a resource path. Fenced writes (the HA
// plane's X-Kwok-Lease-Holder) stay on the unary path, which holds
// lease_mu across its whole mutation; Connection: close and every
// read/stream/ops shape also stay unary.
static bool batchable_write(const Request& req) {
  if (req.close || !req.lease_holder.empty()) return false;
  PathMatch m = match_path(req.path);
  if (!m.ok || m.log) return false;
  if (req.method == "POST") return m.name.empty() ? !m.status : m.binding;
  if (req.method == "PATCH" || req.method == "DELETE")
    return !m.name.empty() && !m.binding;
  return false;
}

// Discovery documents served by GET on these exact paths; byte-content
// mirrors mockserver.py DISCOVERY (json.dumps compact) — parity-tested.
static const std::pair<const char*, const char*> DISCOVERY_DOCS[] = {
    {"/version",
     R"DISC({"major":"1","minor":"26","gitVersion":"v1.26.0-kwok-tpu","platform":"linux/amd64"})DISC"},
    {"/api",
     R"DISC({"kind":"APIVersions","versions":["v1"]})DISC"},
    {"/apis",
     R"DISC({"kind":"APIGroupList","apiVersion":"v1","groups":[{"name":"rbac.authorization.k8s.io","versions":[{"groupVersion":"rbac.authorization.k8s.io/v1","version":"v1"}],"preferredVersion":{"groupVersion":"rbac.authorization.k8s.io/v1","version":"v1"}},{"name":"events.k8s.io","versions":[{"groupVersion":"events.k8s.io/v1","version":"v1"}],"preferredVersion":{"groupVersion":"events.k8s.io/v1","version":"v1"}},{"name":"coordination.k8s.io","versions":[{"groupVersion":"coordination.k8s.io/v1","version":"v1"}],"preferredVersion":{"groupVersion":"coordination.k8s.io/v1","version":"v1"}}]})DISC"},
    {"/api/v1",
     R"DISC({"kind":"APIResourceList","groupVersion":"v1","resources":[{"name":"nodes","singularName":"","namespaced":false,"kind":"Node","verbs":["create","delete","get","list","patch","update","watch"]},{"name":"nodes/status","singularName":"","namespaced":false,"kind":"Node","verbs":["get","patch","update"]},{"name":"pods","singularName":"","namespaced":true,"kind":"Pod","verbs":["create","delete","get","list","patch","update","watch"]},{"name":"pods/status","singularName":"","namespaced":true,"kind":"Pod","verbs":["get","patch","update"]},{"name":"pods/binding","singularName":"","namespaced":true,"kind":"Pod","verbs":["create"]},{"name":"events","singularName":"","namespaced":true,"kind":"Event","verbs":["create","delete","get","list","patch","update","watch"]}]})DISC"},
    {"/apis/rbac.authorization.k8s.io/v1",
     R"DISC({"kind":"APIResourceList","groupVersion":"rbac.authorization.k8s.io/v1","resources":[{"name":"roles","singularName":"","namespaced":true,"kind":"Role","verbs":["create","delete","get","list","patch","update","watch"]},{"name":"rolebindings","singularName":"","namespaced":true,"kind":"RoleBinding","verbs":["create","delete","get","list","patch","update","watch"]},{"name":"clusterroles","singularName":"","namespaced":false,"kind":"ClusterRole","verbs":["create","delete","get","list","patch","update","watch"]},{"name":"clusterrolebindings","singularName":"","namespaced":false,"kind":"ClusterRoleBinding","verbs":["create","delete","get","list","patch","update","watch"]}]})DISC"},
    {"/apis/events.k8s.io/v1",
     R"DISC({"kind":"APIResourceList","groupVersion":"events.k8s.io/v1","resources":[{"name":"events","singularName":"","namespaced":true,"kind":"Event","verbs":["create","delete","get","list","patch","update","watch"]}]})DISC"},
    // the minimal Lease dialect: create / get / patch only (ISSUE 12)
    {"/apis/coordination.k8s.io/v1",
     R"DISC({"kind":"APIResourceList","groupVersion":"coordination.k8s.io/v1","resources":[{"name":"leases","singularName":"","namespaced":true,"kind":"Lease","verbs":["create","get","patch"]}]})DISC"},
};

// ------------------------------------------------------------------ app

// The 429 dialect, byte-identical to mockserver.py TOO_MANY_REQUESTS_BODY
// (parity-pinned): kube-apiserver's TooManyRequests Status plus a
// Retry-After hint the client's RetryPolicy must honor.
static const char* TOO_MANY_REQUESTS_BODY =
    "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":\"Failure\","
    "\"message\":\"Too many requests, please try again later.\","
    "\"reason\":\"TooManyRequests\",\"code\":429}";

struct App {
  Store store;
  std::mutex audit_mu;
  FILE* audit = nullptr;
  std::string data_file;
  // --token-auth-file bearer tokens, one per CSV row (empty = authn off);
  // kube-apiserver accepts every row of the file, not just the first
  std::set<std::string> auth_tokens;
  int listen_fd = -1;
  std::atomic<bool> stopping{false};
  // two-band max-inflight admission (kube-apiserver
  // --max-requests-inflight / --max-mutating-requests-inflight; KEP-1040
  // reject-don't-queue shape). 0 = band off (the default: the admission
  // branch is never entered, zero per-request cost). Index 0 = readonly
  // (LIST/GET), 1 = mutating (POST/PATCH/DELETE); watches are
  // long-running and exempt, bounded by watch_backlog() instead.
  long max_inflight_band[2] = {0, 0};
  std::atomic<long> inflight[2] = {{0}, {0}};
  std::atomic<long> rejected[2] = {{0}, {0}};

  void audit_line(const std::string& method, const std::string& uri, int code);
  void handle_conn(int fd);
  bool handle_request(ConnIO& io, Request& req);
  size_t exec_write_batch(ConnIO& io, std::vector<Request>& batch);
  void evict_events(double* fanout_us);
  std::string metrics_text();
  std::string watchers_dump_json();
  std::string snapshot_dump();
  void restore_load(const JVal& data);
  void seed_rbac();
  void persist();
};

static App* g_app = nullptr;

void App::audit_line(const std::string& method, const std::string& uri,
                     int code) {
  if (!audit) return;
  // HTTP method + URI -> k8s audit verb (matches the Python mock)
  std::string verb;
  if (method == "GET") {
    verb = "get";
    size_t qm = uri.find('?');
    std::string path = qm == std::string::npos ? uri : uri.substr(0, qm);
    std::string query = qm == std::string::npos ? "" : uri.substr(qm + 1);
    auto q = parse_query(query);
    auto w = q.find("watch");
    if (w != q.end() && (w->second == "true" || w->second == "1")) {
      verb = "watch";
    } else {
      PathMatch m = match_path(path);
      if (m.ok && m.name.empty()) verb = "list";
    }
  } else if (method == "POST") verb = "create";
  else if (method == "PUT") verb = "update";
  else if (method == "PATCH") verb = "patch";
  else if (method == "DELETE") verb = "delete";
  else {
    verb = method;
    std::transform(verb.begin(), verb.end(), verb.begin(), ::tolower);
  }
  std::string line =
      "{\"kind\": \"Event\", \"apiVersion\": \"audit.k8s.io/v1\", "
      "\"level\": \"Metadata\", \"stage\": \"ResponseComplete\", \"verb\": \"";
  line += verb;
  line += "\", \"requestURI\": \"";
  json_escape(line, uri);
  line += "\", \"responseStatus\": {\"code\": ";
  line += std::to_string(code);
  line += "}, \"stageTimestamp\": \"";
  line += now_rfc3339();
  line += "\"}\n";
  std::lock_guard<std::mutex> lk(audit_mu);
  fwrite(line.data(), 1, line.size(), audit);
  fflush(audit);
}

std::string App::metrics_text() {
  // overload-protection surface, HELP text byte-identical to
  // kwok_tpu/telemetry/apiserver_metrics.py (both servers scrape alike)
  static const char* BANDS[2] = {"readonly", "mutating"};
  std::string out;
  out +=
      "# HELP kwok_apiserver_inflight Requests currently admitted per "
      "max-inflight band (readonly=LIST/GET, mutating=POST/PATCH/DELETE; "
      "watches exempt)\n# TYPE kwok_apiserver_inflight gauge\n";
  for (int b = 0; b < 2; b++)
    out += "kwok_apiserver_inflight{band=\"" + std::string(BANDS[b]) +
           "\"} " + std::to_string(inflight[b].load()) + "\n";
  out +=
      "# HELP kwok_apiserver_rejected_total Requests rejected with 429 + "
      "Retry-After because the band's max-inflight limit was saturated\n"
      "# TYPE kwok_apiserver_rejected_total counter\n";
  for (int b = 0; b < 2; b++)
    out += "kwok_apiserver_rejected_total{band=\"" + std::string(BANDS[b]) +
           "\"} " + std::to_string(rejected[b].load()) + "\n";
  out +=
      "# HELP kwok_watch_terminations_total Watch streams closed by the "
      "server (slow=send-buffer overflow from a consumer that stopped "
      "reading, deadline=timeoutSeconds expiry)\n"
      "# TYPE kwok_watch_terminations_total counter\n";
  out += "kwok_watch_terminations_total{reason=\"slow\"} " +
         std::to_string(g_watch_term_slow.load()) + "\n";
  out += "kwok_watch_terminations_total{reason=\"deadline\"} " +
         std::to_string(g_watch_term_deadline.load()) + "\n";

  // ---- phase-timing families (ISSUE 11): HELP text, bucket labels and
  // the full phase/verb sample matrix are byte-identical to
  // telemetry/apiserver_metrics.render_timing_metrics — only the sample
  // values differ (the parity twin masks them)
  char fbuf[64];
  auto hist_lines = [&out, &fbuf](const char* name, const char* label,
                                  const char* value, const PhaseHist& h) {
    uint64_t acc = 0;
    for (int i = 0; i < N_TBUCKETS; i++) {
      acc += h.buckets[i].load(std::memory_order_relaxed);
      out += std::string(name) + "_bucket{" + label + "=\"" + value +
             "\",le=\"" + TBUCKET_LE[i] + "\"} " + std::to_string(acc) +
             "\n";
    }
    // count is read LAST; clamp so a mid-scrape observe can never leave
    // the +Inf bucket (rendered from count) below a finite bucket
    uint64_t c = h.count.load(std::memory_order_relaxed);
    acc += h.buckets[N_TBUCKETS].load(std::memory_order_relaxed);
    if (c < acc) c = acc;
    out += std::string(name) + "_bucket{" + label + "=\"" + value +
           "\",le=\"+Inf\"} " + std::to_string(c) + "\n";
    snprintf(fbuf, sizeof fbuf, "%.9f",
             (double)h.sum_ns.load(std::memory_order_relaxed) / 1e9);
    out += std::string(name) + "_sum{" + label + "=\"" + value + "\"} " +
           fbuf + "\n";
    out += std::string(name) + "_count{" + label + "=\"" + value + "\"} " +
           std::to_string(c) + "\n";
  };
  out +=
      "# HELP kwok_apiserver_request_phase_seconds Per-request phase "
      "seconds inside the mock apiserver (read_headers+read_body+parse+"
      "commit+encode reconcile to the request total; fanout is the "
      "serialize-once ring encode+append subset of commit and is excluded "
      "from the sum)\n# TYPE kwok_apiserver_request_phase_seconds histogram\n";
  for (int p = 0; p < N_PHASES; p++)
    hist_lines("kwok_apiserver_request_phase_seconds", "phase",
               PHASE_NAMES[p], g_phase_hist[p]);
  out +=
      "# HELP kwok_apiserver_request_seconds End-to-end seconds per "
      "unary request by audit verb (first request bytes to response "
      "queued; watch streams are long-running and excluded)\n"
      "# TYPE kwok_apiserver_request_seconds histogram\n";
  for (int v = 0; v < N_VERBS; v++)
    hist_lines("kwok_apiserver_request_seconds", "verb", VERB_NAMES[v],
               g_verb_hist[v]);
  out +=
      "# HELP kwok_watch_fanout_total Watch events delivered to "
      "individual watchers via the broadcast ring (events x live "
      "watchers of the kind at emit; fanout_sum over this count is the "
      "AMORTIZED per-watcher encode cost \xe2\x80\x94 the ring encodes once and "
      "shares the bytes)\n"
      "# TYPE kwok_watch_fanout_total counter\n";
  out += "kwok_watch_fanout_total " +
         std::to_string(g_fanout_pushes.load()) + "\n";
  long n_watch = 0, bmax = 0, btotal = 0, encodes = 0;
  {
    std::lock_guard<std::mutex> lk(store.ring_mu);
    for (const auto& w : store.watches) {
      if (w->closed) continue;
      long d = (long)(store.ring_next - w->cursor);
      n_watch++;
      btotal += d;
      if (d > bmax) bmax = d;
    }
    encodes = store.encode_total;
  }
  out +=
      "# HELP kwok_apiserver_watchers Live watch streams currently "
      "registered\n# TYPE kwok_apiserver_watchers gauge\n";
  out += "kwok_apiserver_watchers " + std::to_string(n_watch) + "\n";
  out +=
      "# HELP kwok_watch_backlog_events Per-watcher ring-cursor lag "
      "across live watches (agg=max/total) and the high-watermark of "
      "retained lag (agg=peak; never exceeds KWOK_TPU_WATCH_BACKLOG "
      "while the slow-consumer cap enforces \xe2\x80\x94 the bounded-buffer "
      "proof, now measured as ring lag)\n"
      "# TYPE kwok_watch_backlog_events gauge\n";
  out += "kwok_watch_backlog_events{agg=\"max\"} " +
         std::to_string(bmax) + "\n";
  out += "kwok_watch_backlog_events{agg=\"total\"} " +
         std::to_string(btotal) + "\n";
  out += "kwok_watch_backlog_events{agg=\"peak\"} " +
         std::to_string(g_backlog_peak.load()) + "\n";
  out +=
      "# HELP kwok_watch_ring_lag Ring-cursor lag behind the "
      "serialize-once broadcast ring head per live watch stream "
      "(agg=max/total) and its all-time high-watermark (agg=peak, "
      "clamped to the backlog cap on a slow-close; identical to "
      "kwok_watch_backlog_events by construction \xe2\x80\x94 the explicit "
      "ring-surface name)\n"
      "# TYPE kwok_watch_ring_lag gauge\n";
  out += "kwok_watch_ring_lag{agg=\"max\"} " + std::to_string(bmax) + "\n";
  out += "kwok_watch_ring_lag{agg=\"total\"} " +
         std::to_string(btotal) + "\n";
  out += "kwok_watch_ring_lag{agg=\"peak\"} " +
         std::to_string(g_backlog_peak.load()) + "\n";
  out +=
      "# HELP kwok_watch_encode_total Watch events encoded into the "
      "broadcast ring \xe2\x80\x94 exactly ONE encode per event no matter the "
      "watcher count (the serialize-once proof; "
      "kwok_watch_fanout_total counts the deliveries the shared bytes "
      "fan out to)\n"
      "# TYPE kwok_watch_encode_total counter\n";
  out += "kwok_watch_encode_total " + std::to_string(encodes) + "\n";
  out +=
      "# HELP kwok_watch_cursor_lag_events Final ring-cursor lag (events "
      "behind the broadcast ring head) observed once per watch close: "
      "slow terminations record the overflow that killed the stream, "
      "graceful closes the drained tail; per-watcher live lag is GET "
      "/debug/watchers\n"
      "# TYPE kwok_watch_cursor_lag_events histogram\n";
  {
    uint64_t acc = 0;
    for (int i = 0; i < N_LBUCKETS; i++) {
      acc += g_lag_buckets[i].load(std::memory_order_relaxed);
      out += "kwok_watch_cursor_lag_events_bucket{le=\"" +
             std::string(LBUCKET_LE[i]) + "\"} " + std::to_string(acc) +
             "\n";
    }
    uint64_t c = g_lag_count.load(std::memory_order_relaxed);
    acc += g_lag_buckets[N_LBUCKETS].load(std::memory_order_relaxed);
    if (c < acc) c = acc;  // +Inf can never render below a finite bucket
    out += "kwok_watch_cursor_lag_events_bucket{le=\"+Inf\"} " +
           std::to_string(c) + "\n";
    out += "kwok_watch_cursor_lag_events_sum " +
           std::to_string(g_lag_sum.load(std::memory_order_relaxed)) + "\n";
    out += "kwok_watch_cursor_lag_events_count " + std::to_string(c) + "\n";
  }
  return out;
}

std::string App::watchers_dump_json() {
  // GET /debug/watchers (ISSUE 16): the watch-plane census — one
  // consistent ring-lock read of every live watch. Key order and value
  // vocabulary mirror mockserver.py watchers_doc (schema parity-pinned
  // by kwok_tpu.telemetry.timeline.check_watchers).
  long cap = watch_backlog();
  double now = wall_unix_s();
  char num[64];
  std::string ws;
  long count = 0, parked = 0;
  {
    std::lock_guard<std::mutex> lk(store.ring_mu);
    for (const auto& w : store.watches) {
      if (w->closed) continue;
      long lag = (long)(store.ring_next - w->cursor);
      if (lag < 0) lag = 0;
      long replay = w->replay_pending.load(std::memory_order_relaxed);
      // fully drained: its delivery thread is parked in the ring cv
      // wait — the per-watcher thread cost the reactor rewrite erases
      if (lag == 0 && replay == 0) parked++;
      const char* risk =
          lag == 0 ? "none" : (lag <= cap / 2 ? "lagging" : "at_risk");
      if (count) ws += ',';
      count++;
      ws += "{\"kind\":\"";
      ws += KIND_NAMES[w->kind];
      ws += "\",\"lag_events\":" + std::to_string(lag);
      ws += ",\"replay_pending\":" + std::to_string(replay);
      double age = now - w->created_unix;
      if (age < 0) age = 0;
      snprintf(num, sizeof num, ",\"age_s\":%.3f", age);
      ws += num;
      ws += ",\"band\":\"none\",\"risk\":\"";  // watches are band-exempt
      ws += risk;
      ws += "\"}";
    }
  }
  std::string out =
      "{\"server\":\"native\",\"backlog_cap\":" + std::to_string(cap);
  out += ",\"thread_per_watcher\":true,\"count\":" + std::to_string(count);
  out += ",\"parked_threads\":" + std::to_string(parked);
  out += ",\"watchers\":[" + ws + "]}";
  return out;
}

std::string App::snapshot_dump() {
  // Sharded walk, rolled back through the undo log to ONE revision
  // across every kind (the mock's consistent etcd snapshot); objects are
  // ordered by (namespace, name) — the maps' natural order, pinned by
  // the snapshot-ordering parity twin.
  std::map<Key, EntryPtr> snap[NKINDS];
  int64_t rv_start = 0;
  for (int attempt = 0; attempt < 4; attempt++) {
    {
      std::lock_guard<std::mutex> lk(store.mu);
      rv_start = store.rv;
    }
    for (int k = 0; k < NKINDS; k++) {
      snap[k].clear();
      for (auto& ns_sh : store.kind_shards(k)) {
        std::lock_guard<std::mutex> sl(ns_sh.second->smu);
        for (auto& kv : ns_sh.second->objs)
          snap[k][Key{ns_sh.first, kv.first}] = kv.second;
      }
    }
    std::lock_guard<std::mutex> lk(store.mu);
    if (rv_window() > 0 && rv_start < store.compacted_rv && attempt < 3)
      continue;  // compaction raced the walk: retry
    for (auto u = store.undo.rbegin(); u != store.undo.rend(); ++u) {
      if (u->rv <= rv_start) break;
      if (u->prev)
        snap[u->kind][u->key] = u->prev;
      else
        snap[u->kind].erase(u->key);
    }
    break;
  }
  std::string out = "{\"resourceVersion\":";
  out += std::to_string(rv_start);
  out += ",\"objects\":{";
  for (int k = 0; k < NKINDS; k++) {
    if (k) out += ',';
    out += '"';
    out += KIND_NAMES[k];
    out += "\":[";
    bool first = true;
    for (auto& kv : snap[k]) {
      if (!first) out += ',';
      first = false;
      out += kv.second->bytes;
    }
    out += ']';
  }
  out += "}}";
  return out;
}

void App::restore_load(const JVal& data) {
  // Build the fresh shard registry OFF-lock, swap it in, then compact
  // and close watches: a reader holding an old shard sees the
  // pre-restore world, never a torn one.
  std::map<std::string, ShardPtr> fresh[NKINDS];
  long counts[NKINDS] = {};
  std::map<std::string, long> phases[NKINDS];
  const JVal* objects = data.find("objects");
  if (objects && objects->type == JVal::OBJ) {
    for (int k = 0; k < NKINDS; k++) {
      const JVal* list = objects->find(KIND_NAMES[k]);
      if (!list || list->type != JVal::ARR) continue;
      for (const JVal& obj : list->arr) {
        Key key = Store::obj_key(obj);
        if (key.second.empty()) continue;
        auto& sh = fresh[k][key.first];
        if (!sh) sh = std::make_shared<Shard>();
        EntryPtr e = publish(obj);
        if (!sh->objs.count(key.second)) counts[k]++;
        phases[k][field_str(e->obj, "status.phase")]++;
        sh->objs[key.second] = e;
      }
    }
  }
  {
    std::lock_guard<std::mutex> sl(store.shards_mu);
    for (int k = 0; k < NKINDS; k++) store.shards[k].swap(fresh[k]);
  }
  {
    std::lock_guard<std::mutex> lk(store.mu);
    for (int k = 0; k < NKINDS; k++) {
      store.phase_idx[k] = std::move(phases[k]);
      store.obj_count[k] = counts[k];
    }
    int64_t rv = 0;
    const JVal* rvv = data.find("resourceVersion");
    if (rvv && rvv->type == JVal::NUM) rv = atoll(rvv->s.c_str());
    store.rv = std::max(store.rv, rv) + 1;
    // history predates the restore: compact so resumed watches and
    // continue tokens from the old world get 410 and re-list
    store.history.clear();
    store.undo.clear();
    store.compacted_rv = store.rv;
    std::lock_guard<std::mutex> rl(store.ring_mu);
    for (auto& w : store.watches) store.close_watch_locked(w, false);
    store.watches.clear();
    store.ring.clear();
    store.ring_min = store.ring_next;
  }
  store.ring_cv.notify_all();
}

// Bootstrap RBAC policy for --authorization: a representative subset of
// what the real apiserver's bootstrap controller creates, byte-identical in
// content to mockserver.py BOOTSTRAP_RBAC (the authorization e2e + parity
// tests assert the two servers seed the same objects).
static const char* BOOTSTRAP_RBAC_JSON = R"JSON({
"clusterroles": [
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"ClusterRole",
  "metadata":{"name":"cluster-admin","labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "rules":[{"apiGroups":["*"],"resources":["*"],"verbs":["*"]},
           {"nonResourceURLs":["*"],"verbs":["*"]}]},
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"ClusterRole",
  "metadata":{"name":"system:discovery","labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "rules":[{"nonResourceURLs":["/api","/api/*","/apis","/apis/*","/healthz","/version"],"verbs":["get"]}]},
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"ClusterRole",
  "metadata":{"name":"system:kwok-controller","labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "rules":[{"apiGroups":[""],"resources":["nodes","pods"],"verbs":["get","watch","list"]},
           {"apiGroups":[""],"resources":["nodes/status","pods/status"],"verbs":["update","patch"]}]}
],
"clusterrolebindings": [
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"ClusterRoleBinding",
  "metadata":{"name":"cluster-admin","labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "roleRef":{"apiGroup":"rbac.authorization.k8s.io","kind":"ClusterRole","name":"cluster-admin"},
  "subjects":[{"apiGroup":"rbac.authorization.k8s.io","kind":"Group","name":"system:masters"}]},
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"ClusterRoleBinding",
  "metadata":{"name":"system:kwok-controller","labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "roleRef":{"apiGroup":"rbac.authorization.k8s.io","kind":"ClusterRole","name":"system:kwok-controller"},
  "subjects":[{"kind":"ServiceAccount","name":"kwok-controller","namespace":"kube-system"}]}
],
"roles": [
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"Role",
  "metadata":{"name":"extension-apiserver-authentication-reader","namespace":"kube-system",
              "labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "rules":[{"apiGroups":[""],"resources":["configmaps"],
            "resourceNames":["extension-apiserver-authentication"],
            "verbs":["get","list","watch"]}]}
],
"rolebindings": [
 {"apiVersion":"rbac.authorization.k8s.io/v1","kind":"RoleBinding",
  "metadata":{"name":"system::extension-apiserver-authentication-reader","namespace":"kube-system",
              "labels":{"kubernetes.io/bootstrapping":"rbac-defaults"}},
  "roleRef":{"apiGroup":"rbac.authorization.k8s.io","kind":"Role",
             "name":"extension-apiserver-authentication-reader"},
  "subjects":[{"apiGroup":"rbac.authorization.k8s.io","kind":"User",
               "name":"system:kube-controller-manager"}]}
]
})JSON";

void App::seed_rbac() {
  // materialize the literal: JParser keeps pointers into the string
  const std::string text = BOOTSTRAP_RBAC_JSON;
  JParser p(text);
  JVal data = p.parse();
  if (!p.ok) return;
  for (const auto& kv : data.obj) {
    int k = kind_index(kv.first);
    if (k < 0 || kv.second.type != JVal::ARR) continue;
    for (const JVal& tmpl : kv.second.arr) {
      Key key = Store::obj_key(tmpl);
      if (key.second.empty()) continue;
      ShardPtr sh = store.shard_of(k, key.first);
      std::lock_guard<std::mutex> sl(sh->smu);
      if (sh->objs.count(key.second)) continue;
      JVal obj = tmpl;  // idempotent create-if-absent (data-file restarts)
      JVal& meta = obj.get_or_insert_obj("metadata");
      meta.set("creationTimestamp", JVal::str(now_rfc3339()));
      // seeding happens before the listener accepts watchers, so the
      // ring append inside commit is vacuous (no watchers registered)
      std::lock_guard<std::mutex> lk(store.mu);
      EntryPtr e = store.commit_locked(k, "ADDED", std::move(obj), key,
                                       nullptr, nullptr, sh.get(),
                                       /*stamp_uid=*/true);
      sh->objs[key.second] = e;
    }
  }
}

// The real apiserver expires events on a ~1h etcd lease (re-leased on
// every write); the mock bounds the store by count — the least-recently-
// written event (smallest resourceVersion) is evicted after an insert
// pushes past the cap. Runs OUTSIDE the creating shard's critical
// section: the victim may live in another namespace shard, and shard
// locks never nest (mirrors mockserver._evict_events_overflow).
void App::evict_events(double* fanout_us) {
  int ek = kind_index("events");
  long cap = events_cap();
  if (cap <= 0) return;
  while (true) {
    {
      std::lock_guard<std::mutex> lk(store.mu);
      if (store.obj_count[ek] <= cap) return;
    }
    // find the min-rv victim across the kind's shards (O(cap) scan,
    // paid only past the cap; never the just-created entry — its rv is
    // the newest)
    std::string v_ns, v_name;
    long long best = 0;
    bool have = false;
    for (auto& ns_sh : store.kind_shards(ek)) {
      std::lock_guard<std::mutex> sl(ns_sh.second->smu);
      for (auto& kv : ns_sh.second->objs) {
        const JVal* mv = kv.second->obj.find("metadata");
        const JVal* rv = mv ? mv->find("resourceVersion") : nullptr;
        long long n = rv ? atoll(rv->s.c_str()) : 0;
        if (!have || n < best) {
          have = true;
          best = n;
          v_ns = ns_sh.first;
          v_name = kv.first;
        }
      }
    }
    if (!have) return;
    ShardPtr sh = store.shard_of(ek, v_ns, /*create=*/false);
    if (!sh) return;
    bool erased = false;
    {
      std::lock_guard<std::mutex> sl(sh->smu);
      auto it = sh->objs.find(v_name);
      if (it != sh->objs.end()) {
        // deletion is a write: bump like the explicit DELETE path, so
        // the DELETED event gets its own revision (rv-resuming watchers
        // would otherwise never see the eviction)
        JVal vobj = it->second->obj;  // copy-on-write
        EntryPtr vprev = it->second;
        sh->objs.erase(it);
        std::lock_guard<std::mutex> lk(store.mu);
        store.commit_locked(ek, "DELETED", std::move(vobj),
                            Key{v_ns, v_name}, std::move(vprev),
                            fanout_us, sh.get());
        erased = true;
      }
    }
    if (erased) store.ring_cv.notify_all();
    // raced evictions still make progress (the other thread erased);
    // loop re-checks the population either way
  }
}

void App::persist() {
  if (data_file.empty()) return;
  std::string tmp = data_file + ".tmp";
  FILE* f = fopen(tmp.c_str(), "w");
  if (!f) return;
  std::string dump = snapshot_dump();
  fwrite(dump.data(), 1, dump.size(), f);
  fclose(f);
  rename(tmp.c_str(), data_file.c_str());
}

// returns false when the connection must close
// >>> the port's drift rig routes
// The drift rig's routes (--rig-routes; without the flag /rig/ is not
// served): changes to the store behind its watchers' backs, route for
// route those of drift_rig.py's RigApiserver over the Python mock. They
// add no watch event and no watch-cache or undo entry; a silent create
// takes a real revision. POST /rig/silent {"op": "phase" | "delete" |
// "create", "kind", "namespace", "name", "phase" | "object"}; POST
// /rig/window {"events"}; POST /rig/stop-watches; GET /rig/state (the
// pods Running with a pod IP, the pods, the first names not Running, the
// watch terminations by reason, the revision).
static std::string rig_route(Store& store, const Request& req, int& code) {
  static const std::string ok_true = "{\"ok\":true}";
  static const std::string ok_false = "{\"ok\":false}";
  code = 200;
  if (req.method == "GET" && req.path == "/rig/state") {
    int pods = kind_index("pods");
    long running = 0, total = 0;
    std::vector<std::string> stuck;
    for (auto& ns_sh : store.kind_shards(pods)) {
      std::lock_guard<std::mutex> sl(ns_sh.second->smu);
      for (auto& kv : ns_sh.second->objs) {
        total++;
        if (field_str(kv.second->obj, "status.phase") == "Running" &&
            !field_str(kv.second->obj, "status.podIP").empty())
          running++;
        else
          stuck.push_back(kv.first);
      }
    }
    std::sort(stuck.begin(), stuck.end());
    int64_t rv;
    {
      std::lock_guard<std::mutex> lk(store.mu);
      rv = store.rv;
    }
    std::string out = "{\"running\":" + std::to_string(running) +
                      ",\"pods\":" + std::to_string(total) +
                      ",\"not_running\":[";
    for (size_t i = 0; i < stuck.size() && i < 8; i++) {
      if (i) out += ',';
      out += '"';
      json_escape(out, stuck[i]);
      out += '"';
    }
    out += "],\"terminations\":{\"slow\":" +
           std::to_string(g_watch_term_slow.load()) + ",\"deadline\":" +
           std::to_string(g_watch_term_deadline.load()) +
           "},\"rv\":" + std::to_string(rv) + "}";
    return out;
  }
  if (req.method != "POST") {
    code = 404;
    return "{\"error\":\"no rig route\"}";
  }
  if (req.path == "/rig/stop-watches") {
    {
      std::lock_guard<std::mutex> lk(store.mu);
      std::lock_guard<std::mutex> rl(store.ring_mu);
      for (auto& w : store.watches) store.close_watch_locked(w, false);
    }
    store.ring_cv.notify_all();
    return ok_true;
  }
  JParser p(req.body);
  JVal doc = p.parse();
  if (!p.ok || !doc.is_obj()) {
    code = 400;
    return "{\"error\":\"the body is not a JSON object\"}";
  }
  auto str = [&](const char* k) {
    const JVal* v = doc.find(k);
    return v && v->type == JVal::STR ? v->s : std::string();
  };
  if (req.path == "/rig/window") {
    const JVal* v = doc.find("events");
    if (!v || v->type != JVal::NUM) {
      code = 400;
      return "{\"error\":\"events: a number\"}";
    }
    rv_window_cell().store(atoi(v->s.c_str()));
    return ok_true;
  }
  if (req.path != "/rig/silent") {
    code = 404;
    return "{\"error\":\"no rig route\"}";
  }
  std::string op = str("op");
  int kind = kind_index(doc.find("kind") ? str("kind") : "pods");
  if (kind < 0) {
    code = 400;
    return "{\"error\":\"unknown kind\"}";
  }
  if (op == "phase" || op == "delete") {
    ShardPtr sh = store.shard_of(kind, str("namespace"), false);
    if (!sh) return ok_false;
    std::lock_guard<std::mutex> sl(sh->smu);
    auto it = sh->objs.find(str("name"));
    if (it == sh->objs.end()) return ok_false;
    EntryPtr prev = it->second, next;
    if (op == "phase") {
      JVal obj = prev->obj;  // same resourceVersion
      obj.get_or_insert_obj("status").set("phase", JVal::str(str("phase")));
      next = publish(std::move(obj));
      it->second = next;
    } else {
      sh->objs.erase(it);
    }
    std::lock_guard<std::mutex> lk(store.mu);
    store.idx_adjust(kind, prev, next);
    if (!next) store.obj_count[kind]--;
    return ok_true;
  }
  if (op == "create") {
    const JVal* o = doc.find("object");
    JVal obj = o && o->is_obj() ? *o : JVal{};
    Key key = Store::obj_key(obj);
    if (key.second.empty()) {
      code = 400;
      return "{\"error\":\"object: no metadata.name\"}";
    }
    ShardPtr sh = store.shard_of(kind, key.first);
    std::lock_guard<std::mutex> sl(sh->smu);
    if (sh->objs.count(key.second)) {
      code = 400;
      return "{\"error\":\"the object exists\"}";
    }
    std::lock_guard<std::mutex> lk(store.mu);
    store.rv++;
    JVal& meta = obj.get_or_insert_obj("metadata");
    meta.set("resourceVersion", JVal::str(std::to_string(store.rv)));
    if (!meta.find("uid"))
      meta.set("uid", JVal::str("uid-silent-" + std::to_string(store.rv)));
    EntryPtr e = publish(std::move(obj));
    store.idx_adjust(kind, nullptr, e);
    store.obj_count[kind]++;
    sh->objs[key.second] = e;
    return "{\"ok\":true,\"object\":" + e->bytes + "}";
  }
  code = 400;
  return "{\"error\":\"unknown silent op\"}";
}
// <<< the port's drift rig routes

bool App::handle_request(ConnIO& io, Request& req) {
  int fd = io.fd;  // streaming paths (watch) write directly
  auto q = parse_query(req.query);
  std::string uri = req.path;
  if (!req.query.empty()) uri += "?" + req.query;

  // phase timing (ISSUE 11): boundary marks accumulate into pt; the
  // respond chokepoint closes the request and observes/records it.
  // band is declared up here so the finisher can label flight records.
  PhaseTimer pt;
  int band = -1;
  auto finish_timing = [&](int code) {
    if (!req.t_start) return;
    pt.mark(PH_ENCODE);  // response build + audit + queueing since the
                         // last mark (commit end, or body read)
    uint64_t t_end = pt.on ? pt.last : now_ns();
    uint64_t t0 = req.t_start;
    req.t_start = 0;  // one observation per request
    PathMatch fm = match_path(req.path);
    if (!fm.ok) return;  // ops/debug paths stay untimed (Python parity)
    bool is_watch = false;
    if (req.method == "GET") {
      auto wq = q.find("watch");
      is_watch =
          wq != q.end() && (wq->second == "true" || wq->second == "1");
    }
    double total_us = (double)(t_end - t0) / 1000.0;
    uint64_t t_hdr = req.t_hdr ? req.t_hdr : t0;
    uint64_t t_body = req.t_body ? req.t_body : t_hdr;
    pt.us[PH_READ_HEADERS] = (double)(t_hdr - t0) / 1000.0;
    pt.us[PH_READ_BODY] = (double)(t_body - t_hdr) / 1000.0;
    g_phase_hist[PH_READ_HEADERS].observe_ns(t_hdr - t0);
    g_phase_hist[PH_READ_BODY].observe_ns(t_body - t_hdr);
    g_phase_hist[PH_COMMIT].observe_ns(
        (uint64_t)(pt.us[PH_COMMIT] * 1000.0));
    g_phase_hist[PH_ENCODE].observe_ns(
        (uint64_t)(pt.us[PH_ENCODE] * 1000.0));
    if (pt.parsed)
      g_phase_hist[PH_PARSE].observe_ns(
          (uint64_t)(pt.us[PH_PARSE] * 1000.0));
    if (pt.us[PH_FANOUT] > 0)
      g_phase_hist[PH_FANOUT].observe_ns(
          (uint64_t)(pt.us[PH_FANOUT] * 1000.0));
    int vi = 5;  // other (includes watch-handshake errors, Python parity)
    if (req.method == "GET" && !is_watch) vi = fm.name.empty() ? 1 : 0;
    else if (req.method == "POST") vi = 2;
    else if (req.method == "PATCH") vi = 3;
    else if (req.method == "DELETE") vi = 4;
    g_verb_hist[vi].observe_ns(t_end - t0);
    FlightRec rec;
    rec.method = req.method;
    rec.path = uri;
    rec.status = code;
    // band by REQUEST SHAPE (Python _admission_band parity): labeled
    // even when no max-inflight limit is configured
    if (band == 0 || (band < 0 && req.method == "GET" && !is_watch))
      rec.band = "readonly";
    else if (band == 1 ||
             (band < 0 && (req.method == "POST" || req.method == "PATCH" ||
                           req.method == "DELETE")))
      rec.band = "mutating";
    else
      rec.band = "none";
    rec.ts_unix = wall_unix_s() - total_us / 1e6;
    rec.total_us = total_us;
    for (int p = 0; p < N_PHASES; p++) rec.phases_us[p] = pt.us[p];
    flight_record(std::move(rec));
  };

  // Ring wake-ups leave AFTER the response is queued (ISSUE 13):
  // waking a watcher cohort inside the commit window put the whole
  // thundering herd on the requester's critical path — the store is
  // consistent the moment the clock lock dropped, so the fanout wake
  // rides behind the answer instead of in front of it.
  bool wake_ring = false;
  auto respond = [&](int code, const std::string& body,
                     const char* extra = "",
                     const char* ctype = "application/json") {
    audit_line(req.method, uri, code);
    bool ok = queue_response(io, code, body, extra, ctype);
    finish_timing(code);
    if (wake_ring) {
      // deferred fanout wake (see above): the answer goes ON THE WIRE
      // first — on an oversubscribed host a thousand woken watcher
      // threads would otherwise run before the requester's flush
      wake_ring = false;
      if (!io.flush()) ok = false;
      store.ring_cv.notify_all();
    }
    if (req.close) {
      io.flush();
      return false;
    }
    return ok;
  };
  // arm the phase accumulator once the body is consumed (read_body
  // stamped t_body); every later mark() is one clock read
  auto arm_timer = [&] {
    if (req.t_start) {
      pt.on = true;
      pt.last = req.t_body ? req.t_body : now_ns();
    }
  };

  // ---- max-inflight admission (two bands; watches + non-resource paths
  // exempt). The band slot spans the request's whole lifetime — body read
  // included — so saturation is observable; a rejected request answers
  // 429 + Retry-After NOW instead of queueing, after draining its body so
  // the keep-alive pipeline stays parseable.
  if (max_inflight_band[0] > 0 || max_inflight_band[1] > 0) {
    PathMatch am = match_path(req.path);
    if (am.ok) {
      if (req.method == "GET") {
        auto wq = q.find("watch");
        bool is_watch =
            wq != q.end() && (wq->second == "true" || wq->second == "1");
        if (!is_watch) band = 0;
      } else if (req.method == "POST" || req.method == "PATCH" ||
                 req.method == "DELETE") {
        band = 1;
      }
    }
  }
  struct SlotRelease {
    std::atomic<long>* c = nullptr;
    ~SlotRelease() {
      if (c) c->fetch_sub(1);
    }
  } slot;
  if (band >= 0 && max_inflight_band[band] > 0) {
    if (inflight[band].fetch_add(1) + 1 > max_inflight_band[band]) {
      inflight[band].fetch_sub(1);
      rejected[band].fetch_add(1);
      if (!read_body(io, req)) return false;  // drain for keep-alive
      arm_timer();
      return respond(429, TOO_MANY_REQUESTS_BODY, "Retry-After: 1\r\n");
    }
    slot.c = &inflight[band];
  }
  if (!read_body(io, req)) return false;
  arm_timer();

  if (req.method == "GET" && req.path == "/healthz")
    return respond(200, "ok");
  if (req.method == "GET" && req.path == "/metrics")
    return respond(200, metrics_text(), "", "text/plain; version=0.0.4");
  if (req.method == "GET" && req.path == "/debug/flight")
    // flight recorder dump (anonymous, like /metrics): the bounded ring
    // of recent request records — the engine auto-grabs it on a /readyz
    // degradation edge
    return respond(200, flight_dump_json());
  if (req.method == "GET" && req.path == "/debug/watchers")
    // watch-plane census (anonymous, like /debug/flight): per-watcher
    // ring-cursor lag, replay backlog, age, termination risk
    return respond(200, watchers_dump_json());
  // bearer-token authn (--token-auth-file): /healthz stays anonymous (the
  // components' --authorization-always-allow-paths contract)
  if (!auth_tokens.empty() &&
      (req.auth.rfind("Bearer ", 0) != 0 ||
       !auth_tokens.count(req.auth.substr(7))))
    return respond(401,
                   "{\"kind\":\"Status\",\"apiVersion\":\"v1\","
                   "\"status\":\"Failure\",\"reason\":\"Unauthorized\","
                   "\"message\":\"Unauthorized\",\"code\":401}");
  if (req.method == "GET") {
    for (const auto& d : DISCOVERY_DOCS)
      if (req.path == d.first) return respond(200, d.second);
  }
  if (req.method == "GET" && req.path == "/snapshot")
    return respond(200, snapshot_dump());
  if (req.method == "POST" && req.path == "/restore") {
    JParser p(req.body);
    JVal data = p.parse();
    restore_load(data);
    return respond(200, "{\"kind\":\"Status\",\"status\":\"Success\"}");
  }
  if (req.method == "POST" && req.path == "/compact") {
    // the mock's `etcdctl compact`: expire the watch cache and in-flight
    // continue tokens NOW (test/ops hook; the real apiserver compacts
    // every 5 minutes)
    int64_t crv;
    {
      std::lock_guard<std::mutex> lk(store.mu);
      store.history.clear();
      store.undo.clear();
      store.compacted_rv = store.rv;
      crv = store.compacted_rv;
    }
    return respond(200,
                   "{\"compactedRevision\":" + std::to_string(crv) + "}");
  }
  if (g_rig_routes && req.path.rfind("/rig/", 0) == 0) {
    int code;
    std::string body = rig_route(store, req, code);
    return respond(code, body);
  }

  // ---- coordination.k8s.io/v1 leases (ISSUE 12): the leadership plane's
  // minimal dialect — create / GET / PATCH-renew, arbitrated under the
  // store lock by the SERVER's clock. Deliberately outside match_path:
  // exempt from admission/timing like every non-resource path, mirrored
  // byte-for-byte with mockserver.py (parity twins pin it).
  {
    static const std::string lease_prefix =
        "/apis/coordination.k8s.io/v1/namespaces/";
    if (req.path.rfind(lease_prefix, 0) == 0) {
      std::string rest = req.path.substr(lease_prefix.size());
      size_t s1 = rest.find('/');
      std::string lns =
          s1 == std::string::npos ? "" : url_decode(rest.substr(0, s1));
      std::string tail = s1 == std::string::npos ? "" : rest.substr(s1 + 1);
      std::string lname;
      bool routed = false;
      if (tail == "leases") routed = true;
      else if (tail.rfind("leases/", 0) == 0) {
        lname = url_decode(tail.substr(7));
        routed = !lname.empty() && lname.find('/') == std::string::npos;
      }
      if (!lns.empty() && routed) {
        Key lkey{lns, lname};
        if (req.method == "GET" && !lname.empty()) {
          int code = 404;
          std::string body = "{\"kind\":\"Status\",\"code\":404}";
          {
            std::lock_guard<std::mutex> lk(store.lease_mu);
            auto it = store.leases.find(lkey);
            if (it != store.leases.end()) {
              code = 200;
              body = lease_render(lns, lname, it->second);
            }
          }
          return respond(code, body);
        }
        if (req.method == "POST" && lname.empty()) {
          JParser p(req.body);
          JVal obj = p.parse();
          if (!p.ok || obj.type != JVal::OBJ)
            return respond(400, "{\"kind\":\"Status\",\"code\":400}");
          const JVal* meta = obj.find("metadata");
          const JVal* nm = meta && meta->is_obj() ? meta->find("name")
                                                  : nullptr;
          std::string name =
              nm && nm->type == JVal::STR ? nm->s : std::string();
          if (name.empty())
            return respond(400, "{\"kind\":\"Status\",\"code\":400}");
          std::string holder;
          long duration = 0;
          lease_spec_fields(obj, holder, duration);
          int code;
          std::string body;
          {
            std::lock_guard<std::mutex> lk(store.lease_mu);
            if (store.leases.count(Key{lns, name})) {
              code = 409;
              body =
                  "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
                  "\"Failure\",\"message\":\"leases \\\"";
              json_escape(body, name);
              body +=
                  "\\\" already exists\",\"reason\":\"AlreadyExists\","
                  "\"code\":409}";
            } else {
              double now = wall_unix_s();
              std::string stamp = now_rfc3339();
              int64_t lrv;
              {
                // lease writes share the store clock (lease 86 -> ring
                // 88 in the declared order; shards never involved)
                std::lock_guard<std::mutex> rk(store.mu);
                lrv = ++store.rv;
              }
              LeaseRec L;
              L.holder = holder;
              L.duration = duration;
              L.acquire = L.renew = now;
              L.transitions = 0;
              L.created = L.acquire_str = L.renew_str = stamp;
              L.uid = "uid-" + std::to_string(lrv);
              L.rv = lrv;
              store.leases[Key{lns, name}] = L;
              code = 201;
              body = lease_render(lns, name, L);
            }
          }
          return respond(code, body);
        }
        if (req.method == "PATCH" && !lname.empty()) {
          JParser p(req.body);
          JVal patch = p.parse();
          if (!p.ok)
            return respond(400, "{\"kind\":\"Status\",\"code\":400}");
          std::string holder;
          long duration = 0;
          lease_spec_fields(patch, holder, duration);
          int code = 200;
          std::string body;
          {
            std::lock_guard<std::mutex> lk(store.lease_mu);
            auto it = store.leases.find(lkey);
            if (it == store.leases.end()) {
              code = 404;
              body = "{\"kind\":\"Status\",\"code\":404}";
            } else {
              LeaseRec& L = it->second;
              double now = wall_unix_s();
              if (holder != L.holder && !lease_expired(L, now)) {
                // conflict-on-stolen-holder: both the standby's
                // premature grab and a revived zombie's stale renew
                code = 409;
                body =
                    "{\"kind\":\"Status\",\"apiVersion\":\"v1\","
                    "\"status\":\"Failure\",\"message\":\"lease \\\"";
                json_escape(body, lns);
                body += "/";
                json_escape(body, lname);
                body += "\\\" is held by \\\"";
                json_escape(body, L.holder);
                body +=
                    "\\\" and has not expired\",\"reason\":\"Conflict\","
                    "\"code\":409}";
              } else {
                std::string stamp = now_rfc3339();
                if (holder != L.holder) {
                  // expiry-acquire: leadership changes hands
                  L.holder = holder;
                  L.acquire = now;
                  L.acquire_str = stamp;
                  L.transitions++;
                }
                L.renew = now;
                L.renew_str = stamp;
                if (duration > 0) L.duration = duration;
                {
                  std::lock_guard<std::mutex> rk(store.mu);
                  L.rv = ++store.rv;
                }
                body = lease_render(lns, lname, L);
              }
            }
          }
          return respond(code, body);
        }
      }
      return respond(404, "{\"kind\":\"Status\",\"code\":404}");
    }
  }

  PathMatch m = match_path(req.path);
  if (m.binding && req.method != "POST")
    return respond(404, "{\"kind\":\"Status\",\"code\":404}");
  if (m.log && req.method != "GET")
    return respond(404, "{\"kind\":\"Status\",\"code\":404}");
  if (!m.ok || (req.method != "GET" && m.name.empty() && req.method != "POST"))
    return respond(404, "{\"kind\":\"Status\",\"code\":404}");

  // ---- server-side write fencing (ISSUE 12): a mutating request
  // carrying X-Kwok-Lease-Holder ("ns/name/holder") commits only while
  // that lease is currently held by that identity. The claim is parsed
  // here; fence_ok_locked() is evaluated as the FIRST statement inside
  // each mutation site's store-lock critical section — the same lock a
  // takeover PATCH serializes through, so check and commit are one
  // atomic step and a paused-and-revived zombie primary's in-flight
  // bytes die HERE no matter how the takeover interleaves. Requests
  // without the header pay one empty-string test (mirrors
  // mockserver._fenced_commit); the 409 is sent after the lock drops.
  bool fence_claimed =
      !req.lease_holder.empty() &&
      (req.method == "POST" || req.method == "PATCH" ||
       req.method == "DELETE");
  std::string fns, fname, fholder;
  if (fence_claimed) {
    const std::string& hdr = req.lease_holder;
    size_t f1 = hdr.find('/');
    size_t f2 = f1 == std::string::npos ? std::string::npos
                                        : hdr.find('/', f1 + 1);
    fns = f1 == std::string::npos ? "" : hdr.substr(0, f1);
    fname = f2 == std::string::npos ? "" : hdr.substr(f1 + 1, f2 - f1 - 1);
    fholder = f2 == std::string::npos ? "" : hdr.substr(f2 + 1);
  }
  // The fence guard (sharded edition of PR 12's single-critical-section
  // contract): lease_mu is taken BEFORE the shard lock and held across
  // the whole mutation (lease -> shard -> mu), so a takeover PATCH —
  // which serializes on lease_mu — can never interleave between the
  // claim check and the commit. Unfenced requests never touch it.
  auto fence_check = [&](std::unique_lock<std::mutex>& lk) {
    if (!fence_claimed) return true;
    lk = std::unique_lock<std::mutex>(store.lease_mu);
    if (fname.empty() || fholder.empty()) return false;
    auto it = store.leases.find(Key{fns, fname});
    return it != store.leases.end() && it->second.holder == fholder &&
           !lease_expired(it->second, wall_unix_s());
  };
  auto fencing_409 = [&]() {
    std::string body =
        "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
        "\"Failure\",\"message\":\"fencing lease ";
    json_escape(body, fns);
    body += "/";
    json_escape(body, fname);
    body += " is not held by ";
    json_escape(body, fholder);
    body += "\",\"reason\":\"Conflict\",\"code\":409}";
    return respond(409, body);
  };

  Key key{m.ns, m.name};

  if (m.log) {
    // GET pods/NAME/log on a kwok cluster: fake pods have no kubelet, so
    // the real apiserver's proxy to InternalIP:10250 fails and users see
    // the dial error as a 500 Status (mirrors mockserver.pod_log_status;
    // an unscheduled pod gets 400 'not have a host assigned').
    std::string node_name, container = q.count("container") ? q["container"] : "";
    bool found = false;
    std::string node_ip;
    {
      ShardPtr psh = store.shard_of(1, m.ns, /*create=*/false);
      EntryPtr pe;
      if (psh) {
        std::lock_guard<std::mutex> sl(psh->smu);
        auto it = psh->objs.find(m.name);
        if (it != psh->objs.end()) pe = it->second;
      }
      if (pe) {
        found = true;
        node_name = field_str(pe->obj, "spec.nodeName");
        if (container.empty()) {
          const JVal* spec = pe->obj.find("spec");
          const JVal* ctrs = spec && spec->is_obj() ? spec->find("containers") : nullptr;
          if (ctrs && ctrs->type == JVal::ARR && !ctrs->arr.empty())
            container = field_str(ctrs->arr[0], "name");
        }
      }
      if (!node_name.empty()) {
        node_ip = node_name;
        ShardPtr nsh = store.shard_of(0, "", /*create=*/false);
        EntryPtr ne;
        if (nsh) {
          std::lock_guard<std::mutex> sl(nsh->smu);
          auto nit = nsh->objs.find(node_name);
          if (nit != nsh->objs.end()) ne = nit->second;
        }
        if (ne) {
          const JVal* st = ne->obj.find("status");
          const JVal* addrs = st && st->is_obj() ? st->find("addresses") : nullptr;
          if (addrs && addrs->type == JVal::ARR)
            for (const JVal& a : addrs->arr)
              if (field_str(a, "type") == "InternalIP" &&
                  !field_str(a, "address").empty()) {
                node_ip = field_str(a, "address");
                break;
              }
        }
      }
    }
    pt.mark(PH_COMMIT);
    if (!found) {
      std::string body =
          "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":\"Failure\","
          "\"message\":\"pods \\\"";
      json_escape(body, m.name);
      body += "\\\" not found\",\"reason\":\"NotFound\",\"code\":404}";
      return respond(404, body);
    }
    if (node_name.empty()) {
      std::string body =
          "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":\"Failure\","
          "\"message\":\"pod ";
      json_escape(body, m.name);
      body += " does not have a host assigned\",\"reason\":\"BadRequest\","
              "\"code\":400}";
      return respond(400, body);
    }
    std::string url = "https://" + node_ip + ":10250/containerLogs/" + m.ns +
                      "/" + m.name + "/" + container;
    std::string msg = "Get \"" + url + "\": dial tcp " + node_ip +
                      ":10250: connect: connection refused";
    std::string body =
        "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":\"Failure\","
        "\"message\":\"";
    json_escape(body, msg);
    body += "\",\"code\":500}";
    return respond(500, body);
  }

  if (req.method == "GET") {
    if (!m.name.empty()) {
      // grab the entry ref under the SHARD lock, send outside it: a
      // stalled reader must never wedge the store (and a GET no longer
      // serializes against writers on other shards)
      EntryPtr e;
      ShardPtr sh = store.shard_of(m.kind, m.ns, /*create=*/false);
      if (sh) {
        std::lock_guard<std::mutex> sl(sh->smu);
        auto it = sh->objs.find(m.name);
        if (it != sh->objs.end()) e = it->second;
      }
      pt.mark(PH_COMMIT);
      if (!e) return respond(404, "{\"kind\":\"Status\",\"code\":404}");
      return respond(200, e->bytes);
    }
    std::string fs = q.count("fieldSelector") ? q["fieldSelector"] : "";
    std::string lsq = q.count("labelSelector") ? q["labelSelector"] : "";
    auto wq = q.find("watch");
    if (wq != q.end() && (wq->second == "true" || wq->second == "1")) {
      // ---- watch stream: headers now, then chunked events forever.
      // Responses to earlier pipelined requests must leave first — the
      // stream writes to the socket directly from here on.
      if (!io.flush()) return false;
      auto w = std::make_shared<Watch>();
      w->kind = m.kind;
      w->field_sel = fs;
      w->label_sel = LabelSel::parse(lsq);
      // request deadline (ListOptions.timeoutSeconds): the stream ends
      // CLEANLY (terminal chunk) at the first event boundary past it;
      // non-numeric values parse to 0 = no deadline (atof; the Python
      // mirror ignores unparseable values the same way)
      double timeout_s =
          q.count("timeoutSeconds") ? atof(q["timeoutSeconds"].c_str()) : 0;
      if (q.count("allowWatchBookmarks")) {
        const std::string& ab = q["allowWatchBookmarks"];
        w->bookmarks = (ab == "true" || ab == "1");
      }
      long long wrv = 0;
      if (q.count("resourceVersion")) {
        const std::string& rvs = q["resourceVersion"];
        if (rvs.find_first_not_of("0123456789") != std::string::npos)
          // non-numeric resourceVersion: 400, like the real apiserver
          // (and the Python mirror)
          return respond(
              400,
              "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
              "\"Failure\",\"message\":\"invalid resourceVersion\","
              "\"reason\":\"BadRequest\",\"code\":400}");
        wrv = atoll(rvs.c_str());
      }
      bool expired = false;
      long long too_large_current = -1;
      {
        std::lock_guard<std::mutex> lk(store.mu);
        if (wrv > 0) {
          if (wrv > store.rv) {
            // a resume AHEAD of the store (server restart reset the
            // revision clock): the real apiserver fails the handshake
            // with 504 "Too large resource version" + retry hint, NOT
            // 410 Expired (Python mirror: _too_large_rv_status). The
            // real watch cache blocks ~3s waiting to catch up first;
            // the mock answers immediately (documented divergence).
            too_large_current = store.rv;
          } else if (wrv < store.compacted_rv || rv_window() <= 0) {
            expired = true;
          } else {
            // replay the gap from the watch cache BEFORE registering:
            // commits hold mu too, so ordering is airtight. The replay
            // is exempt from the ring-lag cap (bounded by rv_window).
            for (const auto& h : store.history) {
              if (h.rv <= wrv || h.kind != m.kind) continue;
              if (!match_field_selector(h.e->obj, fs)) continue;
              if (!w->label_sel.matches(h.e->obj)) continue;
              w->replay.push_back(Store::event_line(h.type.c_str(), h.e));
            }
          }
        }
        if (!expired && too_large_current < 0) {
          // cursor starts at the ring head, atomically with the replay
          // collection: commits append under mu -> ring_mu, so holding
          // BOTH here means nothing falls between the cache gap and live
          std::lock_guard<std::mutex> rl(store.ring_mu);
          w->cursor = store.ring_next;
          w->created_unix = wall_unix_s();
          w->replay_pending.store((long)w->replay.size(),
                                  std::memory_order_relaxed);
          store.watches.push_back(w);
          store.kind_watchers[m.kind]++;
        }
      }
      if (too_large_current >= 0) {
        return respond(
            504,
            "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
            "\"Failure\",\"message\":\"Too large resource version: " +
                std::to_string(wrv) + ", current: " +
                std::to_string(too_large_current) +
                "\",\"reason\":\"Timeout\",\"details\":{\"causes\":[{"
                "\"reason\":\"ResourceVersionTooLarge\",\"message\":"
                "\"Too large resource version\"}],\"retryAfterSeconds\":1},"
                "\"code\":504}");
      }
      if (expired) {
        // the real apiserver answers an expired watch resume with 200 +
        // one ERROR event carrying a 410 Status, then closes the stream
        audit_line(req.method, uri, 200);
        std::string ev =
            "{\"type\":\"ERROR\",\"object\":{\"kind\":\"Status\","
            "\"apiVersion\":\"v1\",\"status\":\"Failure\","
            "\"message\":\"too old resource version: " +
            std::to_string(wrv) +
            "\",\"reason\":\"Expired\",\"code\":410}}\n";
        std::string head =
            "HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            "Content-Length: " +
            std::to_string(ev.size()) + "\r\nConnection: close\r\n\r\n";
        head += ev;
        send_all(fd, head.data(), head.size());
        return false;
      }
      audit_line(req.method, uri, 200);
      const char* head =
          "HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
          "Transfer-Encoding: chunked\r\n\r\n";
      bool alive = send_all(fd, head, strlen(head));
      std::string out;
      auto frame = [&out](const std::string& ev) {
        char chunk_head[32];
        int hn = snprintf(chunk_head, sizeof chunk_head, "%zx\r\n",
                          ev.size());
        out.append(chunk_head, hn);
        out += ev;
        out += "\r\n";
      };
      // cap-exempt resume replay first (private to this watch; bounded
      // by rv_window), in bounded sends
      {
        size_t i = 0;
        while (alive && i < w->replay.size()) {
          out.clear();
          size_t take_bytes = 0;
          for (; i < w->replay.size() && take_bytes < (4u << 20); i++) {
            take_bytes += w->replay[i]->size();
            frame(*w->replay[i]);
          }
          alive = send_all(fd, out.data(), out.size());
        }
        w->replay.clear();
        w->replay_pending.store(0, std::memory_order_relaxed);
      }
      // Ring reader: drain everything pending per wakeup (bounded per
      // write) and ship it as one send. The store encoded each event
      // ONCE; this thread only filters and frames shared bytes — the
      // per-watcher cost left the commit path (ISSUE 13).
      std::vector<std::shared_ptr<const std::string>> evs;
      auto wdeadline =
          std::chrono::steady_clock::now() +
          std::chrono::duration_cast<std::chrono::steady_clock::duration>(
              std::chrono::duration<double>(timeout_s > 0 ? timeout_s : 0));
      bool deadline_expired = false;
      while (alive && !stopping.load()) {
        bool end_stream = false;
        evs.clear();
        {
          std::unique_lock<std::mutex> lk(store.ring_mu);
          auto ready = [&] {
            return w->closed || store.ring_next > w->cursor ||
                   stopping.load();
          };
          if (timeout_s > 0) {
            if (!store.ring_cv.wait_until(lk, wdeadline, ready)) {
              deadline_expired = true;
              break;
            }
            // the deadline closes at the next event BOUNDARY past it,
            // pending backlog or not (a flooding stream must not be
            // able to outrun its own timeoutSeconds)
            if (std::chrono::steady_clock::now() >= wdeadline) {
              deadline_expired = true;
              break;
            }
          } else {
            store.ring_cv.wait(lk, ready);
          }
          uint64_t base = store.ring_next - store.ring.size();
          if (w->cursor < base) w->cursor = base;  // trimmed past us
          uint64_t lim = store.ring_next;
          if (w->stop_seq < lim) lim = w->stop_seq;
          size_t take_bytes = 0;
          // cap the batch by BYTES, not events: one send buffer must
          // stay bounded even when large objects piled up
          while (w->cursor < lim && take_bytes < (4u << 20)) {
            const RingEv& ev = store.ring[w->cursor - base];
            w->cursor++;
            if (ev.kind != w->kind) continue;
            if (ev.bookmark) {
              if (!w->bookmarks) continue;
            } else if (!match_field_selector(ev.e->obj, w->field_sel) ||
                       !w->label_sel.matches(ev.e->obj)) {
              continue;
            }
            take_bytes += ev.line->size();
            evs.push_back(ev.line);
          }
          if (evs.empty() && w->closed && w->cursor >= lim)
            end_stream = true;
        }
        if (end_stream) break;  // slow close stays abrupt (backlog dropped)
        if (evs.empty()) continue;  // consumed only non-matching events
        out.clear();
        for (const auto& ev : evs) frame(*ev);
        alive = send_all(fd, out.data(), out.size());
      }
      if (alive && deadline_expired) {
        // timeoutSeconds expiry: END the watch cleanly (terminal chunk)
        // — the client resumes from its last revision. A slow-consumer
        // close stays abrupt (the backlog is already dropped).
        g_watch_term_deadline.fetch_add(1);
        send_all(fd, "0\r\n\r\n", 5);
      }
      {
        std::lock_guard<std::mutex> lk(store.ring_mu);
        store.close_watch_locked(w, /*slow=*/false);
        auto& ws = store.watches;
        ws.erase(std::remove(ws.begin(), ws.end(), w), ws.end());
        store.ring_min = 0;  // force a min-cursor recompute next trim
      }
      store.ring_cv.notify_all();
      return false;  // watch connections never go back to unary
    }
    // ---- list (with the kube-apiserver limit/continue chunking protocol)
    // Snapshot (key, entry) refs under the lock; match + serialize OUTSIDE
    // it. Writers only ever stall for the pointer copy, not for a
    // potentially-hundreds-of-MB response build.
    LabelSel ls = LabelSel::parse(lsq);
    long limit = q.count("limit") ? atol(q["limit"].c_str()) : 0;
    std::string cont = q.count("continue") ? q["continue"] : "";
    // Indexed count for the progress-poll shape (limit=N +
    // fieldSelector=status.phase=X, no label selector): the post-cut
    // remainder comes from phase_idx instead of matching every stored
    // object. -1 = no index applies; the slow scan is authoritative.
    // Resolved inside the snapshot's lock so count and snapshot agree.
    long idx_total = -1;
    std::string idx_phase;  // the selector's phase value when eligible
    bool idx_eligible = false;
    if (limit > 0 && cont.empty() && lsq.empty() &&
        fs.rfind("status.phase=", 0) == 0 && fs.find(',') == std::string::npos &&
        fs.find("!=") == std::string::npos) {
      idx_phase = fs.substr(13);
      if (!idx_phase.empty() && idx_phase[0] == '=')
        idx_phase.erase(0, 1);  // the '==' dialect match_field_selector takes
      // any further '=' or whitespace means a dialect the exact-key index
      // cannot answer — leave it to the authoritative scan
      idx_eligible = !idx_phase.empty() &&
                     idx_phase.find_first_of("= \t") == std::string::npos;
    }
    // Continuation pages snapshot a BOUNDED slice (each page must be O(page)
    // lock work, or a full paginated re-list at 1M objects goes quadratic in
    // pointer copies); a short page with a continue token is protocol-legal,
    // so heavy selector filtering just yields more, cheaper pages. First
    // pages (which report remainingItemCount) snapshot everything.
    bool count_rest = cont.empty();
    size_t snap_cap = count_rest
                          ? (size_t)-1
                          : (size_t)std::max(limit * 4L, 4096L);
    int64_t rv_now = 0;
    int64_t token_rv = 0;  // consistency marker: rv of the FIRST page
    Key last{"", ""};
    bool have_last = false;
    if (!cont.empty()) {
      // opaque url-safe token (like the real apiserver's base64
      // continue): rv \0 ns \0 name — resumes strictly after the key;
      // the rv is the first page's revision and expires on compaction
      std::string raw;
      size_t p1;
      if (!b64url_decode(cont, raw) ||
          (p1 = raw.find('\0')) == std::string::npos || p1 == 0 ||
          raw.find_first_not_of("0123456789") < p1)
        // undecodable token OR a non-numeric rv segment: 400, like the
        // real apiserver's "continue key is not valid" (and the Python
        // mirror's MalformedContinue)
        return respond(
            400,
            "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
            "\"Failure\",\"message\":\"continue key is not valid\","
            "\"reason\":\"BadRequest\",\"code\":400}");
      token_rv = atoll(raw.substr(0, p1).c_str());
      std::string rest = raw.substr(p1 + 1);
      size_t nul = rest.find('\0');
      last = Key{rest.substr(0, nul),
                 nul == std::string::npos ? "" : rest.substr(nul + 1)};
      have_last = true;
    }
    // EVERY page — first or continuation — serves a CONSISTENT SNAPSHOT
    // at one revision (what the real apiserver reads from etcd MVCC):
    // the sharded store is walked shard by shard (shard locks never
    // nest) and rolled back through the undo log to the list revision,
    // so a write racing the walk on another shard can neither leak in
    // nor hide. Newest-to-oldest overlay walk, so the final value for a
    // key is the prev of its EARLIEST post-revision event — exactly its
    // state at the list revision (nullptr = absent then). rv_window()==0
    // disables the cache and keeps the live-view behavior.
    std::vector<std::pair<Key, EntryPtr>> snap;
    bool more_after = false;
    std::map<Key, EntryPtr> overlay;
    for (int attempt = 0; attempt < 4; attempt++) {
      {
        std::lock_guard<std::mutex> lk(store.mu);
        if (have_last) {
          if (token_rv < store.compacted_rv)
            return respond(
                410,
                "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
                "\"Failure\",\"message\":\"the provided continue parameter "
                "is too old\",\"reason\":\"Expired\",\"code\":410}");
          rv_now = token_rv;  // pages of one list share page 1's revision
        } else {
          rv_now = store.rv;
          token_rv = rv_now;  // first page stamps its revision
          if (idx_eligible) {
            auto pit = store.phase_idx[m.kind].find(idx_phase);
            idx_total =
                pit == store.phase_idx[m.kind].end() ? 0 : pit->second;
          } else if (limit > 0 && lsq.empty() && fs.empty()) {
            // selector-less count (limit=1 population polls): every
            // stored entry matches, so the population count IS the total
            // (kept under mu with rv, so count and revision agree)
            idx_total = store.obj_count[m.kind];
          }
        }
      }
      snap.clear();
      more_after = false;
      for (auto& ns_sh : store.kind_shards(m.kind)) {
        if (have_last && ns_sh.first < last.first) continue;
        std::lock_guard<std::mutex> sl(ns_sh.second->smu);
        auto it = ns_sh.second->objs.begin();
        if (have_last && ns_sh.first == last.first)
          it = ns_sh.second->objs.upper_bound(last.second);
        for (; it != ns_sh.second->objs.end(); ++it) {
          if (snap.size() >= snap_cap) {
            more_after = true;
            break;
          }
          snap.emplace_back(Key{ns_sh.first, it->first}, it->second);
        }
        if (more_after) break;
      }
      {
        std::lock_guard<std::mutex> lk(store.mu);
        if (rv_window() > 0 && rv_now < store.compacted_rv) {
          if (have_last)
            return respond(
                410,
                "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
                "\"Failure\",\"message\":\"the provided continue "
                "parameter is too old\",\"reason\":\"Expired\","
                "\"code\":410}");
          if (attempt < 3) continue;  // compaction raced the walk: retry
          overlay.clear();  // repeated compactions: serve the live walk
          break;
        }
        overlay.clear();
        for (auto u = store.undo.rbegin(); u != store.undo.rend(); ++u) {
          if (u->rv <= rv_now) break;
          if (u->kind != m.kind) continue;
          if (have_last && !(last < u->key)) continue;
          overlay[u->key] = u->prev;
        }
      }
      break;
    }
    // a truncated walk must not let overlay keys past the cut fabricate
    // out-of-order entries — the continuation resumes there instead
    if (more_after && !snap.empty()) {
      Key cut = snap.back().first;
      while (!overlay.empty() && cut < overlay.rbegin()->first)
        overlay.erase(std::prev(overlay.end()));
    }
    // merged view: walk snapshot + rollback overlay (both key-sorted);
    // the overlay's state wins where both hold a key
    std::vector<EntryPtr> view;
    {
      auto sit = snap.begin();
      auto ov = overlay.begin();
      while (sit != snap.end() || ov != overlay.end()) {
        bool use_ov;
        if (ov == overlay.end()) use_ov = false;
        else if (sit == snap.end()) use_ov = true;
        else if (ov->first < sit->first) use_ov = true;
        else if (sit->first < ov->first) use_ov = false;
        else {  // same key: the rolled-back state wins over the live one
          use_ov = true;
          ++sit;
        }
        EntryPtr e;
        if (use_ov) {
          e = ov->second;
          ++ov;
        } else {
          e = sit->second;
          ++sit;
        }
        if (!e) continue;  // hidden at the view revision (created later)
        if (view.size() >= snap_cap) {
          // only a VISIBLE leftover earns a continue token: keys hidden
          // by the snapshot must not fabricate a trailing empty page
          more_after = true;
          break;
        }
        view.push_back(std::move(e));
      }
    }
    pt.mark(PH_COMMIT);  // snapshot under the locks; match/serialize below
                         // is response build, attributed to encode
    // The continue token is rebuilt from the entry's own (immutable)
    // metadata — map keys may be erased concurrently once the lock drops.
    auto key_of = [token_rv](const JVal& obj, std::string& out) {
      const JVal* meta = obj.find("metadata");
      const JVal* ns = meta ? meta->find("namespace") : nullptr;
      const JVal* name = meta ? meta->find("name") : nullptr;
      std::string raw = std::to_string(token_rv);
      raw += '\0';
      if (ns && ns->type == JVal::STR) raw += ns->s;
      raw += '\0';
      if (name && name->type == JVal::STR) raw += name->s;
      out = b64url_encode(raw);
    };
    // Continuation pages break at the cut (counting the remainder on every
    // page would make a full re-list quadratic); only the FIRST page scans
    // on for ListMeta.remainingItemCount, which is what limit=1 count
    // pollers read.
    std::string items;
    std::string token;
    long count = 0;
    long remaining = 0;
    bool first = true;
    for (size_t i = 0; i < view.size(); i++) {
      const JVal& obj = view[i]->obj;
      // the index knows no further entry can match: stop scanning (a
      // zero-match poll — e.g. phase=Running before any transition —
      // would otherwise walk the whole store)
      if (idx_total >= 0 && count >= idx_total) break;
      if (limit && count >= limit) {
        if (!count_rest) break;  // continuation pages stop at the cut
        if (idx_total >= 0) {
          // indexed remainder: total matches minus those already emitted
          remaining = std::max(0L, idx_total - count);
          break;
        }
        if (!match_field_selector(obj, fs)) continue;
        if (!ls.matches(obj)) continue;
        remaining++;
        continue;
      }
      if (!match_field_selector(obj, fs)) continue;
      if (!ls.matches(obj)) continue;
      if (!first) items += ',';
      first = false;
      items += view[i]->bytes;
      count++;
      if (limit && count >= limit && (i + 1 < view.size() || more_after))
        key_of(obj, token);
    }
    if (limit && !count_rest && token.empty() && more_after && !view.empty())
      // truncated snapshot, page not filled: continue from the last entry
      // we actually examined (a short page; the client keeps paginating)
      key_of(view.back()->obj, token);
    std::string body =
        "{\"kind\":\"List\",\"apiVersion\":\"v1\",\"metadata\":{"
        "\"resourceVersion\":\"";
    body += std::to_string(rv_now);
    body += '"';
    // first pages gate the token on a known matching remainder; later
    // pages emit it whenever entries remain (an empty final page is fine)
    if (!token.empty() && (count_rest ? remaining > 0 : true)) {
      body += ",\"continue\":\"";
      json_escape(body, token);
      body += '"';
    }
    if (limit && count_rest && remaining > 0) {
      // ListMeta.remainingItemCount: lets pollers count a population with
      // limit=1 instead of transferring the whole serialized list
      body += ",\"remainingItemCount\":";
      body += std::to_string(remaining);
    }
    body += "},\"items\":[";
    body += items;
    body += "]}";
    return respond(200, body);
  }

  if (req.method == "POST" && m.binding) {
    // the real scheduler's bind: POST v1 Binding -> set spec.nodeName once
    JParser p(req.body);
    JVal b = p.parse();
    pt.mark(PH_PARSE);
    if (p.ok) pt.parsed = true;
    const JVal* target = b.is_obj() ? b.find("target") : nullptr;
    const JVal* tname =
        target && target->is_obj() ? target->find("name") : nullptr;
    std::string node = tname && tname->type == JVal::STR ? tname->s : "";
    std::string conflict;
    bool found = false;
    bool fenced = false;
    bool committed = false;
    {
      std::unique_lock<std::mutex> fence_lk;
      if (!fence_check(fence_lk)) {
        fenced = true;  // check+commit atomic: respond after the locks
      } else {
        ShardPtr sh = store.shard_of(1, m.ns, /*create=*/false);
        if (sh) {
          std::lock_guard<std::mutex> sl(sh->smu);
          auto it = sh->objs.find(m.name);
          if (it != sh->objs.end()) {
            found = true;
            JVal obj = it->second->obj;  // copy-on-write
            JVal& spec = obj.get_or_insert_obj("spec");
            const JVal* cur = spec.find("nodeName");
            if (cur && cur->type == JVal::STR && !cur->s.empty()) {
              // real apiserver BindingREST: any bind after spec.nodeName
              // is set conflicts, even to the same node
              conflict = cur->s;
            } else {
              spec.set("nodeName", JVal::str(node));
              EntryPtr prev = it->second;
              std::lock_guard<std::mutex> lk(store.mu);
              it->second = store.commit_locked(
                  1, "MODIFIED", std::move(obj), key, std::move(prev),
                  pt.on ? &pt.us[PH_FANOUT] : nullptr, sh.get());
              committed = true;
            }
          }
        }
      }
    }
    wake_ring = committed;
    pt.mark(PH_COMMIT);
    if (fenced) return fencing_409();
    if (!found) return respond(404, "{\"kind\":\"Status\",\"code\":404}");
    if (!conflict.empty()) {
      std::string body =
          "{\"kind\":\"Status\",\"status\":\"Failure\",\"reason\":"
          "\"Conflict\",\"message\":\"pod ";
      json_escape(body, m.name);
      body += " is already assigned to node ";
      json_escape(body, conflict);
      body += "\",\"code\":409}";
      return respond(409, body);
    }
    return respond(
        201, "{\"kind\":\"Status\",\"status\":\"Success\",\"code\":201}");
  }

  if (req.method == "POST") {
    if (!m.name.empty() || m.status)
      return respond(404, "{\"kind\":\"Status\",\"code\":404}");
    JParser p(req.body);
    JVal obj = p.parse();
    pt.mark(PH_PARSE);
    if (p.ok) pt.parsed = true;
    if (!p.ok || obj.type != JVal::OBJ)
      return respond(400, "{\"kind\":\"Status\",\"code\":400}");
    JVal& meta = obj.get_or_insert_obj("metadata");
    if (!m.ns.empty()) meta.set("namespace", JVal::str(m.ns));
    EntryPtr e;
    std::string exists_name;
    bool fenced = false;
    bool committed = false;
    {
      std::unique_lock<std::mutex> fence_lk;
      if (!fence_check(fence_lk)) {
        // check+commit atomic: fenced requests skip the whole mutation
        // and answer after the locks drop
        fenced = true;
      } else {
        ShardPtr sh = store.shard_of(m.kind, m.ns);
        std::lock_guard<std::mutex> sl(sh->smu);
        if (!meta.find("name")) {
          // apiserver names.go semantics: generateName + 5-char random
          // suffix (kube-scheduler POSTs events this way). Resolved
          // inside the shard's critical section — the name stays unique
          // through the insert, never silently overwriting an existing
          // object (the real apiserver 409s and the client retries).
          const JVal* gn = meta.find("generateName");
          if (gn && gn->type == JVal::STR && !gn->s.empty()) {
            static const char hexd[] = "0123456789abcdef";
            static std::atomic<uint64_t> ctr{0};
            while (true) {
              uint64_t x = (uint64_t)time(nullptr) * 1000003u +
                           ctr.fetch_add(1) * 2654435761u;
              std::string suffix;
              for (int i = 0; i < 5; i++) {
                suffix += hexd[x & 15];
                x >>= 4;
              }
              std::string name = gn->s + suffix;
              if (!sh->objs.count(name)) {
                meta.set("name", JVal::str(name));
                break;
              }
            }
          }
        }
        Key k = Store::obj_key(obj);
        if (k.second.empty()) {
          e = nullptr;
        } else if (sh->objs.count(k.second)) {
          // the real apiserver never overwrites on create (HTTP 409;
          // mirrors mockserver.py AlreadyExists). Respond AFTER the
          // locks drop (a stalled client must not wedge the store).
          exists_name = k.second;
          e = nullptr;
        } else {
          if (!meta.find("creationTimestamp"))
            meta.set("creationTimestamp", JVal::str(now_rfc3339()));
          std::lock_guard<std::mutex> lk(store.mu);
          e = store.commit_locked(m.kind, "ADDED", std::move(obj), k,
                                  nullptr,
                                  pt.on ? &pt.us[PH_FANOUT] : nullptr,
                                  sh.get(), /*stamp_uid=*/true);
          sh->objs[k.second] = e;
          committed = true;
        }
      }
    }
    wake_ring = committed;
    if (committed && m.kind == kind_index("events"))
      evict_events(pt.on ? &pt.us[PH_FANOUT] : nullptr);
    pt.mark(PH_COMMIT);
    if (fenced) return fencing_409();
    if (!exists_name.empty()) {
      std::string body =
          "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
          "\"Failure\",\"message\":\"";
      json_escape(body, KIND_NAMES[m.kind]);
      body += " \\\"";
      json_escape(body, exists_name);
      body +=
          "\\\" already exists\",\"reason\":\"AlreadyExists\","
          "\"code\":409}";
      return respond(409, body);
    }
    if (!e) return respond(400, "{\"kind\":\"Status\",\"code\":400}");
    return respond(201, e->bytes);
  }

  if (req.method == "PATCH") {
    JParser p(req.body);
    JVal patch = p.parse();
    pt.mark(PH_PARSE);
    if (p.ok) pt.parsed = true;
    if (!p.ok) return respond(400, "{\"kind\":\"Status\",\"code\":400}");
    std::string body;
    int code = 200;
    bool fenced = false;
    bool committed = false;
    {
      std::unique_lock<std::mutex> fence_lk;
      if (!fence_check(fence_lk)) {
        fenced = true;  // check+commit atomic: respond after the locks
      } else {
        ShardPtr sh = store.shard_of(m.kind, m.ns, /*create=*/false);
        bool found = false;
        if (sh) {
          std::lock_guard<std::mutex> sl(sh->smu);
          auto it = sh->objs.find(m.name);
          if (it != sh->objs.end()) {
            found = true;
            JVal obj = it->second->obj;  // copy-on-write
            if (m.status) {
              // strategic-merge on the status subresource; accept
              // either a {"status": {...}} wrapper or a bare status
              // document
              const JVal* sp =
                  patch.is_obj() ? patch.find("status") : nullptr;
              const JVal& spv = sp ? *sp : patch;
              JVal cur_status;
              cur_status.type = JVal::OBJ;
              if (const JVal* cs = obj.find("status"))
                if (cs->type == JVal::OBJ) cur_status = *cs;
              obj.set("status", merge_value(cur_status, spv, ""));
            } else {
              // merge-patch on metadata + spec with null deletion;
              // top-level key replace within each section
              // (mockserver.patch_meta)
              for (const char* section : {"metadata", "spec"}) {
                const JVal* sec_patch =
                    patch.is_obj() ? patch.find(section) : nullptr;
                if (!sec_patch || sec_patch->type != JVal::OBJ ||
                    sec_patch->obj.empty())
                  continue;
                JVal& sec = obj.get_or_insert_obj(section);
                for (const auto& kv : sec_patch->obj) {
                  if (kv.second.type == JVal::NUL) sec.erase(kv.first);
                  else sec.set(kv.first, kv.second);
                }
              }
            }
            EntryPtr prev = it->second;
            std::lock_guard<std::mutex> lk(store.mu);
            EntryPtr e = store.commit_locked(
                m.kind, "MODIFIED", std::move(obj), key, std::move(prev),
                pt.on ? &pt.us[PH_FANOUT] : nullptr, sh.get());
            it->second = e;
            body = e->bytes;
            committed = true;
          }
        }
        if (!found) {
          code = 404;
          body = "{\"kind\":\"Status\",\"code\":404}";
        }
      }
    }
    wake_ring = committed;
    pt.mark(PH_COMMIT);
    if (fenced) return fencing_409();
    return respond(code, body);
  }

  if (req.method == "DELETE") {
    long grace = 0;
    bool grace_given = false;
    if (!req.body.empty()) {
      JParser p(req.body);
      JVal b = p.parse();
      pt.mark(PH_PARSE);
      if (p.ok) pt.parsed = true;
      const JVal* g = b.is_obj() ? b.find("gracePeriodSeconds") : nullptr;
      if (g && g->type == JVal::NUM) {
        grace = atol(g->s.c_str());
        grace_given = true;
      }
    }
    bool fenced = false;
    bool committed = false;
    {
      std::unique_lock<std::mutex> fence_lk;
      if (!fence_check(fence_lk)) {
        fenced = true;  // check+commit atomic: respond after the locks
      } else {
        ShardPtr sh = store.shard_of(m.kind, m.ns, /*create=*/false);
        if (sh) {
          std::lock_guard<std::mutex> sl(sh->smu);
          auto it = sh->objs.find(m.name);
          if (it != sh->objs.end()) {
            JVal obj = it->second->obj;  // copy-on-write
            if (!grace_given && m.kind == 1) {
              // DeleteOptions omitted: server default for pods is
              // spec.terminationGracePeriodSeconds or 30 (mirrors
              // mockserver.py FakeKube.delete)
              grace = 30;
              const JVal* spec = obj.find("spec");
              const JVal* tg =
                  spec && spec->is_obj()
                      ? spec->find("terminationGracePeriodSeconds")
                      : nullptr;
              if (tg && tg->type == JVal::NUM) grace = atol(tg->s.c_str());
            }
            JVal& meta = obj.get_or_insert_obj("metadata");
            const JVal* fins = meta.find("finalizers");
            bool has_fins =
                fins && fins->type == JVal::ARR && !fins->arr.empty();
            if (m.kind == 1 && (grace > 0 || has_fins)) {
              // graceful: mark, wait for the kubelet (engine) to
              // force-delete
              if (!meta.find("deletionTimestamp"))
                meta.set("deletionTimestamp", JVal::str(now_rfc3339()));
              meta.set("deletionGracePeriodSeconds",
                       JVal::num_raw(std::to_string(grace)));
              EntryPtr prev = it->second;
              std::lock_guard<std::mutex> lk(store.mu);
              it->second = store.commit_locked(
                  m.kind, "MODIFIED", std::move(obj), key,
                  std::move(prev), pt.on ? &pt.us[PH_FANOUT] : nullptr,
                  sh.get());
            } else {
              EntryPtr prev = it->second;
              sh->objs.erase(it);
              std::lock_guard<std::mutex> lk(store.mu);
              store.commit_locked(
                  m.kind, "DELETED", std::move(obj), key,
                  std::move(prev), pt.on ? &pt.us[PH_FANOUT] : nullptr,
                  sh.get());
            }
            committed = true;
          }
        }
      }
    }
    wake_ring = committed;
    pt.mark(PH_COMMIT);
    if (fenced) return fencing_409();
    return respond(200, "{\"kind\":\"Status\",\"status\":\"Success\"}");
  }

  return respond(404, "{\"kind\":\"Status\",\"code\":404}");
}

// One request's timing close-out for the batched write path (mutating
// verbs only — never a watch shape). A batched item's phases are its
// OWN work slices (pt.last is re-baselined between the transaction's
// phases), so its "total" is the sum of those slices — the request's
// server-side processing time, excluding the queueing behind its
// batch-mates, exactly as the unary pipelined path excludes the
// queueing behind earlier requests by stamping t_start at pick-up.
static void finish_write_timing(const Request& req, PhaseTimer& pt,
                                int code, const std::string& uri) {
  if (!req.t_start) return;
  pt.mark(PH_ENCODE);
  uint64_t t0 = req.t_start;
  uint64_t t_hdr = req.t_hdr ? req.t_hdr : t0;
  uint64_t t_body = req.t_body ? req.t_body : t_hdr;
  pt.us[PH_READ_HEADERS] = (double)(t_hdr - t0) / 1000.0;
  pt.us[PH_READ_BODY] = (double)(t_body - t_hdr) / 1000.0;
  double total_us = pt.us[PH_READ_HEADERS] + pt.us[PH_READ_BODY] +
                    pt.us[PH_PARSE] + pt.us[PH_COMMIT] + pt.us[PH_ENCODE];
  uint64_t t_end = t0 + (uint64_t)(total_us * 1000.0);
  g_phase_hist[PH_READ_HEADERS].observe_ns(t_hdr - t0);
  g_phase_hist[PH_READ_BODY].observe_ns(t_body - t_hdr);
  g_phase_hist[PH_COMMIT].observe_ns((uint64_t)(pt.us[PH_COMMIT] * 1000.0));
  g_phase_hist[PH_ENCODE].observe_ns((uint64_t)(pt.us[PH_ENCODE] * 1000.0));
  if (pt.parsed)
    g_phase_hist[PH_PARSE].observe_ns((uint64_t)(pt.us[PH_PARSE] * 1000.0));
  if (pt.us[PH_FANOUT] > 0)
    g_phase_hist[PH_FANOUT].observe_ns(
        (uint64_t)(pt.us[PH_FANOUT] * 1000.0));
  int vi = 5;
  if (req.method == "POST") vi = 2;
  else if (req.method == "PATCH") vi = 3;
  else if (req.method == "DELETE") vi = 4;
  g_verb_hist[vi].observe_ns(t_end - t0);
  FlightRec rec;
  rec.method = req.method;
  rec.path = uri;
  rec.status = code;
  rec.band = "mutating";  // batchable shapes are all mutating verbs
  rec.ts_unix = wall_unix_s() - total_us / 1e6;
  rec.total_us = total_us;
  for (int p = 0; p < N_PHASES; p++) rec.phases_us[p] = pt.us[p];
  flight_record(std::move(rec));
}

// Applies ONE batchable write with the owning shard's smu AND store.mu
// held by the caller (the batched transaction holds them once per
// consecutive same-shard run). Mirrors handle_request's unary verbs —
// the batched-write parity twin pins the rv sequence and response bytes
// against the Python server, which processes the same pipelined batch
// request-by-request. Returns whether an event committed.
static bool apply_write_locked(Store& store, Shard& sh, const PathMatch& m,
                               const Request& req, JVal& body,
                               bool parse_ok, PhaseTimer& pt, int* code,
                               std::string* resp, bool* need_evict) {
  double* fan = pt.on ? &pt.us[PH_FANOUT] : nullptr;
  Key key{m.ns, m.name};
  if (req.method == "POST" && m.binding) {
    const JVal* target = body.is_obj() ? body.find("target") : nullptr;
    const JVal* tname =
        target && target->is_obj() ? target->find("name") : nullptr;
    std::string node = tname && tname->type == JVal::STR ? tname->s : "";
    auto it = sh.objs.find(m.name);
    if (it == sh.objs.end()) {
      *code = 404;
      *resp = "{\"kind\":\"Status\",\"code\":404}";
      return false;
    }
    JVal obj = it->second->obj;  // copy-on-write
    JVal& spec = obj.get_or_insert_obj("spec");
    const JVal* cur = spec.find("nodeName");
    if (cur && cur->type == JVal::STR && !cur->s.empty()) {
      *code = 409;
      std::string b =
          "{\"kind\":\"Status\",\"status\":\"Failure\",\"reason\":"
          "\"Conflict\",\"message\":\"pod ";
      json_escape(b, m.name);
      b += " is already assigned to node ";
      json_escape(b, cur->s);
      b += "\",\"code\":409}";
      *resp = std::move(b);
      return false;
    }
    spec.set("nodeName", JVal::str(node));
    EntryPtr prev = it->second;
    it->second = store.commit_locked(1, "MODIFIED", std::move(obj), key,
                                     std::move(prev), fan, &sh);
    *code = 201;
    *resp = "{\"kind\":\"Status\",\"status\":\"Success\",\"code\":201}";
    return true;
  }
  if (req.method == "POST") {
    if (!parse_ok || body.type != JVal::OBJ) {
      *code = 400;
      *resp = "{\"kind\":\"Status\",\"code\":400}";
      return false;
    }
    JVal obj = std::move(body);
    JVal& meta = obj.get_or_insert_obj("metadata");
    if (!m.ns.empty()) meta.set("namespace", JVal::str(m.ns));
    if (!meta.find("name")) {
      const JVal* gn = meta.find("generateName");
      if (gn && gn->type == JVal::STR && !gn->s.empty()) {
        static const char hexd[] = "0123456789abcdef";
        static std::atomic<uint64_t> ctr{0};
        while (true) {
          uint64_t x = (uint64_t)time(nullptr) * 1000003u +
                       ctr.fetch_add(1) * 2654435761u;
          std::string suffix;
          for (int i = 0; i < 5; i++) {
            suffix += hexd[x & 15];
            x >>= 4;
          }
          std::string name = gn->s + suffix;
          if (!sh.objs.count(name)) {
            meta.set("name", JVal::str(name));
            break;
          }
        }
      }
    }
    Key k = Store::obj_key(obj);
    if (k.second.empty()) {
      *code = 400;
      *resp = "{\"kind\":\"Status\",\"code\":400}";
      return false;
    }
    if (sh.objs.count(k.second)) {
      *code = 409;
      std::string b =
          "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
          "\"Failure\",\"message\":\"";
      json_escape(b, KIND_NAMES[m.kind]);
      b += " \\\"";
      json_escape(b, k.second);
      b += "\\\" already exists\",\"reason\":\"AlreadyExists\","
           "\"code\":409}";
      *resp = std::move(b);
      return false;
    }
    if (!meta.find("creationTimestamp"))
      meta.set("creationTimestamp", JVal::str(now_rfc3339()));
    EntryPtr e = store.commit_locked(m.kind, "ADDED", std::move(obj), k,
                                     nullptr, fan, &sh,
                                     /*stamp_uid=*/true);
    sh.objs[k.second] = e;
    *code = 201;
    *resp = e->bytes;
    if (m.kind == kind_index("events")) *need_evict = true;
    return true;
  }
  if (req.method == "PATCH") {
    if (!parse_ok) {
      *code = 400;
      *resp = "{\"kind\":\"Status\",\"code\":400}";
      return false;
    }
    auto it = sh.objs.find(m.name);
    if (it == sh.objs.end()) {
      *code = 404;
      *resp = "{\"kind\":\"Status\",\"code\":404}";
      return false;
    }
    JVal obj = it->second->obj;  // copy-on-write
    if (m.status) {
      const JVal* sp = body.is_obj() ? body.find("status") : nullptr;
      const JVal& spv = sp ? *sp : body;
      JVal cur_status;
      cur_status.type = JVal::OBJ;
      if (const JVal* cs = obj.find("status"))
        if (cs->type == JVal::OBJ) cur_status = *cs;
      obj.set("status", merge_value(cur_status, spv, ""));
    } else {
      for (const char* section : {"metadata", "spec"}) {
        const JVal* sec_patch =
            body.is_obj() ? body.find(section) : nullptr;
        if (!sec_patch || sec_patch->type != JVal::OBJ ||
            sec_patch->obj.empty())
          continue;
        JVal& sec = obj.get_or_insert_obj(section);
        for (const auto& kv : sec_patch->obj) {
          if (kv.second.type == JVal::NUL) sec.erase(kv.first);
          else sec.set(kv.first, kv.second);
        }
      }
    }
    EntryPtr prev = it->second;
    EntryPtr e = store.commit_locked(m.kind, "MODIFIED", std::move(obj),
                                     key, std::move(prev), fan, &sh);
    it->second = e;
    *code = 200;
    *resp = e->bytes;
    return true;
  }
  // DELETE
  long grace = 0;
  bool grace_given = false;
  const JVal* g = body.is_obj() ? body.find("gracePeriodSeconds") : nullptr;
  if (g && g->type == JVal::NUM) {
    grace = atol(g->s.c_str());
    grace_given = true;
  }
  bool committed = false;
  auto it = sh.objs.find(m.name);
  if (it != sh.objs.end()) {
    JVal obj = it->second->obj;  // copy-on-write
    if (!grace_given && m.kind == 1) {
      grace = 30;
      const JVal* spec = obj.find("spec");
      const JVal* tg = spec && spec->is_obj()
                           ? spec->find("terminationGracePeriodSeconds")
                           : nullptr;
      if (tg && tg->type == JVal::NUM) grace = atol(tg->s.c_str());
    }
    JVal& meta = obj.get_or_insert_obj("metadata");
    const JVal* fins = meta.find("finalizers");
    bool has_fins = fins && fins->type == JVal::ARR && !fins->arr.empty();
    if (m.kind == 1 && (grace > 0 || has_fins)) {
      if (!meta.find("deletionTimestamp"))
        meta.set("deletionTimestamp", JVal::str(now_rfc3339()));
      meta.set("deletionGracePeriodSeconds",
               JVal::num_raw(std::to_string(grace)));
      EntryPtr prev = it->second;
      it->second = store.commit_locked(m.kind, "MODIFIED", std::move(obj),
                                       key, std::move(prev), fan, &sh);
    } else {
      EntryPtr prev = it->second;
      sh.objs.erase(it);
      store.commit_locked(m.kind, "DELETED", std::move(obj), key,
                          std::move(prev), fan, &sh);
    }
    committed = true;
  }
  *code = 200;
  *resp = "{\"kind\":\"Status\",\"status\":\"Success\"}";
  return committed;
}

// The batched write transaction (ISSUE 13): N creates/binds/status-
// patches that arrived in one socket read (the native pump pipelines
// whole frames) execute as consecutive same-shard runs, each under ONE
// shard-lock + ONE clock-lock hold, with ONE rv allocation run, one
// ring append per event and a single watcher wake for the whole batch —
// instead of N lock/notify round-trips. Admission still answers 429 per
// request; responses/audit/timing are per request, in arrival order.
size_t App::exec_write_batch(ConnIO& io, std::vector<Request>& batch) {
  struct Item {
    PathMatch m;
    JVal body;
    bool parse_ok = false;
    PhaseTimer pt;
    int code = 0;
    std::string resp;
    bool unauthorized = false;
    bool rejected = false;  // admission 429
    bool need_evict = false;
  };
  std::vector<Item> items(batch.size());
  // phase 1: auth + body parse, no locks (admission is taken per item
  // in phase 2 — one slot at a time, like the sequential unary path)
  for (size_t i = 0; i < batch.size(); i++) {
    Request& rq = batch[i];
    Item& it = items[i];
    it.m = match_path(rq.path);
    if (rq.t_start) {
      it.pt.on = true;
      it.pt.last = rq.t_body ? rq.t_body : now_ns();
    }
    if (!auth_tokens.empty() &&
        (rq.auth.rfind("Bearer ", 0) != 0 ||
         !auth_tokens.count(rq.auth.substr(7)))) {
      it.unauthorized = true;
      it.code = 401;
      it.resp =
          "{\"kind\":\"Status\",\"apiVersion\":\"v1\",\"status\":"
          "\"Failure\",\"reason\":\"Unauthorized\",\"message\":"
          "\"Unauthorized\",\"code\":401}";
      continue;
    }
    if (it.pt.on) it.pt.last = now_ns();  // re-baseline: own parse slice
    JParser p(rq.body);
    it.body = p.parse();
    it.pt.mark(PH_PARSE);
    if (p.ok) {
      it.parse_ok = true;
      it.pt.parsed = true;
    }
  }
  // phase 2: the store transaction — consecutive same-(kind, ns) runs
  // under one shard+clock hold; one ring wake for the whole batch
  bool committed_any = false;
  bool any_evict = false;
  size_t i = 0;
  while (i < batch.size()) {
    if (items[i].unauthorized || items[i].rejected) {
      i++;
      continue;
    }
    size_t j = i + 1;
    while (j < batch.size() && !items[j].unauthorized &&
           !items[j].rejected && items[j].m.kind == items[i].m.kind &&
           items[j].m.ns == items[i].m.ns)
      j++;
    ShardPtr sh = store.shard_of(items[i].m.kind, items[i].m.ns);
    {
      std::lock_guard<std::mutex> sl(sh->smu);
      std::lock_guard<std::mutex> lk(store.mu);
      for (size_t k2 = i; k2 < j; k2++) {
        Item& it = items[k2];
        // admission: one slot held per ITEM, acquired and released in
        // sequence — a connection's own pipelined burst must not
        // self-saturate the mutating band (the unary path, and the
        // Python twin working through the same bytes, only ever hold
        // one slot per connection at a time)
        if (max_inflight_band[1] > 0) {
          if (inflight[1].fetch_add(1) + 1 > max_inflight_band[1]) {
            inflight[1].fetch_sub(1);
            rejected[1].fetch_add(1);
            it.rejected = true;
            it.code = 429;
            it.resp = TOO_MANY_REQUESTS_BODY;
            continue;
          }
        }
        // re-baseline: the commit phase is THIS item's store work, not
        // the wait behind its batch-mates (see finish_write_timing)
        if (it.pt.on) it.pt.last = now_ns();
        if (apply_write_locked(store, *sh, it.m, batch[k2], it.body,
                               it.parse_ok, it.pt, &it.code, &it.resp,
                               &it.need_evict))
          committed_any = true;
        it.pt.mark(PH_COMMIT);
        if (it.need_evict) any_evict = true;
        if (max_inflight_band[1] > 0) inflight[1].fetch_sub(1);
      }
    }
    i = j;
  }
  if (any_evict) evict_events(nullptr);
  // phase 3: responses + audit + timing, in arrival order (the ring
  // wake rides AFTER the whole batch's responses, like the unary path)
  for (size_t k2 = 0; k2 < batch.size(); k2++) {
    Request& rq = batch[k2];
    Item& it = items[k2];
    std::string uri = rq.path;
    if (!rq.query.empty()) uri += "?" + rq.query;
    audit_line(rq.method, uri, it.code);
    if (it.pt.on) it.pt.last = now_ns();  // re-baseline: own encode slice
    queue_response(io, it.code, it.resp,
                   it.code == 429 ? "Retry-After: 1\r\n" : "");
    finish_write_timing(rq, it.pt, it.code, uri);
  }
  if (committed_any) {
    io.flush();  // the batch's answers hit the wire before the herd wakes
    store.ring_cv.notify_all();
  }
  return batch.size();
}

void App::handle_conn(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  ConnIO io;
  io.fd = fd;
  Request req;
  while (!stopping.load() && read_request(io, req)) {
    // batched write transactions (ISSUE 13): when the socket read that
    // carried this request brought MORE complete batchable writes (the
    // native pump pipelines whole frames), absorb the run into one
    // store transaction instead of paying per-request lock/notify
    // round-trips. Anything else — reads, watches, ops paths, fenced
    // writes — takes the unary path unchanged.
    // only a request whose body ALREADY arrived may batch: a slow sender
    // must take the unary path, where the admission slot spans the
    // blocking body read (the 429 saturation contract)
    if (batchable_write(req) &&
        io.in.size() - io.off >= req.content_len) {
      if (!read_body(io, req)) break;
      std::vector<Request> batch;
      batch.push_back(std::move(req));
      Request leftover;
      bool have_leftover = false;
      while (batch.size() < 256) {
        Request nxt;
        if (!peek_buffered_request(io, nxt)) break;
        if (batchable_write(nxt)) {
          batch.push_back(std::move(nxt));
        } else {
          leftover = std::move(nxt);
          have_leftover = true;
          break;
        }
      }
      if (batch.size() == 1 && !have_leftover) {
        // nothing arrived with it: the unary path keeps its exact
        // admission/fencing slot semantics for singletons
        if (!handle_request(io, batch[0])) break;
        continue;
      }
      exec_write_batch(io, batch);
      if (have_leftover && !handle_request(io, leftover)) break;
      continue;
    }
    if (!handle_request(io, req)) break;
  }
  io.flush();  // peer may close after its last response arrives
  close(fd);
}

static void on_term(int) {
  // async-signal-safe only: flag + wake the accept loop (shutdown() on the
  // listening socket makes accept() fail); persistence runs on the main
  // thread where taking the store mutex is legal
  if (g_app) {
    g_app->stopping.store(true);
    if (g_app->listen_fd >= 0) shutdown(g_app->listen_fd, SHUT_RDWR);
  }
}

int main(int argc, char** argv) {
  int port = 0;
  std::string address = "127.0.0.1";
  std::string audit_log, data_file, token_file;
  bool authorization = false;
  // admission limits: flags override the env knobs (mirrors mockserver.py
  // main(); 0/unset = band off)
  const char* env_ro = getenv("KWOK_TPU_MAX_INFLIGHT");
  const char* env_mu = getenv("KWOK_TPU_MAX_MUTATING_INFLIGHT");
  long max_ro = env_ro && *env_ro ? atol(env_ro) : 0;
  long max_mu = env_mu && *env_mu ? atol(env_mu) : 0;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto val = [&](const char* flag) -> const char* {
      size_t n = strlen(flag);
      if (a.rfind(flag, 0) == 0 && a.size() > n && a[n] == '=')
        return a.c_str() + n + 1;
      if (a == flag && i + 1 < argc) return argv[++i];
      return nullptr;
    };
    if (const char* v = val("--port")) port = atoi(v);
    else if (const char* v = val("--address")) address = v;
    else if (const char* v = val("--audit-log")) audit_log = v;
    else if (const char* v = val("--data-file")) data_file = v;
    else if (const char* v = val("--token-auth-file")) token_file = v;
    else if (const char* v = val("--max-inflight")) max_ro = atol(v);
    else if (const char* v = val("--max-mutating-inflight")) max_mu = atol(v);
    else if (a == "--authorization") authorization = true;
    else if (a == "--rig-routes") g_rig_routes = true;
  }

  signal(SIGPIPE, SIG_IGN);

  // Heap-allocated and deliberately LEAKED: detached watch threads wait
  // on the store's shared ring condition variable, and destroying a cv
  // with live waiters (a stack App dying as main returns) is UB that
  // blocks glibc's pthread_cond_destroy — the process would hang on
  // SIGTERM exactly when watchers are attached. exit() reaps the
  // threads; the one App simply never destructs.
  App& app = *new App();
  g_app = &app;
  app.data_file = data_file;
  app.max_inflight_band[0] = max_ro;
  app.max_inflight_band[1] = max_mu;
  if (!audit_log.empty()) {
    app.audit = fopen(audit_log.c_str(), "a");
    if (!app.audit) {
      fprintf(stderr, "cannot open audit log %s\n", audit_log.c_str());
      return 1;
    }
  }
  if (!data_file.empty()) {
    FILE* f = fopen(data_file.c_str(), "r");
    if (f) {
      std::string text;
      char tmp[65536];
      size_t n;
      while ((n = fread(tmp, 1, sizeof tmp, f)) > 0) text.append(tmp, n);
      fclose(f);
      JParser p(text);
      JVal data = p.parse();
      if (p.ok) {
        app.restore_load(data);
        printf("restored store from %s\n", data_file.c_str());
        fflush(stdout);
      }
    }
  }
  if (!token_file.empty()) {
    // kube-apiserver --token-auth-file CSV: token,user,uid[,groups]
    FILE* f = fopen(token_file.c_str(), "r");
    if (!f) {
      fprintf(stderr, "cannot open token file %s\n", token_file.c_str());
      return 1;
    }
    // getline, not a fixed fgets buffer: a row longer than the buffer
    // would be split into chunks and each chunk's prefix registered as a
    // bogus accepted token — an authn loosening, not just a parse bug
    char* lineptr = nullptr;
    size_t linecap = 0;
    while (getline(&lineptr, &linecap, f) != -1) {
      std::string row = lineptr;
      row.erase(row.find_last_not_of(" \t\r\n") + 1);
      size_t comma = row.find(',');
      std::string tok =
          comma == std::string::npos ? row : row.substr(0, comma);
      if (!tok.empty()) app.auth_tokens.insert(tok);
    }
    free(lineptr);
    fclose(f);
    if (app.auth_tokens.empty()) {
      // an unusable token file must fail hard, not degrade to anonymous
      fprintf(stderr, "token file %s has no token\n", token_file.c_str());
      return 1;
    }
  }
  if (authorization) app.seed_rbac();

  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) {
    perror("socket");
    return 1;
  }
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof addr);
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, address.c_str(), &addr.sin_addr) != 1) {
    fprintf(stderr, "bad address %s\n", address.c_str());
    return 1;
  }
  if (bind(lfd, (struct sockaddr*)&addr, sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(lfd, 512) != 0) {
    perror("listen");
    return 1;
  }
  socklen_t alen = sizeof addr;
  getsockname(lfd, (struct sockaddr*)&addr, &alen);
  app.listen_fd = lfd;
  const char* shown =
      (address == "0.0.0.0" || address.empty()) ? "127.0.0.1" : address.c_str();
  printf("mock apiserver listening on http://%s:%d\n", shown,
         ntohs(addr.sin_port));
  fflush(stdout);

  signal(SIGTERM, on_term);
  signal(SIGINT, on_term);

  // BOOKMARK cadence for opted-in watches (mirrors mockserver.py
  // BOOKMARK_INTERVAL; same env override; <= 0 disables). Sleeps in
  // short slices so shutdown stays prompt. Joinable — a detached thread
  // could dereference `app` (a stack local) after main returns.
  std::thread bookmark_thread;
  {
    const char* v = getenv("KWOK_TPU_BOOKMARK_INTERVAL");
    double interval = v && *v ? atof(v) : 60.0;
    if (interval > 0) {
      bookmark_thread = std::thread([&app, interval] {
        double slept = 0;
        while (!app.stopping.load()) {
          std::this_thread::sleep_for(std::chrono::milliseconds(100));
          slept += 0.1;
          if (slept + 1e-9 >= interval) {
            slept = 0;
            app.store.emit_bookmarks();
          }
        }
      });
    }
  }

  while (!app.stopping.load()) {
    int cfd = accept(lfd, nullptr, nullptr);
    if (cfd < 0) {
      if (errno == EINTR && !app.stopping.load()) continue;
      break;
    }
    std::thread(&App::handle_conn, &app, cfd).detach();
  }
  if (bookmark_thread.joinable()) bookmark_thread.join();
  // shutting down terminates watch streams: wake every ring waiter so
  // attached clients see EOF promptly instead of at process teardown
  {
    std::lock_guard<std::mutex> lk(app.store.ring_mu);
    for (auto& w : app.store.watches)
      app.store.close_watch_locked(w, /*slow=*/false);
  }
  app.store.ring_cv.notify_all();
  app.persist();
  return 0;
}
