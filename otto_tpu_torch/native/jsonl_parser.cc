// Native OTTO JSONL ingest.
//
// Replaces the reference's pure-Python event-explode hot loop
// (src/utilities/dataset_writer_pickle.py:49-54 — per-session per-event list
// appends over ~220M events) with a single-pass hand-rolled scanner for the
// fixed OTTO schema:
//   {"session": 123, "events": [{"aid": 4, "ts": 1661724000000, "type": "clicks"}, ...]}
//
// The scanner tolerates arbitrary key order and whitespace but assumes the
// OTTO field set.  Exposed via a C ABI for ctypes.  Copied from the JAX
// package's native/jsonl_parser.cc; built by otto_tpu_torch/data/ingest.py
// into otto_tpu_torch/_build/ at first use.  One change: an empty file
// parses to no events instead of failing.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

struct Parsed {
  std::vector<int64_t> session;
  std::vector<int32_t> aid;
  std::vector<int64_t> ts;
  std::vector<int8_t> type;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

inline const char* parse_int(const char* p, const char* end, int64_t* out) {
  bool neg = false;
  if (p < end && *p == '-') { neg = true; ++p; }
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  *out = neg ? -v : v;
  return p;
}

// Event type encoding shared with the reference
// (dataset_writer_pickle.py:29-33): clicks=0, carts=1, orders=2.
inline int8_t type_code(const char* s, size_t len) {
  if (len >= 2 && s[1] == 'l') return 0;  // clicks
  if (len >= 2 && s[1] == 'a') return 1;  // carts
  return 2;                               // orders
}

void parse_buffer(const char* data, size_t size, Parsed* out) {
  const char* p = data;
  const char* end = data + size;
  while (p < end) {
    // one JSON object per line
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;

    int64_t session = -1;
    // find "session":
    const char* s = static_cast<const char*>(memmem(p, line_end - p, "\"session\"", 9));
    if (s) {
      s += 9;
      s = skip_ws(s, line_end);
      if (s < line_end && *s == ':') ++s;
      s = skip_ws(s, line_end);
      parse_int(s, line_end, &session);
    }
    if (session >= 0) {
      // iterate the events array: each event object contains aid/ts/type
      const char* q = p;
      while (true) {
        const char* ev = static_cast<const char*>(memmem(q, line_end - q, "\"aid\"", 5));
        if (!ev) break;
        // the event object spans from here to its closing brace
        const char* obj_end = static_cast<const char*>(memchr(ev, '}', line_end - ev));
        if (!obj_end) obj_end = line_end;
        // aid
        int64_t aid = -1, ts = -1;
        int8_t ty = 0;
        const char* a = ev + 5;
        a = skip_ws(a, obj_end);
        if (a < obj_end && *a == ':') ++a;
        a = skip_ws(a, obj_end);
        parse_int(a, obj_end, &aid);
        // ts (search within the object, either side of aid)
        const char* obj_start = ev;
        while (obj_start > q && *obj_start != '{') --obj_start;
        const char* t = static_cast<const char*>(memmem(obj_start, obj_end - obj_start, "\"ts\"", 4));
        if (t) {
          t += 4;
          t = skip_ws(t, obj_end);
          if (t < obj_end && *t == ':') ++t;
          t = skip_ws(t, obj_end);
          parse_int(t, obj_end, &ts);
        }
        const char* y = static_cast<const char*>(memmem(obj_start, obj_end - obj_start, "\"type\"", 6));
        if (y) {
          y += 6;
          y = skip_ws(y, obj_end);
          if (y < obj_end && *y == ':') ++y;
          y = skip_ws(y, obj_end);
          if (y < obj_end && *y == '"') ++y;
          ty = type_code(y, obj_end - y);
        }
        if (aid >= 0 && ts >= 0) {
          out->session.push_back(session);
          out->aid.push_back(static_cast<int32_t>(aid));
          out->ts.push_back(ts);
          out->type.push_back(ty);
        }
        q = obj_end + 1;
        if (q >= line_end) break;
      }
    }
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

// Parse a JSONL file; returns an opaque handle (or nullptr) and the event
// count through n_out.
void* otto_parse_file(const char* path, int64_t* n_out) {
  FILE* f = fopen(path, "rb");
  if (!f) { *n_out = -1; return nullptr; }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) { fclose(f); *n_out = -2; return nullptr; }
  // one byte more than the file, so that an empty file is no failed malloc
  char* buf = static_cast<char*>(malloc(size + 1));
  if (!buf || fread(buf, 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    free(buf);
    *n_out = -2;
    return nullptr;
  }
  fclose(f);
  Parsed* out = new Parsed();
  parse_buffer(buf, size, out);
  free(buf);
  *n_out = static_cast<int64_t>(out->session.size());
  return out;
}

// Copy parsed columns into caller-provided buffers of length n.
void otto_fill(void* handle, int64_t* session, int32_t* aid, int64_t* ts, int8_t* type) {
  Parsed* p = static_cast<Parsed*>(handle);
  memcpy(session, p->session.data(), p->session.size() * sizeof(int64_t));
  memcpy(aid, p->aid.data(), p->aid.size() * sizeof(int32_t));
  memcpy(ts, p->ts.data(), p->ts.size() * sizeof(int64_t));
  memcpy(type, p->type.data(), p->type.size() * sizeof(int8_t));
}

void otto_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
