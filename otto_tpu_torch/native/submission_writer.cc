// Native Kaggle-submission writer.
//
// Emits the reference's format (src/baseline/aid_frequency.py:108-115):
//   session_type,labels
//   {sid}_clicks,a1 a2 ... a20
//   {sid}_carts,...
//   {sid}_orders,...
// gzip-compressed.  The Python loop this replaces formats ~44M rows at full
// OTTO scale (14.6M sessions x 3 types) through a single-threaded zlib
// stream; here formatting and deflate run across threads, each producing an
// independent gzip member (concatenated members are a valid gzip stream —
// the same trick pigz uses), written out in order.
//
// Copied from the JAX package's native/submission_writer.cc.  Built by
// otto_tpu_torch/data/submission.py at first use:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -o _build/libotto_submission_<hash>.so \
//       submission_writer.cc -lz
// One change: a call with no sessions writes the header alone.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

const char* kTypeNames[3] = {"clicks", "carts", "orders"};
const int kTypeLens[3] = {6, 5, 6};

inline int format_u64(uint64_t v, char* out) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  for (int i = 0; i < n; ++i) out[i] = tmp[n - 1 - i];
  return n;
}

// Format rows for sessions [lo, hi) into `text`.
void format_rows(const int64_t* session_ids, int64_t S, const int32_t* preds,
                 int64_t K, int64_t lo, int64_t hi, std::string* text) {
  text->reserve(static_cast<size_t>((hi - lo) * 3 * (32 + K * 8)));
  char row[4096];
  for (int64_t s = lo; s < hi; ++s) {
    for (int t = 0; t < 3; ++t) {
      char* p = row;
      p += format_u64(static_cast<uint64_t>(session_ids[s]), p);
      *p++ = '_';
      std::memcpy(p, kTypeNames[t], kTypeLens[t]);
      p += kTypeLens[t];
      *p++ = ',';
      const int32_t* r = preds + (static_cast<int64_t>(t) * S + s) * K;
      bool first = true;
      for (int64_t j = 0; j < K; ++j) {
        if (r[j] < 0) continue;
        if (!first) *p++ = ' ';
        first = false;
        p += format_u64(static_cast<uint64_t>(r[j]), p);
      }
      *p++ = '\n';
      text->append(row, static_cast<size_t>(p - row));
    }
  }
}

// Deflate `text` as one standalone gzip member into `out`.
bool gzip_member(const std::string& text, int level, std::vector<unsigned char>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // windowBits 15 + 16 -> gzip wrapper
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  uLong bound = deflateBound(&zs, static_cast<uLong>(text.size()));
  out->resize(bound);
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(text.data()));
  zs.avail_in = static_cast<uInt>(text.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = deflate(&zs, Z_FINISH);
  bool ok = (rc == Z_STREAM_END);
  out->resize(zs.total_out);
  deflateEnd(&zs);
  return ok;
}

}  // namespace

extern "C" {

// session_ids: [S] int64; preds: [3, S, K] int32 padded with -1 (type-major:
// clicks, carts, orders).  Returns rows written (S*3) or -1 on error.
int64_t otto_write_submission(const char* path, const int64_t* session_ids,
                              int64_t S, const int32_t* preds, int64_t K,
                              int gzip_level) {
  if (gzip_level < 0) gzip_level = 6;
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw ? (hw > 16 ? 16 : hw) : 4);
  int64_t per = (S + n_threads - 1) / n_threads;
  if (per < 1024) {
    per = S > 0 ? S : 1;  // no sessions: the header alone (no division by 0)
    n_threads = 1;
  }
  n_threads = static_cast<int>((S + per - 1) / per);

  std::vector<std::vector<unsigned char>> members(
      static_cast<size_t>(n_threads) + 1);
  std::vector<char> ok(static_cast<size_t>(n_threads) + 1, 0);

  // header as its own member
  {
    std::string header = "session_type,labels\n";
    ok[0] = gzip_member(header, gzip_level, &members[0]);
  }

  std::vector<std::thread> threads;
  for (int i = 0; i < n_threads; ++i) {
    threads.emplace_back([&, i]() {
      int64_t lo = static_cast<int64_t>(i) * per;
      int64_t hi = lo + per < S ? lo + per : S;
      std::string text;
      format_rows(session_ids, S, preds, K, lo, hi, &text);
      ok[i + 1] = gzip_member(text, gzip_level, &members[i + 1]);
    });
  }
  for (auto& t : threads) t.join();

  for (int i = 0; i <= n_threads; ++i)
    if (!ok[i]) return -1;

  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  for (int i = 0; i <= n_threads; ++i) {
    if (!members[i].empty() &&
        std::fwrite(members[i].data(), 1, members[i].size(), f) !=
            members[i].size()) {
      std::fclose(f);
      return -1;
    }
  }
  return std::fclose(f) == 0 ? S * 3 : -1;
}

}  // extern "C"
