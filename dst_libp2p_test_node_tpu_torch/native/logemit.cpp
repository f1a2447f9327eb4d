// Native latency-line emitter (loaded via ctypes, see runtime/native_logemit.py;
// the reference package's native/logemit.cpp, unchanged but for this header).
//
// Formats one message's worth of awk-consumable latencies lines:
//   shadow.data/hosts/peer<pid>/main.1000.stdout:<lineno>:<msgId> milliseconds: <ms>
// The reference gets these lines for free from grep over per-process stdout
// files (shadow/run.sh:61); with a million simulated peers in one process,
// Python string formatting becomes the bottleneck, hence this C++ hot path
// (SURVEY.md §2 native-component note).
//
// Build (runtime/native_logemit.py does it at first use):
//   g++ -O2 -shared -fPIC -o native/_build/logemit-<hash>.so logemit.cpp

#include <cstdint>
#include <cstring>

namespace {

// fast unsigned integer -> ascii, returns chars written
inline int u64_to_ascii(uint64_t v, char *out) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + (v % 10));
    v /= 10;
  } while (v != 0);
  for (int i = 0; i < n; ++i) out[i] = tmp[n - 1 - i];
  return n;
}

inline int i64_to_ascii(int64_t v, char *out) {
  if (v < 0) {
    out[0] = '-';
    return 1 + u64_to_ascii(static_cast<uint64_t>(-v), out + 1);
  }
  return u64_to_ascii(static_cast<uint64_t>(v), out);
}

constexpr char kPrefix[] = "shadow.data/hosts/peer";
constexpr char kStdout[] = "/main.1000.stdout:";
constexpr char kMillis[] = " milliseconds: ";

}  // namespace

extern "C" {

// Returns bytes written, or -1 if the output buffer is too small.
long long format_block(unsigned long long msg_id, const long long *peers,
                       const long long *linenos, const long long *delays,
                       long long count, char *out, long long capacity) {
  char msg_buf[21];
  const int msg_len = u64_to_ascii(msg_id, msg_buf);
  char *p = out;
  const char *end = out + capacity;
  // worst case line: 57 fixed chars + 3x21-char signed int64 + 20-char msgId
  for (long long i = 0; i < count; ++i) {
    if (end - p < 160) return -1;
    std::memcpy(p, kPrefix, sizeof(kPrefix) - 1);
    p += sizeof(kPrefix) - 1;
    p += i64_to_ascii(peers[i], p);
    std::memcpy(p, kStdout, sizeof(kStdout) - 1);
    p += sizeof(kStdout) - 1;
    p += i64_to_ascii(linenos[i], p);
    *p++ = ':';
    std::memcpy(p, msg_buf, msg_len);
    p += msg_len;
    std::memcpy(p, kMillis, sizeof(kMillis) - 1);
    p += sizeof(kMillis) - 1;
    p += i64_to_ascii(delays[i], p);
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"
