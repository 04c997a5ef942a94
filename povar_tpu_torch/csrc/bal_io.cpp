// Native BAL text tokenizer for povar_tpu_torch.
//
// The reference's data layer is C++ fscanf loops over millions of
// tokens (bal/bal_problem.cpp load_bal_eccv / load_bal_varproj_*).
// This library is the equivalent fast path: single-pass buffered
// tokenization of all whitespace-separated numeric tokens, exposed over
// a minimal C ABI consumed via ctypes (povar_tpu_torch/utils/native.py).
// The same source as the JAX package's csrc/bal_io.cpp.
//
// Build: at first use, by utils/native.py with the host's C++ compiler,
// into build/povar_tpu_torch/bal_io/<key>/libpovar_io.so.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read a whole file into a buffer (with one extra NUL terminator).
static char* read_file(const char* path, long long* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(size + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  long long got = static_cast<long long>(std::fread(buf, 1, size, f));
  std::fclose(f);
  if (got != size) {
    std::free(buf);
    return nullptr;
  }
  buf[size] = '\0';
  *size_out = size;
  return buf;
}

static inline bool is_space(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\v' ||
         c == '\f';
}

}  // namespace

extern "C" {

// Count numeric tokens in the file; returns -1 on I/O error.
long long povar_count_tokens(const char* path) {
  long long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;
  long long count = 0;
  const char* p = buf;
  const char* end = buf + size;
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) break;
    ++count;
    while (p < end && !is_space(*p)) ++p;
  }
  std::free(buf);
  return count;
}

// Parse up to `capacity` tokens into `out`; returns the number parsed,
// or -1 on I/O error.
long long povar_parse_tokens(const char* path, double* out,
                             long long capacity) {
  long long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;
  long long count = 0;
  char* p = buf;
  char* end = buf + size;
  while (p < end && count < capacity) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) break;
    char* next = nullptr;
    out[count++] = std::strtod(p, &next);
    if (next == p) {  // non-numeric token: skip it, undo the count
      --count;
      while (p < end && !is_space(*p)) ++p;
    } else {
      p = next;
    }
  }
  std::free(buf);
  return count;
}

}  // extern "C"
