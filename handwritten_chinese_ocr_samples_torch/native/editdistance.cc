// Levenshtein edit distance over UTF-32 codepoint arrays.
//
// Native backend for eval/metrics.py (loaded via ctypes). Replaces the
// reference's third-party `editdistance` C extension (`main.py:21`,
// `test.py:275-277`) with a first-party implementation.
//
// Built with the host C++ compiler at first use (ops/_build.load_host).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Classic two-row dynamic program; O(|a|*|b|) time, O(min) memory.
int64_t edit_distance_u32(const uint32_t* a, int64_t la,
                          const uint32_t* b, int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  // Iterate over the shorter string in the inner loop.
  if (lb > la) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  std::vector<int64_t> row(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) row[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    int64_t diag = row[0];  // D[i-1][j-1]
    row[0] = i;
    for (int64_t j = 1; j <= lb; ++j) {
      int64_t up = row[j];  // D[i-1][j]
      int64_t cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
      row[j] = std::min({row[j - 1] + 1,  // insertion
                         up + 1,          // deletion
                         diag + cost});   // substitution
      diag = up;
    }
  }
  return row[lb];
}

// Batched variant: distances for n string pairs packed into flat arrays
// with prefix offsets (offs has n+1 entries per side).
void edit_distance_batch_u32(const uint32_t* a, const int64_t* a_offs,
                             const uint32_t* b, const int64_t* b_offs,
                             int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = edit_distance_u32(a + a_offs[i], a_offs[i + 1] - a_offs[i],
                               b + b_offs[i], b_offs[i + 1] - b_offs[i]);
  }
}

}  // extern "C"
