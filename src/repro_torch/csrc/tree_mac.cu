// Chunked multilinear MAC over Mersenne-31: one tag per chunk of words.
//
// Replaces the Pallas kernel mac_tags_words (src/repro/kernels/tree_mac/
// kernel.py:53, body _mac_kernel).  For item n, row r and chunk c of cw
// words w_j:
//
//   tag = canon( sum_j mulmod(fold(w_j) + 1, key[n, j])
//                + mulmod(pos + 1, key[n, 0]) )  mod 2^31 - 1,
//   pos = canon(((r * n_chunks + c) * 0x9E3779B1) mod 2^32).
//
// Unlike the Pallas kernel, cw is any positive divisor of the row's word
// count (block_tags picks the smallest chunk count that divides it: cw = 2
// for granite's unembed rows of 24,578 words), and the keys are per item
// (page MAC keys are bound to each page's nonce).  Rows of 16-bit elements
// of odd width end in a half-used word whose high half reads as zero.
//
// What bounds it on the H100: every ciphertext word is read once (bytes at
// 3.35 TB/s) and costs ~16 integer operations (two folds, a 64-bit product
// and its fold, the accumulate), so at ~16.7 T int32 ops/s the read of
// 4 bytes per word is the tighter limit.  The simple design gives each
// chunk a group of G = min(32, largest power of two <= cw) threads of one
// warp: lane j reads words j, j+G, ... so a group reads consecutive words,
// keeps an exact 64-bit sum of products, folds it once, and the group
// combines its partial sums with warp shuffles.  The sum is exact mod p,
// so any order gives the reference's canonical tag.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ uint32_t load_word(const T* __restrict__ x,
                                              int64_t row_elem, int64_t w,
                                              int64_t n_elems, bool vec);

template <>
__device__ __forceinline__ uint32_t load_word<uint32_t>(
    const uint32_t* __restrict__ x, int64_t row_elem, int64_t w,
    int64_t n_elems, bool vec) {
  return x[row_elem + w];
}

template <>
__device__ __forceinline__ uint32_t load_word<uint16_t>(
    const uint16_t* __restrict__ x, int64_t row_elem, int64_t w,
    int64_t n_elems, bool vec) {
  if (vec) return reinterpret_cast<const uint32_t*>(x + row_elem)[w];
  const uint32_t lo = x[row_elem + 2 * w];
  const uint32_t hi = (2 * w + 1 < n_elems) ? x[row_elem + 2 * w + 1] : 0u;
  return lo | (hi << 16);
}

template <typename T>
__global__ void mac_tags_kernel(const T* __restrict__ x,
                                const uint32_t* __restrict__ keys,
                                uint32_t* __restrict__ tags, int64_t n_rows,
                                int64_t n_elems, int64_t n_chunks, int cw,
                                int group, bool vec) {
  const int64_t n = blockIdx.y;
  const int64_t per_item = n_rows * n_chunks;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t i = t / group;  // chunk index within the item
  const int lane = static_cast<int>(t % group);
  if (i >= per_item) return;  // whole groups leave together
  const int64_t r = i / n_chunks;
  const int64_t c = i - r * n_chunks;
  const int64_t row_elem = (n * n_rows + r) * n_elems;
  const uint32_t* k = keys + n * cw;
  uint64_t acc = 0;
  for (int j = lane; j < cw; j += group) {
    const uint32_t w = load_word<T>(x, row_elem, c * cw + j, n_elems, vec);
    const uint32_t v = repro::fold32(repro::fold32(w) + 1u);
    acc += repro::mulmod(v, k[j]);  // each term < 2^31 + 8
  }
  acc = (acc & repro::kP31) + (acc >> 31);
  acc = (acc & repro::kP31) + (acc >> 31);
  uint32_t s = static_cast<uint32_t>(acc);
  const unsigned warp_lane = threadIdx.x & 31u;
  const unsigned mask = group == 32
      ? 0xFFFFFFFFu
      : ((1u << group) - 1u) << (warp_lane / group * group);
  for (int off = group / 2; off > 0; off >>= 1) {
    s = repro::addmod(s, __shfl_down_sync(mask, s, off, group));
  }
  if (lane == 0) {
    const uint32_t pos = repro::canon(static_cast<uint32_t>(i) * repro::kPosMix);
    tags[n * per_item + i] =
        repro::canon(repro::addmod(s, repro::mulmod(pos + 1u, k[0])));
  }
}

}  // namespace

// x: N x R x E elements of elem_bytes (2 or 4), contiguous; a row is
// W = ceil(E * elem_bytes / 4) words and W % cw == 0.  keys: uint32[N, cw]
// canonical.  tags: uint32[N, R, W / cw].  Returns cudaGetLastError().
extern "C" int mac_tags_launch(const void* x, const void* keys, void* tags,
                               int64_t n_items, int64_t n_rows,
                               int64_t n_elems, int elem_bytes, int cw,
                               void* stream) {
  const int64_t words = (n_elems * elem_bytes + 3) / 4;
  const int64_t n_chunks = words / cw;
  int group = 1;
  while (group * 2 <= cw && group < 32) group *= 2;
  const bool vec = elem_bytes == 4 || (n_elems % 2) == 0;
  const int threads = 256;
  const int64_t total = n_rows * n_chunks * group;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_items));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  uint32_t* out = static_cast<uint32_t*>(tags);
  if (elem_bytes == 4) {
    mac_tags_kernel<uint32_t><<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(x), k, out, n_rows, n_elems, n_chunks,
        cw, group, vec);
  } else {
    mac_tags_kernel<uint16_t><<<grid, threads, 0, s>>>(
        static_cast<const uint16_t*>(x), k, out, n_rows, n_elems, n_chunks,
        cw, group, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
