// Counter-mode seal/unseal: XOR with a Threefry-2x32 keystream.
//
// Replaces the Pallas kernel ctr_xor_words (src/repro/kernels/ctr_cipher/
// kernel.py:43, body _ctr_kernel).  Word (r, w) of an item's lattice is
// XORed with word w % 2 of threefry2x32(tkey, row(r), w / 2); a 16-bit
// element e of a row takes half e % 2 of word e / 2, low half first
// (core/cipher.py keystream_like).  The operation is its own inverse.
//
// One launch covers N items (N <= 65535, one per blockIdx.y), each with its
// own tensor key, so a page-table gather or a stack of pages unseals in one
// launch.  row(r) is r, or rows[n, r] when explicit row ids are given (one
// token slot of a page is the non-contiguous rows (l*ps + t)*K + k).
//
// What bounds it on the H100: each element is read once and written once
// (2 x bytes at 3.35 TB/s), and each pair of keystream words costs one
// Threefry block, about 80 32-bit integer operations (20 rounds of
// add/rotate/xor plus 5 key injections).  For bf16 the two are close: 8
// bytes moved per block against ~80 ops, at ~16.7 T int32 ops/s.  The
// simple design gives one thread per Threefry block: the keystream never
// leaves registers, the rotates are single funnel shifts, and when a row
// is a whole number of blocks the thread moves its 8 bytes with one vector
// load and one vector store, neighbouring threads on neighbouring
// addresses.  Rows of odd width (granite's unembed: 49155 bf16 elements)
// take an element-wise path.
#include "common.cuh"

namespace {

template <typename T>
__global__ void ctr_xor_kernel(const T* __restrict__ x, T* __restrict__ out,
                               const uint32_t* __restrict__ tkeys,
                               const uint32_t* __restrict__ rows,
                               int64_t n_rows, int64_t n_elems, int64_t nb,
                               bool vec) {
  constexpr int kEpw = 4 / sizeof(T);  // elements per 32-bit word
  constexpr int kEpb = 2 * kEpw;       // elements per Threefry block
  const int64_t n = blockIdx.y;
  const uint32_t k0 = tkeys[2 * n];
  const uint32_t k1 = tkeys[2 * n + 1];
  const int64_t per_item = n_rows * nb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < per_item; i += stride) {
    const int64_t r = i / nb;
    const int64_t b = i - r * nb;
    uint32_t y0 = rows ? rows[n * n_rows + r] : static_cast<uint32_t>(r);
    uint32_t y1 = static_cast<uint32_t>(b);
    repro::threefry2x32(k0, k1, y0, y1);
    const int64_t base = (n * n_rows + r) * n_elems + b * kEpb;
    if (vec) {
      const uint2 v = reinterpret_cast<const uint2*>(x + base)[0];
      uint2 o;
      o.x = v.x ^ y0;
      o.y = v.y ^ y1;
      reinterpret_cast<uint2*>(out + base)[0] = o;
    } else {
      const int64_t left = n_elems - b * kEpb;
#pragma unroll
      for (int j = 0; j < kEpb; ++j) {
        if (j < left) {
          const uint32_t w = (j / kEpw == 0) ? y0 : y1;
          const uint32_t ks = kEpw == 1 ? w : (w >> (16 * (j % kEpw))) & 0xFFFFu;
          out[base + j] = static_cast<T>(x[base + j] ^ static_cast<T>(ks));
        }
      }
    }
  }
}

}  // namespace

// x, out: N x R x E elements of elem_bytes (2 or 4) each, contiguous.
// tkeys: uint32[N, 2]; rows: uint32[N, R] or null.  Returns the launch's
// cudaGetLastError().
extern "C" int ctr_xor_launch(const void* x, void* out, const void* tkeys,
                              const void* rows, int64_t n_items,
                              int64_t n_rows, int64_t n_elems, int elem_bytes,
                              void* stream) {
  const int64_t epw = 4 / elem_bytes;
  const int64_t words = (n_elems + epw - 1) / epw;
  const int64_t nb = (words + 1) / 2;
  const bool vec = (n_elems % (2 * epw)) == 0;
  const int64_t per_item = n_rows * nb;
  const int threads = 256;
  int64_t blocks = (per_item + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_items));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(tkeys);
  const uint32_t* rw = static_cast<const uint32_t*>(rows);
  if (elem_bytes == 4) {
    ctr_xor_kernel<uint32_t><<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), k, rw,
        n_rows, n_elems, nb, vec);
  } else {
    ctr_xor_kernel<uint16_t><<<grid, threads, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), k, rw,
        n_rows, n_elems, nb, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
