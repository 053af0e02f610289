// Sealed matrix product: C = unseal(A_ct) @ unseal(B_ct), with every MAC
// chunk of both operands verified once.
//
// Replaces the Pallas kernel sealed_matmul (src/repro/kernels/sealed_matmul/
// kernel.py:118, body _sealed_matmul_kernel, helpers _unseal_tile_bf16 and
// _tile_tags).  A is uint16[M, K] and B uint16[K, N]: the bits of bf16
// ciphertext, sealed in the shaped lattice (core/cipher.py seal_bits), so
// element (r, c) of either is XORed with half c % 2 of word (c / 2) % 2 of
// threefry2x32(tensor key, (r, c / 4)).  C is bf16[M, N], the f32 sum of
// products rounded once.  The data format is fixed: M, K, N are multiples
// of 256, every row of A and B is tagged in chunks of 256 bf16 (128 words,
// tags_a uint32[M, K/256], tags_b uint32[K, N/256]), and bad int32[M/256,
// N/256] counts, for output tile (i, j), the mismatched chunks of A's rows
// 256i..256i+255 plus those of B's chunk column j: what the Pallas grid
// counts when its step (i, j, k) checks the tiles it fetches.
//
// What bounds it on the H100: the keystream.  The plaintext may not reach
// device memory, so every block that reads a ciphertext tile regenerates
// its keystream: 74 integer operations per Threefry block of four bf16,
// 18.5 * M * K * N * (1/BM + 1/BN) operations in all.  With 128 x 128
// output tiles that is ~40 G operations at M 8192, K 2048, N 8192 (2.4 ms
// at ~16.7 T int32 ops/s), against 0.28 ms for the 2MKN FLOP on the tensor
// cores and 0.06 ms for the bytes.
//
// The simple design: one block of 256 threads per 128 x 128 output tile,
// a k-step of 32.  Each thread loads its four A and four B Threefry blocks
// of the next k-step (8-byte loads) into registers before the tensor cores
// work on the current one, then XORs them with the keystream and stores
// bf16 plaintext into the other half of a double-buffered shared-memory
// tile: plaintext exists only in registers and shared memory.  Eight warps
// each own a 64 x 32 sub-tile as 4 x 2 wmma bf16 16x16x16 fragments with
// f32 accumulators; the epilogue rounds to bf16 once and writes 16 bytes
// per lane.  Verification is a first pass, one warp per 128-word chunk
// (16-byte loads, exact M31 sums, warp-shuffle combine), that counts
// mismatches per A row tile and per B chunk column with atomics; the
// product's block for the top-left 128-tile of each 256-tile adds the two
// counts into bad.  So each chunk is verified once, not once per output
// tile as in the Pallas kernel.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kTile = 256;         // bad grid tile and MAC chunk, in bf16
constexpr int kChunkWords = kTile / 2;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;
constexpr int A_LD = BK + 8;       // padded rows (80 and 272 bytes): the
constexpr int B_LD = BN + 8;       // fragment loads hit distinct banks
constexpr int A_BLOCKS = BM * BK / 4 / kThreads;   // Threefry blocks a
constexpr int B_BLOCKS = BK * BN / 4 / kThreads;   // thread owns per k-step

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void load_tiles(const uint16_t* __restrict__ a,
                                           const uint16_t* __restrict__ b,
                                           int row0, int col0, int k0, int K,
                                           int N, uint2 (&ra)[A_BLOCKS],
                                           uint2 (&rb)[B_BLOCKS]) {
#pragma unroll
  for (int t = 0; t < A_BLOCKS; ++t) {
    const int q = threadIdx.x + t * kThreads;
    const int r = q / (BK / 4), blk = q % (BK / 4);
    ra[t] = *reinterpret_cast<const uint2*>(
        a + static_cast<int64_t>(row0 + r) * K + k0 + blk * 4);
  }
#pragma unroll
  for (int t = 0; t < B_BLOCKS; ++t) {
    const int q = threadIdx.x + t * kThreads;
    const int r = q / (BN / 4), blk = q % (BN / 4);
    rb[t] = *reinterpret_cast<const uint2*>(
        b + static_cast<int64_t>(k0 + r) * N + col0 + blk * 4);
  }
}

__device__ __forceinline__ void decrypt_tiles(
    const uint2 (&ra)[A_BLOCKS], const uint2 (&rb)[B_BLOCKS], uint32_t ka0,
    uint32_t ka1, uint32_t kb0, uint32_t kb1, int row0, int col0, int k0,
    __nv_bfloat16* __restrict__ as, __nv_bfloat16* __restrict__ bs) {
#pragma unroll
  for (int t = 0; t < A_BLOCKS; ++t) {
    const int q = threadIdx.x + t * kThreads;
    const int r = q / (BK / 4), blk = q % (BK / 4);
    uint32_t y0 = static_cast<uint32_t>(row0 + r);
    uint32_t y1 = static_cast<uint32_t>(k0 / 4 + blk);
    repro::threefry2x32(ka0, ka1, y0, y1);
    uint2 v = ra[t];
    v.x ^= y0;
    v.y ^= y1;
    *reinterpret_cast<uint2*>(as + r * A_LD + blk * 4) = v;
  }
#pragma unroll
  for (int t = 0; t < B_BLOCKS; ++t) {
    const int q = threadIdx.x + t * kThreads;
    const int r = q / (BN / 4), blk = q % (BN / 4);
    uint32_t y0 = static_cast<uint32_t>(k0 + r);
    uint32_t y1 = static_cast<uint32_t>(col0 / 4 + blk);
    repro::threefry2x32(kb0, kb1, y0, y1);
    uint2 v = rb[t];
    v.x ^= y0;
    v.y ^= y1;
    *reinterpret_cast<uint2*>(bs + r * B_LD + blk * 4) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
sealed_matmul_kernel(const uint16_t* __restrict__ a,
                     const uint16_t* __restrict__ b,
                     const uint32_t* __restrict__ key_a,
                     const uint32_t* __restrict__ key_b,
                     const int* __restrict__ cnt_a,
                     const int* __restrict__ cnt_b,
                     __nv_bfloat16* __restrict__ c, int* __restrict__ bad,
                     int M, int K, int N) {
  __shared__ __align__(128) __nv_bfloat16 as[2][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 bs[2][BK * B_LD];
  __shared__ __align__(128) float cs[kThreads / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int wr = (warp / 4) * 64, wc = (warp % 4) * 32;
  const uint32_t ka0 = key_a[0], ka1 = key_a[1];
  const uint32_t kb0 = key_b[0], kb1 = key_b[1];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint2 ra[A_BLOCKS], rb[B_BLOCKS];
  const int nk = K / BK;
  load_tiles(a, b, row0, col0, 0, K, N, ra, rb);
  decrypt_tiles(ra, rb, ka0, ka1, kb0, kb1, row0, col0, 0, as[0], bs[0]);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load_tiles(a, b, row0, col0, (kt + 1) * BK, K, N, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], as[buf] + (wr + 16 * i) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs[buf] + kk * B_LD + wc + 16 * j,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more)
      decrypt_tiles(ra, rb, ka0, ka1, kb0, kb1, row0, col0, (kt + 1) * BK,
                    as[buf ^ 1], bs[buf ^ 1]);
    __syncthreads();
  }

  // epilogue: each 16 x 16 fragment through the warp's f32 scratch, one
  // bf16 rounding, eight outputs (16 bytes) per lane
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c8 = (lane % 2) * 8;
      const float* f = cs[warp] + r * 16 + c8;
      uint4 out;
      out.x = pack_bf16(f[0], f[1]);
      out.y = pack_bf16(f[2], f[3]);
      out.z = pack_bf16(f[4], f[5]);
      out.w = pack_bf16(f[6], f[7]);
      *reinterpret_cast<uint4*>(c + static_cast<int64_t>(row0 + wr + 16 * i + r) *
                                        N + col0 + wc + 16 * j + c8) = out;
      __syncwarp();
    }
  }
  if (threadIdx.x == 0 && row0 % kTile == 0 && col0 % kTile == 0) {
    bad[(row0 / kTile) * (N / kTile) + col0 / kTile] =
        cnt_a[row0 / kTile] + cnt_b[col0 / kTile];
  }
}

// One warp per 128-word chunk of x (n_rows rows of row_words words): the
// chunk tag of tree_mac.cu, compared with tags[r * n_chunks + c]; a
// mismatch counts into cnt[r / 256] (by_row, operand A) or cnt[c] (B).
__global__ void verify_chunks_kernel(const uint16_t* __restrict__ x,
                                     const uint32_t* __restrict__ tags,
                                     const uint32_t* __restrict__ keys,
                                     int64_t n_rows, int n_chunks,
                                     int64_t row_words, int by_row,
                                     int* __restrict__ cnt) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_rows * n_chunks) return;  // whole warps leave together
  const int64_t r = i / n_chunks;
  const int ch = static_cast<int>(i - r * n_chunks);
  const uint4 w = reinterpret_cast<const uint4*>(
      x + 2 * (r * row_words + static_cast<int64_t>(ch) * kChunkWords))[lane];
  const uint4 k = reinterpret_cast<const uint4*>(keys)[lane];
  uint64_t acc = 0;
  acc += repro::mulmod(repro::fold32(repro::fold32(w.x) + 1u), k.x);
  acc += repro::mulmod(repro::fold32(repro::fold32(w.y) + 1u), k.y);
  acc += repro::mulmod(repro::fold32(repro::fold32(w.z) + 1u), k.z);
  acc += repro::mulmod(repro::fold32(repro::fold32(w.w) + 1u), k.w);
  acc = (acc & repro::kP31) + (acc >> 31);
  acc = (acc & repro::kP31) + (acc >> 31);
  uint32_t s = static_cast<uint32_t>(acc);
  for (int off = 16; off > 0; off >>= 1) {
    s = repro::addmod(s, __shfl_down_sync(0xFFFFFFFFu, s, off));
  }
  if (lane == 0) {
    const uint32_t pos =
        repro::canon(static_cast<uint32_t>(i) * repro::kPosMix);
    const uint32_t tag =
        repro::canon(repro::addmod(s, repro::mulmod(pos + 1u, keys[0])));
    if (tag != tags[i]) atomicAdd(cnt + (by_row ? r / kTile : ch), 1);
  }
}

}  // namespace

// a uint16[M, K], b uint16[K, N], c bf16[M, N], bad int32[M/256, N/256],
// all contiguous, a and b 16-byte aligned; M, K, N multiples of 256.
// key_a, key_b uint32[2] tensor keys; tags_a uint32[M, K/256], tags_b
// uint32[K, N/256] and mkeys uint32[128] canonical MAC keys (read only
// when verify).  counts: int32[M/256 + N/256] scratch.  Returns the
// launches' cudaGetLastError().
extern "C" int sealed_matmul_launch(const void* a, const void* b,
                                    const void* tags_a, const void* tags_b,
                                    const void* key_a, const void* key_b,
                                    const void* mkeys, void* c, void* bad,
                                    void* counts, int M, int K, int N,
                                    int verify, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cnt_a = static_cast<int*>(counts);
  int* cnt_b = cnt_a + M / kTile;
  cudaMemsetAsync(counts, 0, sizeof(int) * (M / kTile + N / kTile), s);
  if (verify) {
    const uint32_t* mk = static_cast<const uint32_t*>(mkeys);
    const int64_t warps_a = static_cast<int64_t>(M) * (K / kTile);
    verify_chunks_kernel<<<static_cast<unsigned>((warps_a * 32 + 255) / 256),
                           256, 0, s>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint32_t*>(tags_a),
        mk, M, K / kTile, K / 2, 1, cnt_a);
    const int64_t warps_b = static_cast<int64_t>(K) * (N / kTile);
    verify_chunks_kernel<<<static_cast<unsigned>((warps_b * 32 + 255) / 256),
                           256, 0, s>>>(
        static_cast<const uint16_t*>(b), static_cast<const uint32_t*>(tags_b),
        mk, K, N / kTile, N / 2, 0, cnt_b);
  }
  dim3 grid(N / BN, M / BM);
  sealed_matmul_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<const uint32_t*>(key_a), static_cast<const uint32_t*>(key_b),
      cnt_a, cnt_b, static_cast<__nv_bfloat16*>(c), static_cast<int*>(bad), M,
      K, N);
  return static_cast<int>(cudaGetLastError());
}
