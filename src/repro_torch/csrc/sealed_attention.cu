// Flash-decode attention over a sealed (CTR-encrypted, MAC-tagged) KV cache.
//
// Replaces the Pallas kernel sealed_decode_attention (src/repro/kernels/
// sealed_attention/kernel.py:122, body _kernel, helpers _unseal_rows_bf16
// and _row_tags).  One new token's GQA query q bf16[B, K, G, hd] attends to
// ciphertext caches k_ct/v_ct (bf16 bits) [B, T, K, hd]:
//
//   * cache row (b, t, k) has counter row id (b*T + t)*K + k (mod 2^32);
//     its word w is XORed with word w % 2 of threefry2x32(tkey, row, w / 2),
//     bf16 element e taking half e % 2 of word e / 2, low half first;
//   * with verify on, the row's tag is the M31 chunk tag over its hd/2
//     ciphertext words with pos = canon(row * 0x9E3779B1); bad[b, k] counts
//     the mismatching rows t < t_valid of K plus V;
//   * rows t >= t_valid are never read (the Pallas kernel zeroes them and
//     masks their scores to -1e30, which gives the same softmax);
//   * scores q.k * hd^-0.5 in f32, online softmax in f32, output
//     acc / max(l, 1e-30) rounded to bf16.
//
// Plaintext K/V exists only in registers and shared memory: each block
// decrypts its rows straight from the ciphertext into shared memory.  Any T
// works (no multiple-of-tile rule).
//
// Design (flash-decoding): at serving shapes B*K is 32-64 (b, k) pairs,
// far fewer than the 132 SMs, so T is split into chunks of 4096/hd rows
// (at most 256), one block per (chunk, k, b).  A block decrypts and
// verifies its chunk of K and V into shared memory (one thread per
// Threefry block of 4 bf16, 8-byte loads, neighbouring threads on
// neighbouring words of a row; a row's tag is summed over the row's
// hd/4 lanes with warp shuffles), computes the G x rows scores, a softmax
// over the chunk and the G x hd partial sums, and writes (max, sum, acc)
// partials to a small f32 scratch buffer.  A second kernel combines the
// chunks of each (b, k).  The partials are softmax-weighted sums, never
// K/V rows.
//
// What bounds it on the H100: per valid row of K or V it reads hd*2 bytes
// of ciphertext and runs hd/4 Threefry blocks of ~74 integer operations
// (plus ~20 per word for the MAC when verifying), so at hd = 64 a byte of
// cache costs ~9 integer operations.  At 16.7 T int32 ops/s against
// 3.35 TB/s that is the operation bound: the design keeps every
// keystream in registers, reads each ciphertext byte once, and spends
// nothing on the dot products that is not hidden beside the Threefry work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

// Two decrypted words (4 bf16, low half first) as f32 into shared memory.
__device__ __forceinline__ void store_plain(float* dst, uint32_t w0,
                                            uint32_t w1) {
  dst[0] = __uint_as_float(w0 << 16);
  dst[1] = __uint_as_float(w0 & 0xFFFF0000u);
  dst[2] = __uint_as_float(w1 << 16);
  dst[3] = __uint_as_float(w1 & 0xFFFF0000u);
}

// This lane's share of a row tag: sum of mulmod(fold(fold(w) + 1), key) over
// its two ciphertext words, folded to < 2^31 + 1.
__device__ __forceinline__ uint32_t tag_part(uint2 c, uint32_t k0,
                                             uint32_t k1) {
  uint64_t acc = repro::mulmod(repro::fold32(repro::fold32(c.x) + 1u), k0);
  acc += repro::mulmod(repro::fold32(repro::fold32(c.y) + 1u), k1);
  acc = (acc & repro::kP31) + (acc >> 31);
  acc = (acc & repro::kP31) + (acc >> 31);
  return static_cast<uint32_t>(acc);
}

__global__ void __launch_bounds__(kThreads)
sealed_attention_split(const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ k_ct,
                       const uint16_t* __restrict__ v_ct,
                       const uint32_t* __restrict__ k_tags,
                       const uint32_t* __restrict__ v_tags,
                       const uint32_t* __restrict__ key_k,
                       const uint32_t* __restrict__ key_v,
                       const uint32_t* __restrict__ mkeys,
                       float* __restrict__ part, int* __restrict__ bad,
                       int T, int K, int G, int hd, int t_valid, int chunk,
                       float scale, int verify) {
  extern __shared__ float smem[];
  __shared__ int bad_s;
  const int split = blockIdx.x;
  const int kk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int stride = hd + 1;  // padded rows: conflict-free column reads
  float* ks = smem;                    // [chunk][hd + 1] plaintext K
  float* vs = ks + chunk * stride;     // [chunk][hd + 1] plaintext V
  float* qs = vs + chunk * stride;     // [G][hd]
  float* ps = qs + G * hd;             // [G][chunk] scores, then weights
  float* ml = ps + G * chunk;          // [G][2] chunk max and sum
  const int t0 = split * chunk;
  const int nrows = min(chunk, t_valid - t0);  // <= 0: an empty chunk
  const int bk = b * K + kk;

  if (tid == 0) bad_s = 0;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = __uint_as_float(static_cast<uint32_t>(
        q[static_cast<int64_t>(bk) * G * hd + i]) << 16);
  }
  __syncthreads();  // bad_s is zero before any warp adds to it

  // 1. decrypt (and verify) this chunk's rows into shared memory
  const uint32_t kk0 = key_k[0], kk1 = key_k[1];
  const uint32_t vk0 = key_v[0], vk1 = key_v[1];
  const int nb = hd / 4;  // Threefry blocks (lanes) per row, power of two
  for (int base = 0; base < chunk * nb; base += kThreads) {
    const int i = base + tid;
    const int r = i / nb;
    const int blk = i - r * nb;
    const bool act = r < nrows;
    const int t = t0 + r;
    const uint32_t row = (static_cast<uint32_t>(b) * static_cast<uint32_t>(T)
                          + static_cast<uint32_t>(t)) *
                             static_cast<uint32_t>(K) +
                         static_cast<uint32_t>(kk);
    uint32_t sk = 0, sv = 0;
    if (act) {
      const int64_t ri = (static_cast<int64_t>(b) * T + t) * K + kk;
      const int64_t off = ri * hd + blk * 4;
      const uint2 ck = *reinterpret_cast<const uint2*>(k_ct + off);
      const uint2 cv = *reinterpret_cast<const uint2*>(v_ct + off);
      uint32_t y0 = row, y1 = static_cast<uint32_t>(blk);
      repro::threefry2x32(kk0, kk1, y0, y1);
      store_plain(ks + r * stride + blk * 4, ck.x ^ y0, ck.y ^ y1);
      y0 = row;
      y1 = static_cast<uint32_t>(blk);
      repro::threefry2x32(vk0, vk1, y0, y1);
      store_plain(vs + r * stride + blk * 4, cv.x ^ y0, cv.y ^ y1);
      if (verify) {
        sk = tag_part(ck, mkeys[2 * blk], mkeys[2 * blk + 1]);
        sv = tag_part(cv, mkeys[2 * blk], mkeys[2 * blk + 1]);
      }
    }
    if (verify) {  // uniform over the block: every lane shuffles
      for (int o = nb / 2; o > 0; o >>= 1) {
        sk = repro::addmod(sk, __shfl_down_sync(0xFFFFFFFFu, sk, o, nb));
        sv = repro::addmod(sv, __shfl_down_sync(0xFFFFFFFFu, sv, o, nb));
      }
      if (act && blk == 0) {
        const int64_t ri = (static_cast<int64_t>(b) * T + t) * K + kk;
        const uint32_t pos = repro::canon(row * repro::kPosMix);
        const uint32_t pterm = repro::mulmod(pos + 1u, mkeys[0]);
        const int n = (repro::canon(repro::addmod(sk, pterm)) != k_tags[ri]) +
                      (repro::canon(repro::addmod(sv, pterm)) != v_tags[ri]);
        if (n) atomicAdd(&bad_s, n);
      }
    }
  }
  __syncthreads();

  // 2. scores s[g][r] = q_g . k_r * scale (consecutive threads: consecutive r)
  for (int p = tid; p < G * chunk; p += kThreads) {
    const int g = p / chunk;
    const int r = p - g * chunk;
    float s = kNeg;
    if (r < nrows) {
      const float* qg = qs + g * hd;
      const float* kr = ks + r * stride;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qg[d], kr[d], acc);
      s = acc * scale;
    }
    ps[p] = s;
  }
  __syncthreads();

  // 3. the chunk's softmax: one warp per query head
  for (int g = warp; g < G; g += kThreads / 32) {
    float* pg = ps + g * chunk;
    float m = kNeg;
    for (int r = lane; r < chunk; r += 32) m = fmaxf(m, pg[r]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    float l = 0.f;
    for (int r = lane; r < chunk; r += 32) {
      const float w = r < nrows ? expf(pg[r] - m) : 0.f;
      pg[r] = w;
      l += w;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xFFFFFFFFu, l, o);
    if (lane == 0) {
      ml[2 * g] = m;
      ml[2 * g + 1] = l;
    }
  }
  __syncthreads();

  // 4. partial sums acc[g][d] = sum_r w[g][r] v[r][d], and the partials out
  //    part layout: [B*K][n_split][G][hd + 2] = (acc..., max, sum)
  float* out = part + (static_cast<int64_t>(bk) * n_split + split) * G * (hd + 2);
  for (int o = tid; o < G * hd; o += kThreads) {
    const int g = o / hd;
    const int d = o - g * hd;
    const float* pg = ps + g * chunk;
    float acc = 0.f;
    for (int r = 0; r < nrows; ++r) acc = fmaf(pg[r], vs[r * stride + d], acc);
    out[g * (hd + 2) + d] = acc;
  }
  for (int g = tid; g < G; g += kThreads) {
    out[g * (hd + 2) + hd] = ml[2 * g];
    out[g * (hd + 2) + hd + 1] = ml[2 * g + 1];
  }
  if (tid == 0 && bad_s) atomicAdd(bad + bk, bad_s);
}

// Merge the chunks of each (b, k): rescale every chunk to the global max.
__global__ void __launch_bounds__(kThreads)
sealed_attention_combine(const float* __restrict__ part,
                         __nv_bfloat16* __restrict__ out, int G, int hd,
                         int n_split) {
  const int bk = blockIdx.x;
  const float* pb = part + static_cast<int64_t>(bk) * n_split * G * (hd + 2);
  for (int o = threadIdx.x; o < G * hd; o += kThreads) {
    const int g = o / hd;
    const int d = o - g * hd;
    float m = kNeg;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, pb[(s * G + g) * (hd + 2) + hd]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = pb + (s * G + g) * (hd + 2);
      const float a = expf(ps[hd] - m);
      l = fmaf(ps[hd + 1], a, l);
      acc = fmaf(ps[d], a, acc);
    }
    out[static_cast<int64_t>(bk) * G * hd + o] =
        __float2bfloat16(acc / fmaxf(l, 1e-30f));
  }
}

}  // namespace

// q: bf16 bits [B, K, G, hd]; k_ct, v_ct: bf16 bits [B, T, K, hd]; k_tags,
// v_tags: uint32 [B, T, K] (read only when verify); key_k, key_v: uint32[2]
// tensor keys; mkeys: uint32[hd / 2] canonical MAC keys (read only when
// verify); out: bf16 [B, K, G, hd]; bad: int32 [B, K], zeroed by the
// caller; part: f32 scratch of B*K*n_split*G*(hd + 2).  hd / 4 must be a
// power of two <= 32, 1 <= t_valid <= T or 0, n_split = max(1,
// ceil(t_valid / chunk)).  Returns the last cudaGetLastError().
extern "C" int sealed_attention_launch(
    const void* q, const void* k_ct, const void* v_ct, const void* k_tags,
    const void* v_tags, const void* key_k, const void* key_v,
    const void* mkeys, void* out, void* bad, void* part, int B, int T, int K,
    int G, int hd, int t_valid, int chunk, int n_split, float scale,
    int verify, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(chunk) * (hd + 1) + G * hd + G * chunk + 2 * G);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(n_split, K, B);
  sealed_attention_split<<<grid, kThreads, smem, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k_ct),
      static_cast<const uint16_t*>(v_ct), static_cast<const uint32_t*>(k_tags),
      static_cast<const uint32_t*>(v_tags),
      static_cast<const uint32_t*>(key_k), static_cast<const uint32_t*>(key_v),
      static_cast<const uint32_t*>(mkeys), static_cast<float*>(part),
      static_cast<int*>(bad), T, K, G, hd, t_valid, chunk, scale, verify);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sealed_attention_combine<<<B * K, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), G,
      hd, n_split);
  return static_cast<int>(cudaGetLastError());
}
