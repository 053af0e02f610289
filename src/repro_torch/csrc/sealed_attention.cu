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
// What bounds it on the H100: per valid row of K or V it reads hd*2 bytes
// of ciphertext and runs hd/4 Threefry blocks of 74 integer operations
// (plus ~20 per word for the MAC when verifying), so a byte of cache costs
// ~9 integer operations: the ALU pipe, not the 3.35 TB/s, is the limit.
// The rotates (SHF) and XORs (LOP3) issue only there, so this kernel
// issues all 32 adds of a block on the FMA pipe as IMAD (threefry_imad),
// where ptxas, left alone, puts some on the ALU pipe as IADD3.
//
// Design.  Plaintext K and V never leave registers.  A warp walks groups of
// R = 4 * 32 / NB rows (NB = hd / 4 Threefry blocks a row): lane l owns
// Threefry block c = l % NB of rows l / NB + (32 / NB) e, e < 4, of both K
// and V, so each lane runs 8 independent Threefry chains a group, which
// the scheduler interleaves; the group's ciphertext loads are issued
// first and land while the keystream is made.  (Copying the next group
// into a shared-memory ring with cp.async instead was measured slower: the
// loads were already hidden, and the kernel is bound by instruction issue,
// to which the copies and shared reads add.)  The lane's four K elements
// give partial dot products with its four elements of every query head;
// row_sums adds them over the NB lanes of each row in two halving steps
// and plain ones, leaving each lane the scores of one row, so the online
// softmax (max and sum per head, uniform across the warp) takes one
// exponential per lane and head.  One lane per row writes the row's
// weights to shared memory, and every lane accumulates p * v for its four
// V elements of its four rows.  Warps never wait for each other inside
// the loop: one warp's dot products and softmax run beside another's
// Threefry.  At the end the block merges its four warps through shared
// memory and writes one (acc, max, sum) partial per query head; the last
// block of each (b, k) to finish merges the splits into the output (one
// launch, no second kernel).  The wrapper sizes the split of T (whole
// groups of rows) from B * K * t_valid so that the grid is at most one
// wave of the blocks an SM holds at once (sealed_attention_blocks_per_sm).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kE = 4;              // rows of K and of V per lane per group
constexpr float kNeg = -1e30f;

// common.cuh's threefry2x32 with every add a + b written b * one + a, where
// ``one`` is a runtime 1 (a kernel argument) that the compiler cannot fold:
// the adds issue as IMAD on the FMA pipe beside the ALU pipe's rotates and
// XORs.  Same bits.
#define REPRO_IMAD_ROUND(r) \
  x0 = x1 * one + x0;       \
  x1 = repro::rotl32(x1, r); \
  x1 ^= x0;
__device__ __forceinline__ void threefry_imad(uint32_t k0, uint32_t k1,
                                              uint32_t& x0, uint32_t& x1,
                                              uint32_t one) {
  const uint32_t k2 = k0 ^ k1 ^ repro::kParity;
  const uint32_t inj[6][2] = {{k0, k1},      {k1, k2 + 1u}, {k2, k0 + 2u},
                              {k0, k1 + 3u}, {k1, k2 + 4u}, {k2, k0 + 5u}};
  x0 = inj[0][0] * one + x0;
  x1 = inj[0][1] * one + x1;
#pragma unroll
  for (int i = 1; i < 6; ++i) {
    if (i % 2) {
      REPRO_IMAD_ROUND(13) REPRO_IMAD_ROUND(15) REPRO_IMAD_ROUND(26)
      REPRO_IMAD_ROUND(6)
    } else {
      REPRO_IMAD_ROUND(17) REPRO_IMAD_ROUND(29) REPRO_IMAD_ROUND(16)
      REPRO_IMAD_ROUND(24)
    }
    x0 = inj[i][0] * one + x0;
    x1 = inj[i][1] * one + x1;
  }
}
#undef REPRO_IMAD_ROUND

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

// 2^x for x <= 0 (softmax weights), one MUFU.EX2: relative error ~2^-22
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bf16x4(uint32_t w0, uint32_t w1,
                                       float (&f)[4]) {
  f[0] = __uint_as_float(w0 << 16);
  f[1] = __uint_as_float(w0 & 0xFFFF0000u);
  f[2] = __uint_as_float(w1 << 16);
  f[3] = __uint_as_float(w1 & 0xFFFF0000u);
}

// Per-lane values x[e][w] of the kE rows a lane holds (rows rr + P e) to
// their sums over the NB lanes of each row: two halving steps split the
// rows between lane bits NB/2 and NB/4 (a lane keeps half and sends half),
// the remaining steps add.  Lane l is left with the sums of row
// e = 2 [l & NB/2] + [l & NB/4], 4 W + W log2(NB/4) shuffles in all.
template <int NB, int W, typename T, typename Op>
__device__ __forceinline__ void row_sums(const T (&x)[kE][W], T (&out)[W],
                                         int lane, Op op) {
  static_assert(kE == 4 && NB >= 4, "two halving steps over four rows");
  const bool u1 = lane & (NB / 2), u2 = lane & (NB / 4);
  T h[2][W];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const T send = u1 ? x[j][w] : x[j + 2][w];
      const T keep = u1 ? x[j + 2][w] : x[j][w];
      h[j][w] = op(keep, __shfl_xor_sync(0xFFFFFFFFu, send, NB / 2));
    }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const T send = u2 ? h[0][w] : h[1][w];
    const T keep = u2 ? h[1][w] : h[0][w];
    out[w] = op(keep, __shfl_xor_sync(0xFFFFFFFFu, send, NB / 4));
  }
#pragma unroll
  for (int o = NB / 8; o > 0; o >>= 1)
#pragma unroll
    for (int w = 0; w < W; ++w)
      out[w] = op(out[w], __shfl_xor_sync(0xFFFFFFFFu, out[w], o));
}

struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct AddMod {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return repro::addmod(a, b);
  }
};

// NB Threefry blocks a row (hd = 4 NB), G query heads a KV head (the real
// count Gr <= G; heads past it have a zero query and are not written).
template <int NB, int G>
__global__ void __launch_bounds__(kThreads, 4)
sealed_attention_split(const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ k_ct,
                       const uint16_t* __restrict__ v_ct,
                       const uint32_t* __restrict__ k_tags,
                       const uint32_t* __restrict__ v_tags,
                       const uint32_t* __restrict__ key_k,
                       const uint32_t* __restrict__ key_v,
                       const uint32_t* __restrict__ mkeys,
                       float* __restrict__ part,
                       __nv_bfloat16* __restrict__ out,
                       int* __restrict__ bad, int* __restrict__ sync,
                       int T, int K, int Gr, int t_valid, int chunk,
                       float scale, int verify, uint32_t one) {
  constexpr int HD = 4 * NB, P = 32 / NB, R = kE * P;
  __shared__ float acc_s[kWarps][G][HD];
  __shared__ float ml_s[kWarps][G][2];
  __shared__ float p_s[kWarps][R][G];    // a group's softmax weights
  __shared__ int bad_s, last_s;
  const int split = blockIdx.x, kk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % NB, rr = lane / NB;
  // the row of the group whose sums row_sums leaves in this lane
  const int e_own = 2 * ((lane & (NB / 2)) != 0) + ((lane & (NB / 4)) != 0);
  const int bk = b * K + kk;
  const int t0 = split * chunk;
  const int t_end = min(t0 + chunk, t_valid);
  if (threadIdx.x == 0) bad_s = 0;

  // this lane's four elements of every query head, in f32
  float qv[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint2 w = make_uint2(0u, 0u);
    if (g < Gr)
      w = *reinterpret_cast<const uint2*>(
          q + (static_cast<int64_t>(bk) * Gr + g) * HD + 4 * c);
    bf16x4(w.x, w.y, qv[g]);
    // scores in the log2 domain: q * hd^-0.5 * log2(e), then exp2
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[g][i] *= scale * 1.4426950408889634f;
  }
  const uint32_t kk0 = key_k[0], kk1 = key_k[1];
  const uint32_t vk0 = key_v[0], vk1 = key_v[1];
  uint32_t mk0 = 0, mk1 = 0, mkp = 0;
  if (verify) {
    mk0 = mkeys[2 * c];
    mk1 = mkeys[2 * c + 1];
    mkp = mkeys[0];
  }

  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  }
  int nbad = 0;

  // The lane's rows of a group are t_first + rr + P e; cache row (b, t, kk)
  // is row index (b T + t) K + kk, its counter row that index mod 2^32.
  // Pointers, tag index and counter row of row t_first + rr step by a
  // whole group of the block's warps.
  int t_first = t0 + warp * R;
  const int64_t first = (static_cast<int64_t>(b) * T + t_first + rr) * K + kk;
  const int64_t row_step = static_cast<int64_t>(P) * K;    // e to e + 1
  const int64_t group_step = static_cast<int64_t>(kWarps) * R * K;
  const uint2* kp = reinterpret_cast<const uint2*>(k_ct + first * HD) + c;
  const uint2* vp = reinterpret_cast<const uint2*>(v_ct + first * HD) + c;
  int64_t tag_i = first + e_own * row_step;
  uint32_t ctr = static_cast<uint32_t>(first);
  for (; t_first < t_end; t_first += kWarps * R, kp += group_step * NB,
       vp += group_step * NB, tag_i += group_step,
       ctr += static_cast<uint32_t>(group_step)) {
    // the loads first: the keystream does not depend on them, so their
    // latency hides behind its 2 kE independent Threefry chains; rows
    // past the split's end are not read
    uint2 ck[kE], cv[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      ck[e] = cv[e] = make_uint2(0u, 0u);
      if (t_first + rr + P * e < t_end) {
        ck[e] = __ldg(kp + e * row_step * NB);
        cv[e] = __ldg(vp + e * row_step * NB);
      }
    }
    const bool valid_own = t_first + rr + P * e_own < t_end;
    uint32_t tk = 0, tv = 0;
    if (verify && c % (NB / 4) == 0 && valid_own) {
      tk = __ldg(k_tags + tag_i);
      tv = __ldg(v_tags + tag_i);
    }
    uint32_t xk[kE][2], xv[kE][2];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const uint32_t row = ctr + static_cast<uint32_t>(e * row_step);
      xk[e][0] = xv[e][0] = row;
      xk[e][1] = xv[e][1] = static_cast<uint32_t>(c);
      threefry_imad(kk0, kk1, xk[e][0], xk[e][1], one);
      threefry_imad(vk0, vk1, xv[e][0], xv[e][1], one);
    }
    float s[kE][G];
    float vf[kE][4];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float kf[4];
      bf16x4(ck[e].x ^ xk[e][0], ck[e].y ^ xk[e][1], kf);
      bf16x4(cv[e].x ^ xv[e][0], cv[e].y ^ xv[e][1], vf[e]);
      if (t_first + rr + P * e >= t_end) {
        // a row past the split's end was not loaded: its "plaintext" is
        // keystream, which may be NaN; its weight is 0, its values too
#pragma unroll
        for (int i = 0; i < 4; ++i) vf[e][i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = qv[g][0] * kf[0];
        d = fmaf(qv[g][1], kf[1], d);
        d = fmaf(qv[g][2], kf[2], d);
        s[e][g] = fmaf(qv[g][3], kf[3], d);
      }
    }
    // scores: this lane's partial dot products added over the NB lanes
    // of each row; the lane is left with row e_own's scores of all heads
    float sc[G];
    row_sums<NB, G>(s, sc, lane, Add());
    // online softmax per head over the group's rows: max and sum over the
    // lane bits that tell the rows apart (NB/2, NB/4 and those >= NB)
    float a[G], pown[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = valid_own ? sc[g] : kNeg;
      float gm = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, NB / 2));
      gm = fmaxf(gm, __shfl_xor_sync(0xFFFFFFFFu, gm, NB / 4));
#pragma unroll
      for (int o = NB; o < 32; o <<= 1)
        gm = fmaxf(gm, __shfl_xor_sync(0xFFFFFFFFu, gm, o));
      const float mn = fmaxf(m[g], gm);
      a[g] = exp2_neg(m[g] - mn);
      pown[g] = valid_own ? exp2_neg(x - mn) : 0.f;
      float ps = pown[g] + __shfl_xor_sync(0xFFFFFFFFu, pown[g], NB / 2);
      ps += __shfl_xor_sync(0xFFFFFFFFu, ps, NB / 4);
#pragma unroll
      for (int o = NB; o < 32; o <<= 1)
        ps += __shfl_xor_sync(0xFFFFFFFFu, ps, o);
      l[g] = l[g] * a[g] + ps;
      m[g] = mn;
    }
    // the weights to the lanes that hold each row's V, through shared
    // memory: one writer per row, then every lane reads its rows'
    __syncwarp();
    if (c % (NB / 4) == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) p_s[warp][rr + P * e_own][g] = pown[g];
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] *= a[g];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float p = p_s[warp][rr + P * e][g];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(p, vf[e][i], acc[g][i]);
      }
    }
    if (verify) {
      // row tags: each lane's share, added over the NB lanes of the row;
      // one lane per row compares
      uint32_t tp[kE][2], ts[2];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        tp[e][0] = tag_part(ck[e], mk0, mk1);
        tp[e][1] = tag_part(cv[e], mk0, mk1);
      }
      row_sums<NB, 2>(tp, ts, lane, AddMod());
      if (c % (NB / 4) == 0 && valid_own) {
        const uint32_t row = static_cast<uint32_t>(tag_i);
        const uint32_t pos = repro::canon(row * repro::kPosMix);
        const uint32_t pterm = repro::mulmod(pos + 1u, mkp);
        nbad += (repro::canon(repro::addmod(ts[0], pterm)) != tk) +
                (repro::canon(repro::addmod(ts[1], pterm)) != tv);
      }
    }
  }

  // merge the lanes of a column (the P row sets), then the warps
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = NB; o < 32; o <<= 1)
        acc[g][i] += __shfl_xor_sync(0xFFFFFFFFu, acc[g][i], o);
  if (lane < NB) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_s[warp][g][4 * c + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ml_s[warp][g][0] = m[g];
      ml_s[warp][g][1] = l[g];
    }
  }
  if (verify && nbad) atomicAdd(&bad_s, nbad);
  __syncthreads();

  // partials: [B*K][n_split][Gr][HD + 2] = (acc..., max, sum), with the
  // max in the log2 domain
  float* pb = part + static_cast<int64_t>(bk) * n_split * Gr * (HD + 2);
  float* out_p = pb + static_cast<int64_t>(split) * Gr * (HD + 2);
  for (int o = threadIdx.x; o < Gr * HD; o += kThreads) {
    const int g = o / HD, d = o - g * HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[w][g][0]);
    float sa = 0.f, sl = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2_neg(ml_s[w][g][0] - mx);
      sa = fmaf(acc_s[w][g][d], a, sa);
      sl = fmaf(ml_s[w][g][1], a, sl);
    }
    out_p[g * (HD + 2) + d] = sa;
    if (d == 0) {
      out_p[g * (HD + 2) + HD] = mx;
      out_p[g * (HD + 2) + HD + 1] = sl;
    }
  }
  // The last block of this (b, k) to finish merges the splits: each block
  // publishes its partial and bad count, then takes a ticket; sync[2 bk]
  // counts the blocks, sync[2 bk + 1] their bad rows, and the last block
  // leaves both at zero for the next launch.  Every thread fences its
  // partial writes before the ticket; the ticket's taker fences after it,
  // and the barrier orders the last block's reads after that.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bad_s) atomicAdd(sync + 2 * bk + 1, bad_s);
    last_s = atomicAdd(sync + 2 * bk, 1) == n_split - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last_s) return;
  for (int o = threadIdx.x; o < Gr * HD; o += kThreads) {
    const int g = o / HD, d = o - g * HD;
    // one pass over the splits, rescaling the running sums to each new max
    float mx = kNeg, sl = 0.f, sa = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* ps = pb + (sp * Gr + g) * (HD + 2);
      const float m = __ldcg(ps + HD);
      const float mn = fmaxf(mx, m);
      const float a = exp2_neg(mx - mn), b = exp2_neg(m - mn);
      sl = sl * a + __ldcg(ps + HD + 1) * b;
      sa = sa * a + __ldcg(ps + d) * b;
      mx = mn;
    }
    out[static_cast<int64_t>(bk) * Gr * HD + o] =
        __float2bfloat16(sa / fmaxf(sl, 1e-30f));
  }
  if (threadIdx.x == 0) {
    bad[bk] = atomicExch(sync + 2 * bk + 1, 0);
    sync[2 * bk] = 0;
  }
}

#define REPRO_SHAPES(X)                                                      \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(16, 1) X(16, 2) X(16, 4)       \
  X(16, 8) X(16, 16) X(32, 1) X(32, 2) X(32, 4) X(32, 8) X(32, 16)

int group_pad(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : 16;
}

template <int NB, int G>
cudaError_t launch_split(dim3 grid, cudaStream_t s, const void* q,
                         const void* k_ct, const void* v_ct,
                         const void* k_tags, const void* v_tags,
                         const void* key_k, const void* key_v,
                         const void* mkeys, void* part, void* out, void* bad,
                         void* sync, int T, int K, int Gr, int t_valid,
                         int chunk, float scale, int verify) {
  sealed_attention_split<NB, G><<<grid, kThreads, 0, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k_ct),
      static_cast<const uint16_t*>(v_ct), static_cast<const uint32_t*>(k_tags),
      static_cast<const uint32_t*>(v_tags),
      static_cast<const uint32_t*>(key_k), static_cast<const uint32_t*>(key_v),
      static_cast<const uint32_t*>(mkeys), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(out), static_cast<int*>(bad),
      static_cast<int*>(sync), T, K, Gr, t_valid, chunk, scale, verify, 1u);
  return cudaGetLastError();
}

}  // namespace

// q: bf16 bits [B, K, G, hd]; k_ct, v_ct: bf16 bits [B, T, K, hd], 8-byte
// aligned; k_tags, v_tags: uint32 [B, T, K] (read only when verify);
// key_k, key_v: uint32[2] tensor keys; mkeys: uint32[hd / 2] canonical MAC
// keys (read only when verify); out: bf16 [B, K, G, hd]; bad: int32 [B,
// K]; part: f32 scratch of B*K*n_split*G*(hd + 2); sync: int32 [2 B K],
// zero before the launch and left zero by it.
// hd is 32, 64 or 128 and G <= 16; 0 <= t_valid <= T; the split of T is
// n_split = max(1, ceil(t_valid / chunk)) blocks of ``chunk`` rows.
// Returns the launch's CUDA error.
extern "C" int sealed_attention_launch(
    const void* q, const void* k_ct, const void* v_ct, const void* k_tags,
    const void* v_tags, const void* key_k, const void* key_v,
    const void* mkeys, void* out, void* bad, void* part, void* sync, int B,
    int T, int K, int G, int hd, int t_valid, int chunk, int n_split,
    float scale, int verify, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_split, K, B);
  const int gp = group_pad(G);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_SPLIT(NB_, G_)                                                  \
  if (hd == 4 * NB_ && gp == G_)                                              \
    err = launch_split<NB_, G_>(grid, s, q, k_ct, v_ct, k_tags, v_tags,       \
                                key_k, key_v, mkeys, part, out, bad, sync, T, \
                                K, G, t_valid, chunk, scale, verify);
  REPRO_SHAPES(REPRO_SPLIT)
#undef REPRO_SPLIT
  return static_cast<int>(err);
}

// Blocks of the split kernel an SM holds at once for head_dim hd and G
// query heads a KV head (0 for a shape the kernel does not take), from the
// CUDA occupancy calculator: the wrapper sizes its grid by it.
extern "C" int sealed_attention_blocks_per_sm(int hd, int G) {
  const int gp = group_pad(G);
  int n = 0;
#define REPRO_OCC(NB_, G_)                                                    \
  if (hd == 4 * NB_ && gp == G_)                                              \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                            \
        &n, sealed_attention_split<NB_, G_>, kThreads, 0);
  REPRO_SHAPES(REPRO_OCC)
#undef REPRO_OCC
  return n;
}
