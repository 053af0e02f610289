// RWKV-6's WKV recurrence as a chunked scan: a forward and a backward,
// three kernels each per layer call.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// device-side jax.lax.scan (src/repro/models/rwkv.py:141-152).  Per (b, h),
// with the float32 state S [64, 64] and the log decay lw_t [64], one a
// channel (the decay is w_t = exp(lw_t)):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// kernels/wkv6_scan/ref.py holds the per-token loop and this file's
// algorithm in plain torch.
//
// The algorithm, over chunks of kL = 64 tokens (also the checkpoint
// interval), each of four sub-chunks of kSub = 16.  With S0 the state before
// the chunk:
//     y_t    = (r_t o e^{lw_0 + .. + lw_{t-1}})^T S0 + sum_{s<=t} A[t,s] v_s
//     A[t,s] = sum_i r_t[i] k_s[i] e^{lw_{s+1} + .. + lw_{t-1}}[i]  (s < t)
//     A[t,t] = sum_i r_t[i] u[i] k_t[i]
//     S_end  = diag(e^{lw_0 + .. + lw_63}) S0 + kappa^T V,
//     kappa_s = k_s o e^{lw_{s+1} + .. + lw_63}
// Every exponent is a running sum of lw over the tokens it spans, never a
// difference of two cumulative sums (which loses the small terms and gives
// -inf - -inf), so each factor is <= 1 and can only underflow: lw <= -104
// or -inf gives exact zeros.  The decay is per channel, so A's intra-chunk
// decay is a [t, s, i] tensor; folding it into r and k over the whole chunk
// overflows (lw -7 over 64 tokens is e^448).  Inside a sub-chunk (A's four
// diagonal 16 x 16 blocks, intra_blocks) it is taken channel by channel.
// Between sub-chunks, for t in sub-chunk T and s in an earlier q, it splits
// at the sub-chunks' edges into R~_t = r_t o e^{pre_t} (from T's start to t
// - 1), K^_s = k_s o e^{suf_s} (from s + 1 to q's end) and g[q][T] =
// e^{sum of the whole sub-chunks between}, so the block is the product R~
// diag(g[q][T]) K^^T, g applied as the operand is read (ScaleK, ScaleN).
// Forward: (1) wkv6_local_kernel<false> forms every chunk's kappa^T V and
// its decay, a channel, in parallel over (chunk, head, b); (2)
// wkv6_carry_kernel walks the chunks in order, S0 <- diag(dec) S0 + kappa^T
// V, one thread a state entry, writing the state before every chunk (the
// checkpoints, [B, ceil(S/64), H, 64, 64], scratch when the caller keeps
// none) and the final state; (3) wkv6_output_kernel forms Y in parallel
// over (chunk, head, b).
// Backward, from the checkpoints, with G the gradient of the chunk's end
// state and dA = dY V^T:
//     G_before = diag(dec) G + Q^T dY, Q = r o e^{lw_0 + .. + lw_{t-1}}
//                                                        (1), (2) reversed
//     dv = A^T dY + kappa G                                          (3)
//     dr, dk: the state terms (dY S0^T, V G^T), dA's blocks (through K^,
//             R~ and g between sub-chunks, channel by channel inside) and
//             the bonus; du one partial a chunk
//     dlw_m = the sum over every exponent whose span holds m of its term's
//             gradient times the term, as running sums: the state terms'
//             over t > m and s < m, the end decay's, the spans through m's
//             whole sub-chunk (Theta, read off X = dA K^ diag(g) part way),
//             those that start or end in it, and those inside it
// No division anywhere, and no difference of two sums of terms.
//
// What bounds it on the H100: the function's own work is 7 float32 FLOPs a
// state entry a token forward and 14 backward (ops.py), 0.070 and 0.140 ms
// at the float32 rate for rwkv6-3b's layer of 4096 tokens, more than its
// bytes take; the chunked form does about 3 and 6 products of 64 x 64 x 64
// a (chunk, head) instead, with every token of a chunk in flight at once,
// and moves the chunk states through device memory three times.  Products
// run as in ssd_scan.cu (scan.cuh's gemm: 4 x 4 FFMA register tiles from
// row-swizzled shared-memory tiles); the per-channel passes (Chan) give a
// thread one channel of one sub-chunk, a warp 32 channels, so its reads of
// a row are conflict-free.  Grids are (chunks, H, B): 2560 blocks for one
// 4096-token sequence of rwkv6-3b.  wkv6_output_kernel holds 6 tiles, two
// blocks an SM; wkv6_grad_kernel 11 tiles, 187 KB, one.  Every sum runs in
// a fixed order and du comes back one partial a chunk: no atomics, so two
// runs agree bit for bit.
#include "scan.cuh"

namespace {

using namespace repro::scan;

constexpr int kSub = 16;                       // tokens a sub-chunk
constexpr int kNSub = kL / kSub;               // sub-chunks a chunk
constexpr int kG = kNSub * (kNSub + 1) * kD;   // g[q][T][i], q < T <= 4
constexpr int kChans = kNSub * kD;             // one float a (sub-chunk, i)

// dynamic shared memory of each kernel, in floats
constexpr int kLocalSmem = 3 * kTile + kChans;
constexpr int kOutSmem = 6 * kTile + kG + kChans + kD;
constexpr int kGradSmem = 11 * kTile + kG + 5 * kChans + 3 * kD + kD;

// The per-channel passes: warp w holds sub-chunk q = w / 2 (tokens t0 ..
// t0+15), its lanes channels 32(w%2) .. +31, a thread channel i.
struct Chan {
  int q, i, t0;
  __device__ Chan() {
    const int warp = threadIdx.x >> 5;
    q = warp >> 1;
    i = 32 * (warp & 1) + (threadIdx.x & 31);
    t0 = kSub * q;
  }
  // the thread's 16 entries of a tile's column i
  __device__ void load(float (&x)[kSub], const float* t) const {
#pragma unroll
    for (int j = 0; j < kSub; ++j) x[j] = t[sw(t0 + j, i)];
  }
  // a[j] e[j] into the same entries
  __device__ void store(float* t, const float (&a)[kSub],
                        const float (&e)[kSub]) const {
#pragma unroll
    for (int j = 0; j < kSub; ++j) t[sw(t0 + j, i)] = a[j] * e[j];
  }
  // the sum of sub-chunks [lo, hi) of the channel's per-sub-chunk values
  __device__ float sum(const float* per, int lo, int hi) const {
    float s = 0.f;
    for (int p = lo; p < hi; ++p) s += per[p * kD + i];
    return s;
  }
};

// e[j] = exp(base + the running sum of lw over the sub-chunk's tokens
// before j (kPrefix) or after it)
template <bool kPrefix>
__device__ __forceinline__ void exp_runs(float (&e)[kSub],
                                         const float (&lw)[kSub],
                                         float base) {
  float run = base;
#pragma unroll
  for (int jj = 0; jj < kSub; ++jj) {
    const int j = kPrefix ? jj : kSub - 1 - jj;
    e[j] = expf(run);
    run += lw[j];
  }
}

__device__ __forceinline__ float sum16(const float (&lw)[kSub]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kSub; ++j) s += lw[j];
  return s;
}

// The operand b of gemm times a multiplier a step k (a channel of the sum):
// b[kk][j] *= p[k + kk].
struct ScaleK {
  static constexpr bool kNone = false;
  const float* p;
  __device__ void operator()(int k, float (&b)[4][4]) const {
    const float4 g = *reinterpret_cast<const float4*>(p + k);
    const float m[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) b[kk][j] *= m[kk];
  }
};

// ... or a multiplier a column (a channel of the output), from the row of
// p that the step's sub-chunk picks: b[kk][j] *= p[(k / 16) * stride + j].
struct ScaleN {
  static constexpr bool kNone = false;
  const float* p;
  int stride;
  __device__ void operator()(int k, float (&b)[4][4]) const {
    const float4 g =
        *reinterpret_cast<const float4*>(p + (k >> 4) * stride);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      b[kk][0] *= g.x; b[kk][1] *= g.y; b[kk][2] *= g.z; b[kk][3] *= g.w;
    }
  }
};

__device__ __forceinline__ const float* g_row(const float* sg, int q, int T) {
  return sg + (q * (kNSub + 1) + T) * kD;
}

// A's diagonal blocks: A[t][s] for s < t inside each sub-chunk, the decay
// taken channel by channel as a running sum over t, and the bonus A[t][t].
// Warp w: sub-chunk w / 2, the columns s of w's parity; a lane channels
// lane and lane + 32, the sum over channels a warp's.
__device__ __forceinline__ void intra_blocks(float* sa, const float* sr,
                                             const float* sk,
                                             const float* slw,
                                             const float* su) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = kSub * (warp >> 1);
  const float u0 = su[lane], u1 = su[lane + 32];
  for (int s = t0 + (warp & 1); s < t0 + kSub; s += 2) {
    const float k0 = sk[sw(s, lane)], k1 = sk[sw(s, lane + 32)];
    const float b = warp_sum(fmaf(sr[sw(s, lane)] * u0, k0,
                                  sr[sw(s, lane + 32)] * u1 * k1));
    if (lane == 0) sa[sw(s, s)] = b;
    float run0 = 0.f, run1 = 0.f;   // lw_{s+1} + .. + lw_{t-1}
    for (int t = s + 1; t < t0 + kSub; ++t) {
      const float p = warp_sum(fmaf(sr[sw(t, lane)] * k0, expf(run0),
                                    sr[sw(t, lane + 32)] * k1 * expf(run1)));
      if (lane == 0) sa[sw(t, s)] = p;
      run0 += slw[sw(t, lane)];
      run1 += slw[sw(t, lane + 32)];
    }
  }
}

// The channel's g[q][T] for its own sub-chunk q and every T > q: exp of the
// whole sub-chunks strictly between, T = 4 the chunk's end.
__device__ __forceinline__ void write_g(float* sg, const float* stot,
                                       const Chan& ch) {
  float run = 0.f;
  for (int T = ch.q + 1; T <= kNSub; ++T) {
    sg[(ch.q * (kNSub + 1) + T) * kD + ch.i] = expf(run);
    if (T < kNSub) run += stot[T * kD + ch.i];
  }
}

// A's blocks between sub-chunks, R~ diag(g[q][T]) K^^T, into sa: a warp's
// rows lie in sub-chunk T = w / 2, a thread's columns in q = tx / 4; only
// q < T.
__device__ __forceinline__ void inter_blocks(float* sa, const float* srt,
                                             const float* skh,
                                             const float* sg, const Place& pl,
                                             int n) {
  const int T = pl.wr / kSub, q = pl.tx / 4;
  if (q >= T || pl.wr >= n) return;
  float acc[4][4];
  zero(acc);
  // a(t, i) = R~[t][i], b(i, s) = K^[s][i] g[q][T][i]
  gemm<true, true>(acc, srt, skh, pl, 0, kD, ScaleK{g_row(sg, q, T)});
  store_tile(sa, acc, pl);
}

// Phase (1) of both directions: each chunk's own part of the carried
// matrix,
//   forward:  kappa^T V, kappa_s = k_s o e^{lw_{s+1} + .. + lw_63}
//   backward: Q^T dY,    Q_t     = r_t o e^{lw_0 + .. + lw_{t-1}}
// into slot c+1 (forward) or c-1 (backward) of buf [B, nch, H, 64, 64], or
// into edge [B, H, 64, 64] (s_out, ds0) where that slot is past the end;
// and the chunk's decay, e^{lw_0 + .. + lw_63} a channel, into dec [B, nch,
// H, 64].  x is k or r, y is v or dy.
template <bool kRev>
__global__ void __launch_bounds__(kT)
    wkv6_local_kernel(const float* __restrict__ lw,
                      const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ buf,
                      float* __restrict__ edge, float* __restrict__ dec,
                      int S, int H) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;               // x, then kappa or Q
  float* sy = sx + kTile;         // v or dy
  float* slw = sy + kTile;        // lw
  float* stot = slw + kTile;      // each sub-chunk's sum of lw
  const Place pl;
  const Chan ch;
  const int c = blockIdx.x, nch = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int n = min(kL, S - c * kL), kn = (n + 3) & ~3;
  const int64_t ld = static_cast<int64_t>(H) * kD;
  const int64_t at = (static_cast<int64_t>(b) * S + c * kL) * ld + h * kD;
  for (int i = threadIdx.x; i < kLocalSmem; i += kT) smem[i] = 0.f;
  __syncthreads();
  stage(sx, x + at, ld, n, kD);
  stage(sy, y + at, ld, n, kD);
  stage(slw, lw + at, ld, n, kD);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float l[kSub], e[kSub], xs[kSub];
  ch.load(l, slw);
  stot[ch.q * kD + ch.i] = sum16(l);
  __syncthreads();
  // kappa: the sub-chunks after the thread's, then back to s + 1; Q: those
  // before, then on to t - 1
  exp_runs<kRev>(e, l, kRev ? ch.sum(stot, 0, ch.q)
                            : ch.sum(stot, ch.q + 1, kNSub));
  ch.load(xs, sx);
  ch.store(sx, xs, e);
  if (ch.q == 0)
    dec[((static_cast<int64_t>(b) * nch + c) * H + h) * kD + ch.i] =
        expf(ch.sum(stot, 0, kNSub));
  __syncthreads();
  float acc[4][4];
  zero(acc);
  // a(i, s) = x[s][i], b(s, j) = y[s][j]
  gemm<false, false>(acc, sx, sy, pl, 0, kn);
  const int dst = kRev ? c - 1 : c + 1;
  float* out = dst >= 0 && dst < nch
      ? buf + ((static_cast<int64_t>(b) * nch + dst) * H + h) * kTile
      : edge + (static_cast<int64_t>(b) * H + h) * kTile;
  store_global(out, kD, kD, kD, acc, pl);
}

// Phase (2): scan::carry with one decay a row of the state.
template <bool kRev>
__global__ void __launch_bounds__(kT)
    wkv6_carry_kernel(const float* __restrict__ start, float* buf,
                      float* edge, const float* __restrict__ dec, int nch,
                      int H, int64_t total) {
  carry<kRev, kD>(start, buf, edge, dec, nch, H, kTile, total);
}

// cp.async u's head row into su
__device__ __forceinline__ void stage_u(float* su, const float* u, int h) {
  if (threadIdx.x < kD / 4)
    cp_async16(su + 4 * threadIdx.x, u + h * kD + 4 * threadIdx.x);
}

// Phase (3) forward: Y = Q S0 + A V for one chunk of one head, S0 the
// chunk's slot of ck.
__global__ void __launch_bounds__(kT, 2)
    wkv6_output_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lw,
                       const float* __restrict__ u,
                       const float* __restrict__ ck, float* __restrict__ y,
                       int S, int H) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;               // r, then Q
  float* sk = sr + kTile;         // k, then K^
  float* slw = sk + kTile;        // lw, then R~
  float* sv = slw + kTile;        // v
  float* sh = sv + kTile;         // S0
  float* sa = sh + kTile;         // A
  float* sg = sa + kTile;         // g[q][T]
  float* stot = sg + kG;          // each sub-chunk's sum of lw
  float* su = stot + kChans;      // u
  const Place pl;
  const Chan ch;
  const int c = blockIdx.x, nch = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  // tokens past n are zeros: a warp whose rows lie past them skips its
  // products, and sums over tokens stop at n rounded up to 4 (a short last
  // chunk, a decode step's one token)
  const int n = min(kL, S - c * kL), kn = (n + 3) & ~3;
  const bool live = pl.wr < n;
  const int64_t ld = static_cast<int64_t>(H) * kD;
  const int64_t at = (static_cast<int64_t>(b) * S + c * kL) * ld + h * kD;
  for (int i = threadIdx.x; i < kOutSmem; i += kT) smem[i] = 0.f;
  __syncthreads();
  stage(sr, r + at, ld, n, kD);
  stage(sk, k + at, ld, n, kD);
  stage(slw, lw + at, ld, n, kD);
  stage(sv, v + at, ld, n, kD);
  stage(sh, ck + ((static_cast<int64_t>(b) * nch + c) * H + h) * kTile, kD,
        kD, kD);
  stage_u(su, u, h);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  intra_blocks(sa, sr, sk, slw, su);
  float l[kSub], rr[kSub], kk[kSub], e[kSub];
  ch.load(l, slw);
  ch.load(rr, sr);
  ch.load(kk, sk);
  stot[ch.q * kD + ch.i] = sum16(l);
  __syncthreads();
  // Q, K^, R~ in place of r, k, lw (each thread its own entries)
  exp_runs<true>(e, l, ch.sum(stot, 0, ch.q));
  ch.store(sr, rr, e);
  exp_runs<false>(e, l, 0.f);
  ch.store(sk, kk, e);
  exp_runs<true>(e, l, 0.f);
  ch.store(slw, rr, e);
  write_g(sg, stot, ch);
  __syncthreads();
  inter_blocks(sa, slw, sk, sg, pl, n);
  __syncthreads();
  float acc[4][4];
  zero(acc);
  if (live) {
    // Q S0: a(t, i) = Q[t][i], b(i, j) = S0[i][j]
    gemm<true, false>(acc, sr, sh, pl, 0, kD);
    // + A V over s <= t: a(t, s) = A[t][s], b(s, j) = V[s][j]
    gemm<true, false>(acc, sa, sv, pl, 0, min(pl.wr + 16, kn));
  }
  store_global(y + at, ld, n, kD, acc, pl);
}

// Theta's part of the warp's rows t: sum over them of R~[t][i] acc[t][i],
// for the thread's columns i, into part[i] (one writer a column).
__device__ __forceinline__ void theta_part(float* part, const float* srt,
                                           const float (&acc)[4][4],
                                           const Place& pl) {
  float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 m = ld4(srt, 4 * pl.ty + i, 4 * pl.tx);
    z[0] = fmaf(m.x, acc[i][0], z[0]);
    z[1] = fmaf(m.y, acc[i][1], z[1]);
    z[2] = fmaf(m.z, acc[i][2], z[2]);
    z[3] = fmaf(m.w, acc[i][3], z[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    z[j] += __shfl_xor_sync(kAll, z[j], 8);
    z[j] += __shfl_xor_sync(kAll, z[j], 16);
  }
  if ((threadIdx.x & 31) < 8)
    *reinterpret_cast<float4*>(part + 4 * pl.tx) =
        make_float4(z[0], z[1], z[2], z[3]);
}

// Phase (3) backward: dr, dk, dv, dlw and du's partial for one chunk of one
// head; S0 and G (the gradient of the chunk's end state) from the chunk's
// slots of ck and gb.
__global__ void __launch_bounds__(kT, 1)
    wkv6_grad_kernel(const float* __restrict__ r,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ ck,
                     const float* __restrict__ dy,
                     const float* __restrict__ gb, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dlw, float* __restrict__ du, int S,
                     int H) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;               // r
  float* sk = sr + kTile;         // k
  float* slw = sk + kTile;        // lw
  float* sv = slw + kTile;        // v, then dk's part between sub-chunks
  float* sdy = sv + kTile;        // dy, then X = dA K^ diag(g)
  float* sh = sdy + kTile;        // S0, then dY S0^T
  float* sG = sh + kTile;         // G, then V G^T
  float* sa = sG + kTile;         // A
  float* sd = sa + kTile;         // dA = dY V^T on and below the diagonal
  float* srt = sd + kTile;        // R~
  float* skh = srt + kTile;       // K^
  float* sg = skh + kTile;        // g[q][T]
  float* stot = sg + kG;          // each sub-chunk's sum of lw
  float* sgh = stot + kChans;     // <G, S0> of a row, a sub-chunk's part
  float* srho = sgh + kChans;     // r o dr's state part, a sub-chunk's sum
  float* skap = srho + kChans;    // k o dk's state part, a sub-chunk's sum
  float* sdu = skap + kChans;     // du's part, a sub-chunk's
  float* sz = sdu + kChans;       // Theta's parts: T 2 and 3 for q 1, 3 for 2
  float* su = sz + 3 * kD;        // u
  const Place pl;
  const Chan ch;
  const int c = blockIdx.x, nch = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  // as in wkv6_output_kernel: warps past the chunk's n tokens skip
  const int n = min(kL, S - c * kL), kn = (n + 3) & ~3;
  const bool live = pl.wr < n;
  const int64_t ld = static_cast<int64_t>(H) * kD;
  const int64_t at = (static_cast<int64_t>(b) * S + c * kL) * ld + h * kD;
  const int64_t slot = ((static_cast<int64_t>(b) * nch + c) * H + h) * kTile;
  for (int i = threadIdx.x; i < kGradSmem; i += kT) smem[i] = 0.f;
  __syncthreads();
  stage(sr, r + at, ld, n, kD);
  stage(sk, k + at, ld, n, kD);
  stage(slw, lw + at, ld, n, kD);
  stage(sv, v + at, ld, n, kD);
  stage(sdy, dy + at, ld, n, kD);
  stage(sh, ck + slot, kD, kD, kD);
  stage(sG, gb + slot, kD, kD, kD);
  stage_u(su, u, h);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  intra_blocks(sa, sr, sk, slw, su);
  float l[kSub], rr[kSub], kk[kSub], e[kSub], x[kSub];
  ch.load(l, slw);
  stot[ch.q * kD + ch.i] = sum16(l);
  {
    float gh = 0.f;  // row i of G and S0, the sub-chunk's 16 columns
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      gh = fmaf(sG[sw(ch.i, ch.t0 + j)], sh[sw(ch.i, ch.t0 + j)], gh);
    sgh[ch.q * kD + ch.i] = gh;
  }
  float acc[4][4];
  // dA = dY V^T on and below the diagonal: a(t, j) = dY[t][j], b(j, s) =
  // V[s][j]
  zero(acc);
  if (!pl.upper() && live) gemm<true, true>(acc, sdy, sv, pl, 0, kD);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * pl.tx + j > 4 * pl.ty + i) acc[i][j] = 0.f;
  store_tile(sd, acc, pl);
  __syncthreads();
  ch.load(rr, sr);
  ch.load(kk, sk);
  exp_runs<true>(e, l, 0.f);
  ch.store(srt, rr, e);
  exp_runs<false>(e, l, 0.f);
  ch.store(skh, kk, e);
  write_g(sg, stot, ch);
  __syncthreads();
  inter_blocks(sa, srt, skh, sg, pl, n);
  __syncthreads();
  const int T = pl.wr / kSub;   // the sub-chunk of the warp's rows
  {
    // dv = A^T dY + kappa G, kappa_s = K^_s o g[s's sub-chunk][4]
    zero(acc);
    if (live) {
      // a(s, t) = A[t][s], b(t, j) = dY[t][j] over t >= s
      gemm<false, false>(acc, sa, sdy, pl, pl.wr, kn);
      // a(s, i) = K^[s][i], b(i, j) = G[i][j] g[T][4][i]
      gemm<true, false>(acc, skh, sG, pl, 0, kD,
                        ScaleK{g_row(sg, T, kNSub)});
    }
    store_global(dv + at, ld, n, kD, acc, pl);
    float acc2[4][4], acc3[4][4];
    zero(acc2);
    zero(acc3);
    if (live) {
      // dY S0^T: a(t, j) = dY[t][j], b(j, i) = S0[i][j]
      gemm<true, true>(acc2, sdy, sh, pl, 0, kD);
      // V G^T: a(s, j) = V[s][j], b(j, i) = G[i][j]
      gemm<true, true>(acc3, sv, sG, pl, 0, kD);
    }
    __syncthreads();
    store_tile(sh, acc2, pl);
    store_tile(sG, acc3, pl);
  }
  // X = dA K^ diag(g) between sub-chunks: a(t, s) = dA[t][s], b(s, i) =
  // K^[s][i] g[s's sub-chunk][T][i]; part way (s < 16, s < 32) it gives
  // Theta's parts
  zero(acc);
  if (live) {
    for (int p = 0; p < T; ++p) {
      gemm<true, false>(acc, sd, skh, pl, kSub * p, kSub * (p + 1),
                        ScaleN{sg + T * kD + 4 * pl.tx, (kNSub + 1) * kD});
      if (p == 0 && T >= 2) theta_part(sz + (T - 2) * kD, srt, acc, pl);
      if (p == 1 && T == 3) theta_part(sz + 2 * kD, srt, acc, pl);
    }
  }
  store_tile(sdy, acc, pl);
  // dk's part between sub-chunks: a(s, t) = dA[t][s], b(t, i) = R~[t][i]
  // g[T][t's sub-chunk][i] over the later sub-chunks
  zero(acc);
  if (live)
    gemm<false, false>(acc, sd, srt, pl, kSub * (T + 1), kn,
                       ScaleN{g_row(sg, T, 0) + 4 * pl.tx, kD});
  store_tile(sv, acc, pl);
  __syncthreads();
  // The per-channel pass: dr, dk, dlw of the thread's 16 tokens.
  float gr[kSub], gk[kSub], gl[kSub];
  const float dec_all = expf(ch.sum(stot, 0, kNSub));
  const float ui = su[ch.i];
  {
    // the state terms: dr = e^{lw_0 + .. + lw_{t-1}} dY S0^T, dk =
    // e^{lw_{s+1} + .. + lw_63} V G^T
    exp_runs<true>(e, l, ch.sum(stot, 0, ch.q));
    ch.load(gr, sh);
    exp_runs<false>(x, l, ch.sum(stot, ch.q + 1, kNSub));
    ch.load(gk, sG);
    float rho = 0.f, kap = 0.f, dup = 0.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      gr[j] *= e[j];
      gk[j] *= x[j];
      rho = fmaf(rr[j], gr[j], rho);
      kap = fmaf(kk[j], gk[j], kap);
      dup = fmaf(sd[sw(ch.t0 + j, ch.t0 + j)] * rr[j], kk[j], dup);
    }
    srho[ch.q * kD + ch.i] = rho;
    skap[ch.q * kD + ch.i] = kap;
    sdu[ch.q * kD + ch.i] = dup;
  }
  __syncthreads();
  {
    // what every dlw of the sub-chunk gets: the end decay's term, the
    // spans through the whole sub-chunk, the state terms of the other
    // sub-chunks
    float base = dec_all * ch.sum(sgh, 0, kNSub);
    if (ch.q == 1) base += sz[ch.i] + sz[kD + ch.i];
    if (ch.q == 2) base += sz[2 * kD + ch.i];
    float after = base + ch.sum(srho, ch.q + 1, kNSub);
    float before = ch.sum(skap, 0, ch.q);
    // + the parts between sub-chunks: dr's through e^{pre}, dk's through
    // e^{suf}
    exp_runs<true>(e, l, 0.f);
    exp_runs<false>(x, l, 0.f);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      gr[j] = fmaf(e[j], sdy[sw(ch.t0 + j, ch.i)], gr[j]);
      gk[j] = fmaf(x[j], sv[sw(ch.t0 + j, ch.i)], gk[j]);
    }
    // dlw_m: r o dr over t > m and k o dk over s < m (the state terms over
    // the chunk, the parts between sub-chunks over the sub-chunk)
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) {
      const int j = kSub - 1 - jj;
      gl[j] = after;
      after = fmaf(rr[j], gr[j], after);
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      gl[j] += before;
      before = fmaf(kk[j], gk[j], before);
    }
  }
  // inside the sub-chunk, channel by channel: for each s, the running decay
  // e^{lw_{s+1} + .. + lw_{t-1}} over t > s; dlw_m gets the spans s < m < t
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    float run = 0.f, p[kSub];
#pragma unroll
    for (int t = s + 1; t < kSub; ++t) {
      const float a = sd[sw(ch.t0 + t, ch.t0 + s)] * expf(run);
      gr[t] = fmaf(a, kk[s], gr[t]);
      gk[s] = fmaf(a, rr[t], gk[s]);
      p[t] = a * rr[t] * kk[s];
      run += l[t];
    }
    float suf = 0.f;
#pragma unroll
    for (int m = kSub - 1; m > s; --m) {
      gl[m] += suf;
      suf += p[m];
    }
  }
  // the bonus, and the outputs
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float db = sd[sw(ch.t0 + j, ch.t0 + j)] * ui;
    gr[j] = fmaf(db, kk[j], gr[j]);
    gk[j] = fmaf(db, rr[j], gk[j]);
    if (ch.t0 + j < n) {
      const int64_t o = at + (ch.t0 + j) * ld + ch.i;
      dr[o] = gr[j];
      dk[o] = gk[j];
      dlw[o] = gl[j];
    }
  }
  if (ch.q == 0)
    du[((static_cast<int64_t>(b) * nch + c) * H + h) * kD + ch.i] =
        ch.sum(sdu, 0, kNSub);
}

int set_smem(const void* fn, int floats) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      floats * static_cast<int>(sizeof(float))));
}

// once a process, before any graph capture: the kernels' shared memory
int smem_attributes() {
  static const int err = [] {
    const void* fns[] = {
        reinterpret_cast<const void*>(wkv6_local_kernel<false>),
        reinterpret_cast<const void*>(wkv6_local_kernel<true>),
        reinterpret_cast<const void*>(wkv6_output_kernel),
        reinterpret_cast<const void*>(wkv6_grad_kernel)};
    const int floats[] = {kLocalSmem, kLocalSmem, kOutSmem, kGradSmem};
    for (int i = 0; i < 4; ++i) {
      const int e = set_smem(fns[i], floats[i]);
      if (e) return e;
    }
    return 0;
  }();
  return err;
}

// What a launch used, in the kPlanInts ints at plan (host memory): threads
// a block, then the grid (x, y, z) of each of the call's three kernels in
// launch order: the chunk kernel, the carry (one thread a state entry) and
// the chunk kernel of outputs or gradients.
constexpr int kPlanInts = 10;

void write_plan(int* plan, dim3 chunks, int carry) {
  const int v[kPlanInts] = {
      kT,
      static_cast<int>(chunks.x), static_cast<int>(chunks.y),
      static_cast<int>(chunks.z), carry, 1, 1,
      static_cast<int>(chunks.x), static_cast<int>(chunks.y),
      static_cast<int>(chunks.z)};
  for (int i = 0; i < kPlanInts; ++i) plan[i] = v[i];
}

}  // namespace

// Forward: y, s_out, the state before every chunk (ck [B, nch, H, 64, 64],
// the checkpoints) and each chunk's decay a channel (dec [B, nch, H, 64])
// from r, k, v, lw, u and s0.  plan (host memory, kPlanInts): what the
// launch used, see write_plan.
extern "C" int wkv6_forward_launch(const float* r, const float* k,
                                   const float* v, const float* lw,
                                   const float* u, const float* s0, float* y,
                                   float* s_out, float* ck, float* dec,
                                   int* plan, int B, int S, int H,
                                   cudaStream_t s) {
  if (int err = smem_attributes()) return err;
  const int nch = (S + kL - 1) / kL;
  const dim3 grid(nch, H, B);
  const int64_t total = static_cast<int64_t>(B) * H * kTile;
  const int carry = static_cast<int>((total + kT - 1) / kT);
  write_plan(plan, grid, carry);
  wkv6_local_kernel<false><<<grid, kT, kLocalSmem * sizeof(float), s>>>(
      lw, k, v, ck, s_out, dec, S, H);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  wkv6_carry_kernel<false><<<carry, kT, 0, s>>>(s0, ck, s_out, dec, nch, H,
                                                total);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  wkv6_output_kernel<<<grid, kT, kOutSmem * sizeof(float), s>>>(
      r, k, v, lw, u, ck, y, S, H);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dr, dk, dv, dlw, du one partial a chunk [B, nch, H, 64] and ds0
// from the forward's inputs, its checkpoints ck, dy and ds; gb [B, nch, H,
// 64, 64] (the gradient of every chunk's end state) and dec are scratch;
// plan as the forward's.
extern "C" int wkv6_backward_launch(const float* r, const float* k,
                                    const float* v, const float* lw,
                                    const float* u, const float* ck,
                                    const float* dy, const float* ds,
                                    float* dr, float* dk, float* dv,
                                    float* dlw, float* du, float* ds0,
                                    float* gb, float* dec, int* plan, int B,
                                    int S, int H, cudaStream_t s) {
  if (int err = smem_attributes()) return err;
  const int nch = (S + kL - 1) / kL;
  const dim3 grid(nch, H, B);
  const int64_t total = static_cast<int64_t>(B) * H * kTile;
  const int carry = static_cast<int>((total + kT - 1) / kT);
  write_plan(plan, grid, carry);
  wkv6_local_kernel<true><<<grid, kT, kLocalSmem * sizeof(float), s>>>(
      lw, r, dy, gb, ds0, dec, S, H);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  wkv6_carry_kernel<true><<<carry, kT, 0, s>>>(ds, gb, ds0, dec, nch, H,
                                               total);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  wkv6_grad_kernel<<<grid, kT, kGradSmem * sizeof(float), s>>>(
      r, k, v, lw, u, ck, dy, gb, dr, dk, dv, dlw, du, S, H);
  return static_cast<int>(cudaGetLastError());
}
