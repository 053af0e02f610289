// Mamba-2's SSD recurrence as a chunked (state-space-duality) scan: a
// forward and a backward, three kernels each per layer call.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// device-side jax.lax.scan (src/repro/models/ssm.py:88-104).  Per (b, h),
// with the float32 state h [p, N], B_t and C_t [N] shared by every head and
// the log decay la_t (the decay is a_t = exp(la_t)):
//     h_t = a_t h_{t-1} + dtx_t B_t^T
//     y_t = h_t C_t
// kernels/ssd_scan/ref.py holds the per-token loop and this file's
// algorithm in plain torch.
//
// The algorithm, over chunks of kL = 64 tokens (also the checkpoint
// interval).  Within a chunk, seg[t, s] = la_{s+1} + ... + la_t is a masked
// running sum down each column (never a difference of two cumulative sums,
// which loses the small terms and gives -inf - -inf), M[t, s] =
// exp(seg[t, s]) for s <= t and 0 above, E_t = exp(la_0 + ... + la_t),
// w_s = M[63, s].  With X the chunk's dtx [64 x p] and h0 the state before
// the chunk:
//     Y   = (M o C B^T) X + diag(E) C h0^T       (y reads the updated state)
//     h64 = E_63 h0 + X^T diag(w) B
// Forward: (1) ssd_local_kernel forms every chunk's X^T diag(w) B and E_63
// in parallel over (chunk, head, b); (2) ssd_carry_kernel walks the chunks
// in order, h0 <- E_63 h0 + X^T diag(w) B, one thread a state entry,
// writing the state before every chunk (the checkpoints, [B, ceil(S/64), H,
// p, N], scratch when the caller keeps none) and the final state; (3)
// ssd_output_kernel forms Y in parallel over (chunk, head, b).
// Backward, from the checkpoints, with G the gradient of the state at a
// chunk's end and D = dY X^T:
//     G_before = E_63 G + dY^T diag(E) C                   (1), (2) reversed
//     ddtx = (M o C B^T)^T dY + diag(w) B G^T              (3)
//     dB   = (M o D)^T C + diag(w) X G       (per head, summed in torch)
//     dC   = diag(E) dY h0 + (M o D) B       (per head)
//     dla_r = sum over t >= r > s of dL/dseg[t, s], s = -1 the chunk's
//             start: dL/dseg = M o C B^T o D inside the chunk, plus the
//             terms of h0 and of the chunk's end state
// No division anywhere, so a decay of exactly 0 (la <= -104) is exact.
//
// What bounds it on the H100: the function's own work is 5 float32 FLOPs a
// state entry a token forward and 14 backward (ops.py), 0.08 and 0.22 ms
// at the float32 rate for zamba2-1.2b's layer of 4096 tokens, more than
// its bytes take; the chunked form does about 3 and 7 products of
// 64 x 64 x 64 a (chunk, head) instead, about that arithmetic again, with
// every token of a chunk in flight at once, and moves the chunk states
// through device memory three times (phases 1 to 3).  Each product runs in
// float32 FFMA register tiles: 256 threads, 4 x 4 outputs a thread,
// operands read from shared memory as 16-byte vectors (8 floats for 16
// FMAs: shared memory's bandwidth, not the FMA pipe, bounds a product),
// tiles stored with their 16-byte units swizzled by row so a warp's reads
// along a row or down a column hit distinct banks.  A block owns one chunk
// of one sequence and walks a group of heads (heads_per_block in ops.py),
// so B, C and C B^T are read and formed once for the group, and the next
// head's inputs are copied in with cp.async while the current one
// computes.  ssd_output_kernel fits two blocks an SM (B's tile becomes
// dtx's second buffer once C B^T is formed; 128 registers);
// ssd_grad_kernel needs 14 tiles, 231 KB, one block an SM.  Grids are
// (chunks, head groups, B): 512 blocks for one 4096-token sequence of
// zamba2-1.2b.  Every sum runs in a fixed order and dB, dC come back per
// head: no atomics, so two runs agree bit for bit.
#include "scan.cuh"

namespace {

using namespace repro::scan;

// dynamic shared memory of each kernel, in floats
constexpr int kLocalSmem = 3 * kTile + 3 * kL;
constexpr int kOutSmem = 7 * kTile + 3 * kL;
constexpr int kGradSmem = 14 * kTile + 8 * kL + 8;

// each row 4ty+i of acc times v[4ty+i]
__device__ __forceinline__ void scale_rows(float (&acc)[4][4], const float* v,
                                           const Place& pl) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = v[4 * pl.ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= s;
  }
}

// acc times the tile's entries at the same places
__device__ __forceinline__ void mul_tile(float (&acc)[4][4], const float* t,
                                         const Place& pl) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 m = ld4(t, 4 * pl.ty + i, 4 * pl.tx);
    acc[i][0] *= m.x; acc[i][1] *= m.y; acc[i][2] *= m.z; acc[i][3] *= m.w;
  }
}

// Sum of acc's row 4ty+i times the tile's row at the same places, over the
// 16 threads that hold the row (8 lanes of each of two warps): each warp's
// part into part[(warp % 2) * 64 + row]; the caller adds the two.
__device__ __forceinline__ void row_dots(const float (&acc)[4][4],
                                         const float* t, float* part,
                                         const Place& pl) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 m = ld4(t, 4 * pl.ty + i, 4 * pl.tx);
    float d = acc[i][0] * m.x;
    d = fmaf(acc[i][1], m.y, d);
    d = fmaf(acc[i][2], m.z, d);
    d = fmaf(acc[i][3], m.w, d);
    d += __shfl_xor_sync(kAll, d, 1);
    d += __shfl_xor_sync(kAll, d, 2);
    d += __shfl_xor_sync(kAll, d, 4);
    if ((lane & 7) == 0) part[(threadIdx.x >> 5 & 1) * kL + 4 * pl.ty + i] = d;
  }
}

// la of the chunk's n tokens of one head (stride H) into v[0 .. n)
__device__ __forceinline__ void stage_la(float* v, const float* la,
                                         int64_t at, int H, int n) {
  for (int t = threadIdx.x; t < n; t += kT)
    cp_async4(v + t, la + at + static_cast<int64_t>(t) * H);
}

// Warp 0: v[t] = exp(la_0 + ... + la_t) (kPrefix) or exp(la_{t+1} + ... +
// la_63), each lane owning tokens 2l and 2l+1, the sums of whole lanes
// scanned across the warp; returns exp of the chunk's whole sum.
template <bool kPrefix>
__device__ __forceinline__ float scan_exp(float* v, const float* sla) {
  const int l = threadIdx.x & 31;
  const float x0 = sla[2 * l], x1 = sla[2 * l + 1];
  float in = x0 + x1;
  if constexpr (kPrefix) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kAll, in, d);
      if (l >= d) in += y;
    }
    float ex = __shfl_up_sync(kAll, in, 1);
    if (l == 0) ex = 0.f;
    const float p0 = ex + x0;
    v[2 * l] = expf(p0);
    v[2 * l + 1] = expf(p0 + x1);
    return expf(__shfl_sync(kAll, in, 31));
  } else {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_down_sync(kAll, in, d);
      if (l + d < 32) in += y;
    }
    float ex = __shfl_down_sync(kAll, in, 1);
    if (l == 31) ex = 0.f;
    v[2 * l + 1] = expf(ex);
    v[2 * l] = expf(ex + x1);
    return expf(__shfl_sync(kAll, in, 0));
  }
}

// M[t][s] = exp(la_{s+1} + ... + la_t) for s < t, 1 for s = t, 0 above:
// a running sum down column s, four threads a column (rows 16q .. 16q+15),
// each starting from the sums of the segments above its own, in order.
__device__ __forceinline__ void decay_tile(float* M, const float* sla) {
  const int s = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int g = threadIdx.x & 28;
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (16 * q + k > s) tot += sla[16 * q + k];
  const float s0 = __shfl_sync(kAll, tot, g);
  const float s1 = __shfl_sync(kAll, tot, g + 1);
  const float s2 = __shfl_sync(kAll, tot, g + 2);
  float run = q > 0 ? s0 : 0.f;
  if (q > 1) run += s1;
  if (q > 2) run += s2;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int t = 16 * q + k;
    float m = t == s ? 1.f : 0.f;
    if (t > s) {
      run += sla[t];
      m = expf(run);
    }
    M[sw(t, s)] = m;
  }
}

// C B^T into cb: rows t, columns s <= t (a warp wholly above the diagonal,
// or below the chunk's n tokens, stores zeros: M or C is 0 there)
__device__ __forceinline__ void form_cb(float* cb, const float* sc,
                                        const float* sb, const Place& pl,
                                        int n) {
  float acc[4][4];
  zero(acc);
  if (!pl.upper() && pl.wr < n) gemm<true, true>(acc, sc, sb, pl, 0, kD);
  store_tile(cb, acc, pl);
}

// Phase (1) of both directions: each chunk's own part of the carried
// matrix,
//   forward:  sum_s w_s X[s]^T B[s], w_s = exp(la_{s+1} + ... + la_63)
//   backward: sum_t E_t dY[t]^T C[t], E_t = exp(la_0 + ... + la_t)
// into slot c+1 (forward) or c-1 (backward) of buf [B, nch, H, p, N], or
// into edge [B, H, p, N] (h_out, dh0) where that slot is past the end; and
// exp of the chunk's sum of la into dec [B, nch, H].  u is dtx or dy, v is
// B or C.
template <bool kRev>
__global__ void __launch_bounds__(kT)
    ssd_local_kernel(const float* __restrict__ la,
                     const float* __restrict__ u,
                     const float* __restrict__ v, float* __restrict__ buf,
                     float* __restrict__ edge, float* __restrict__ dec,
                     int S, int H, int P, int N, int heads) {
  extern __shared__ __align__(16) float smem[];
  float* sv = smem;               // B or C: every head's
  float* su = sv + kTile;         // dtx or dy, two buffers
  float* sla = su + 2 * kTile;    // la, two buffers
  float* sc = sla + 2 * kL;       // w or E
  const Place pl;
  const int c = blockIdx.x, nch = gridDim.x, b = blockIdx.z;
  const int h_lo = blockIdx.y * heads, h_hi = min(H, h_lo + heads);
  const int n = min(kL, S - c * kL), kn = (n + 3) & ~3;
  const int64_t row0 = static_cast<int64_t>(b) * S + c * kL;
  for (int i = threadIdx.x; i < kLocalSmem; i += kT) smem[i] = 0.f;
  __syncthreads();
  stage(sv, v + row0 * N, N, n, N);
  auto issue = [&](int h, int k) {
    stage(su + k * kTile, u + (row0 * H + h) * P,
          static_cast<int64_t>(H) * P, n, P);
    stage_la(sla + k * kL, la, row0 * H + h, H, n);
    cp_async_commit();
  };
  issue(h_lo, 0);
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = (h - h_lo) & 1;
    if (h + 1 < h_hi) {
      issue(h + 1, k ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* su_k = su + k * kTile;
    if (threadIdx.x < 32) {
      const float d = scan_exp<kRev>(sc, sla + k * kL);
      if (threadIdx.x == 0)
        dec[(static_cast<int64_t>(b) * nch + c) * H + h] = d;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kT) su_k[i] *= sc[i / kD];
    __syncthreads();
    float acc[4][4];
    zero(acc);
    gemm<false, false>(acc, su_k, sv, pl, 0, kn);
    const int dst = kRev ? c - 1 : c + 1;
    float* out = dst >= 0 && dst < nch
        ? buf + ((static_cast<int64_t>(b) * nch + dst) * H + h) * P * N
        : edge + (static_cast<int64_t>(b) * H + h) * P * N;
    store_global(out, N, P, N, acc, pl);
    __syncthreads();
  }
}

// Phase (2): scan::carry with one decay a state (a head's), from start (h0
// or dh) into buf and edge.
template <bool kRev>
__global__ void __launch_bounds__(kT)
    ssd_carry_kernel(const float* __restrict__ start, float* buf, float* edge,
                     const float* __restrict__ dec, int nch, int H, int PN,
                     int64_t total) {
  carry<kRev, 1>(start, buf, edge, dec, nch, H, PN, total);
}

// Phase (3) forward: Y = (M o C B^T) X + diag(E) C h0^T for one chunk of
// each head of the block's group, h0 the chunk's slot of ck.
__global__ void __launch_bounds__(kT, 2)
    ssd_output_kernel(const float* __restrict__ la,
                      const float* __restrict__ dtx,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ ck, float* __restrict__ y,
                      int S, int H, int P, int N, int heads) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // C
  float* scb = sc + kTile;       // C B^T
  float* sa = scb + kTile;       // M, then M o C B^T
  float* sx = sa + kTile;        // dtx, two buffers
  float* sb = sx + kTile;        // B, until C B^T is formed: dtx's second
  float* sh = sx + 2 * kTile;    // the state before the chunk, two buffers
  float* sla = sh + 2 * kTile;   // la, two buffers
  float* se = sla + 2 * kL;      // E
  const Place pl;
  const int c = blockIdx.x, nch = gridDim.x, b = blockIdx.z;
  const int h_lo = blockIdx.y * heads, h_hi = min(H, h_lo + heads);
  // tokens past n are zeros: a warp whose rows lie past them skips its
  // products, and sums over tokens stop at n rounded up to 4 (a short
  // last chunk, a decode step's one token)
  const int n = min(kL, S - c * kL), kn = (n + 3) & ~3;
  const bool live = pl.wr < n;
  const int64_t row0 = static_cast<int64_t>(b) * S + c * kL;
  for (int i = threadIdx.x; i < kOutSmem; i += kT) smem[i] = 0.f;
  __syncthreads();
  stage(sb, bm + row0 * N, N, n, N);
  stage(sc, cm + row0 * N, N, n, N);
  auto issue = [&](int h, int k) {
    stage(sx + k * kTile, dtx + (row0 * H + h) * P,
          static_cast<int64_t>(H) * P, n, P);
    stage(sh + k * kTile,
          ck + ((static_cast<int64_t>(b) * nch + c) * H + h) * P * N, N, P,
          N);
    stage_la(sla + k * kL, la, row0 * H + h, H, n);
    cp_async_commit();
  };
  issue(h_lo, 0);
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = (h - h_lo) & 1;
    if (h == h_lo) {
      // B's tile becomes dtx's second buffer once C B^T is formed
      cp_async_wait<0>();
      __syncthreads();
      form_cb(scb, sc, sb, pl, n);
      __syncthreads();
      for (int i = threadIdx.x; i < kTile; i += kT) sb[i] = 0.f;
      __syncthreads();
      if (h + 1 < h_hi) issue(h + 1, 1);
    } else {
      if (h + 1 < h_hi) {
        issue(h + 1, k ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    decay_tile(sa, sla + k * kL);
    if (threadIdx.x < 32) scan_exp<true>(se, sla + k * kL);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kT) sa[i] *= scb[i];
    __syncthreads();
    float acc[4][4];
    zero(acc);
    if (live) {
      // diag(E) C h0^T: a(t, n) = C[t][n], b(n, p) = h0[p][n]
      gemm<true, true>(acc, sc, sh + k * kTile, pl, 0, kD);
      scale_rows(acc, se, pl);
      // + (M o C B^T) X over s <= t: a(t, s) = A[t][s], b(s, p) = X[s][p]
      gemm<true, false>(acc, sa, sx + k * kTile, pl, 0, min(pl.wr + 16, kn));
    }
    store_global(y + (row0 * H + h) * P, static_cast<int64_t>(H) * P, n, P,
                 acc, pl);
    __syncthreads();
  }
}

// Phase (3) backward: ddtx, dB and dC per head, and dla, for one chunk of
// each head of the block's group; h0 and G (the gradient of the chunk's
// end state) from the chunk's slots of ck and gb.
__global__ void __launch_bounds__(kT, 1)
    ssd_grad_kernel(const float* __restrict__ la,
                    const float* __restrict__ dtx,
                    const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ ck,
                    const float* __restrict__ dy,
                    const float* __restrict__ gb, float* __restrict__ dla,
                    float* __restrict__ ddtx, float* __restrict__ db,
                    float* __restrict__ dc, int S, int H, int P, int N,
                    int heads) {
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;              // B
  float* sc = sb + kTile;        // C
  float* scb = sc + kTile;       // C B^T
  float* sm = scb + kTile;       // M, then the prefix sums R of dla
  float* sa = sm + kTile;        // M o C B^T
  float* smd = sa + kTile;       // M o D
  float* sx = smd + kTile;       // dtx, two buffers
  float* sdy = sx + 2 * kTile;   // dy, two buffers
  float* sh = sdy + 2 * kTile;   // h0, two buffers
  float* sg = sh + 2 * kTile;    // G, two buffers
  float* sla = sg + 2 * kTile;   // la, two buffers
  float* se = sla + 2 * kL;      // E
  float* swv = se + kL;          // w
  float* szb = swv + kL;         // parts of sum_n B (X G), two warps'
  float* szc = szb + 2 * kL;     // parts of sum_n C (dY h0)
  float* sred = szc + 2 * kL;    // <G, h0> per warp
  const Place pl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x, nch = gridDim.x, b = blockIdx.z;
  const int h_lo = blockIdx.y * heads, h_hi = min(H, h_lo + heads);
  // as in ssd_output_kernel: warps past the chunk's n tokens skip
  const int n = min(kL, S - c * kL), kn = (n + 3) & ~3;
  const bool live = pl.wr < n;
  const int64_t row0 = static_cast<int64_t>(b) * S + c * kL;
  const int64_t hp = static_cast<int64_t>(H) * P;
  const int64_t hn = static_cast<int64_t>(H) * N;
  for (int i = threadIdx.x; i < kGradSmem; i += kT) smem[i] = 0.f;
  __syncthreads();
  stage(sb, bm + row0 * N, N, n, N);
  stage(sc, cm + row0 * N, N, n, N);
  auto issue = [&](int h, int k) {
    const int64_t slot = ((static_cast<int64_t>(b) * nch + c) * H + h) * P * N;
    stage(sx + k * kTile, dtx + (row0 * H + h) * P, hp, n, P);
    stage(sdy + k * kTile, dy + (row0 * H + h) * P, hp, n, P);
    stage(sh + k * kTile, ck + slot, N, P, N);
    stage(sg + k * kTile, gb + slot, N, P, N);
    stage_la(sla + k * kL, la, row0 * H + h, H, n);
    cp_async_commit();
  };
  issue(h_lo, 0);
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = (h - h_lo) & 1;
    if (h + 1 < h_hi) {
      issue(h + 1, k ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* x = sx + k * kTile;
    const float* d = sdy + k * kTile;
    const float* h0 = sh + k * kTile;
    const float* g = sg + k * kTile;
    if (h == h_lo) form_cb(scb, sc, sb, pl, n);
    decay_tile(sm, sla + k * kL);
    if (threadIdx.x < 32) scan_exp<true>(se, sla + k * kL);
    __syncthreads();
    if (threadIdx.x < kL) swv[threadIdx.x] = sm[sw(kL - 1, threadIdx.x)];
    for (int i = threadIdx.x; i < kTile; i += kT) sa[i] = sm[i] * scb[i];
    float acc[4][4];
    // M o D, D = dY X^T: a(t, p) = dY[t][p], b(p, s) = X[s][p]
    zero(acc);
    if (!pl.upper() && live) gemm<true, true>(acc, d, x, pl, 0, kD);
    mul_tile(acc, sm, pl);
    store_tile(smd, acc, pl);
    __syncthreads();
    // ddtx = diag(w) B G^T + (M o C B^T)^T dY
    zero(acc);
    if (live) {
      gemm<true, true>(acc, sb, g, pl, 0, kD);
      scale_rows(acc, swv, pl);
      gemm<false, false>(acc, sa, d, pl, pl.wr, kn);
    }
    store_global(ddtx + (row0 * H + h) * P, hp, n, P, acc, pl);
    // dB = diag(w) X G + (M o D)^T C
    zero(acc);
    if (live) gemm<true, false>(acc, x, g, pl, 0, kD);
    row_dots(acc, sb, szb, pl);
    if (live) {
      scale_rows(acc, swv, pl);
      gemm<false, false>(acc, smd, sc, pl, pl.wr, kn);
    }
    store_global(db + (row0 * H + h) * N, hn, n, N, acc, pl);
    // dC = diag(E) dY h0 + (M o D) B
    zero(acc);
    if (live) gemm<true, false>(acc, d, h0, pl, 0, kD);
    row_dots(acc, sc, szc, pl);
    if (live) {
      scale_rows(acc, se, pl);
      gemm<true, false>(acc, smd, sb, pl, 0, min(pl.wr + 16, kn));
    }
    store_global(dc + (row0 * H + h) * N, hn, n, N, acc, pl);
    // <G, h0>
    float part = 0.f;
    for (int i = threadIdx.x; i < kTile; i += kT)
      part = fmaf(g[i], h0[i], part);
    part = warp_sum(part);
    if (lane == 0) sred[warp] = part;
    __syncthreads();
    // R[t][r] = sum of Q[t][s] over -1 <= s < r, for r <= t, where
    // Q[t][s] = dL/dseg[t][s]: (M o D o C B^T)[t][s] inside the chunk; the
    // end state's w_s <G, X[s]^T B[s]> on row 63; and at s = -1 h0's
    // E_t <dY[t]^T C[t], h0> plus, on row 63, E_63 <G, h0>.  Four threads a
    // row, 16 columns each, each starting from the sums before its own.
    {
      const int t = threadIdx.x >> 2, q = threadIdx.x & 3;
      const int gq = threadIdx.x & 28;
      float qv[16], tot = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 md = ld4(smd, t, 16 * q + 4 * u);
        const float4 cb = ld4(scb, t, 16 * q + 4 * u);
        const float v4[4] = {md.x * cb.x, md.y * cb.y, md.z * cb.z,
                             md.w * cb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 16 * q + 4 * u + e;
          float v = 0.f;
          if (s < t) {
            v = v4[e];
            if (t == kL - 1) v = fmaf(swv[s], szb[s] + szb[kL + s], v);
          }
          qv[4 * u + e] = v;
          tot += v;
        }
      }
      const float s0 = __shfl_sync(kAll, tot, gq);
      const float s1 = __shfl_sync(kAll, tot, gq + 1);
      const float s2 = __shfl_sync(kAll, tot, gq + 2);
      float run = se[t] * (szc[t] + szc[kL + t]);
      if (t == kL - 1) {
        float gh = 0.f;
#pragma unroll
        for (int w = 0; w < kT / 32; ++w) gh += sred[w];
        run = fmaf(se[kL - 1], gh, run);
      }
      if (q > 0) run += s0;
      if (q > 1) run += s1;
      if (q > 2) run += s2;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float r4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          r4[e] = 16 * q + 4 * u + e <= t ? run : 0.f;
          run += qv[4 * u + e];
        }
        *reinterpret_cast<float4*>(sm + sw(t, 16 * q + 4 * u)) =
            make_float4(r4[0], r4[1], r4[2], r4[3]);
      }
    }
    __syncthreads();
    // dla_r = sum over t >= r of R[t][r]: four threads a column
    {
      const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
      const int gq = threadIdx.x & 28;
      float tot = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) tot += sm[sw(16 * q + j, r)];
      const float s0 = __shfl_sync(kAll, tot, gq);
      const float s1 = __shfl_sync(kAll, tot, gq + 1);
      const float s2 = __shfl_sync(kAll, tot, gq + 2);
      const float s3 = __shfl_sync(kAll, tot, gq + 3);
      if (q == 0 && r < n) dla[(row0 + r) * H + h] = ((s0 + s1) + s2) + s3;
    }
    __syncthreads();
  }
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
        reinterpret_cast<const void*>(ssd_local_kernel<false>),
        reinterpret_cast<const void*>(ssd_local_kernel<true>),
        reinterpret_cast<const void*>(ssd_output_kernel),
        reinterpret_cast<const void*>(ssd_grad_kernel)};
    const int floats[] = {kLocalSmem, kLocalSmem, kOutSmem, kGradSmem};
    for (int i = 0; i < 4; ++i) {
      const int e = set_smem(fns[i], floats[i]);
      if (e) return e;
    }
    return 0;
  }();
  return err;
}

int carry_blocks(int64_t total) {
  return static_cast<int>((total + kT - 1) / kT);
}

// What a launch used, in the kPlanInts ints at plan (host memory): heads a
// block walks, threads a block, then the grid (x, y, z) of each of the
// call's three kernels in launch order: the chunk kernel, the carry (one
// thread a state entry) and the chunk kernel of outputs or gradients.
constexpr int kPlanInts = 11;

void write_plan(int* plan, int heads, dim3 chunks, int carry) {
  const int v[kPlanInts] = {
      heads, kT,
      static_cast<int>(chunks.x), static_cast<int>(chunks.y),
      static_cast<int>(chunks.z), carry, 1, 1,
      static_cast<int>(chunks.x), static_cast<int>(chunks.y),
      static_cast<int>(chunks.z)};
  for (int i = 0; i < kPlanInts; ++i) plan[i] = v[i];
}

}  // namespace

// Forward: y, h_out, the state before every chunk (ck [B, nch, H, p, N],
// the checkpoints) and the decay across every chunk (dec [B, nch, H]) from
// la, dtx, B, C and h0.  heads: heads a block of the chunk kernels walks.
// plan (host memory, kPlanInts): what the launch used, see write_plan.
extern "C" int ssd_forward_launch(const float* la, const float* dtx,
                                  const float* bm, const float* cm,
                                  const float* h0, float* y, float* h_out,
                                  float* ck, float* dec, int* plan, int B,
                                  int S, int H, int P, int N, int heads,
                                  cudaStream_t s) {
  if (P > kD || N > kD || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = smem_attributes()) return err;
  const int nch = (S + kL - 1) / kL;
  const dim3 grid(nch, (H + heads - 1) / heads, B);
  const int64_t total = static_cast<int64_t>(B) * H * P * N;
  const int carry = carry_blocks(total);
  write_plan(plan, heads, grid, carry);
  ssd_local_kernel<false><<<grid, kT, kLocalSmem * sizeof(float), s>>>(
      la, dtx, bm, ck, h_out, dec, S, H, P, N, heads);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  ssd_carry_kernel<false><<<carry, kT, 0, s>>>(
      h0, ck, h_out, dec, nch, H, P * N, total);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  ssd_output_kernel<<<grid, kT, kOutSmem * sizeof(float), s>>>(
      la, dtx, bm, cm, ck, y, S, H, P, N, heads);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dla, ddtx, dB and dC per head [B, S, H, N], dh0 from the
// forward's inputs, its checkpoints ck, dy and dh; gb [B, nch, H, p, N]
// (the gradient of every chunk's end state) and dec are scratch; plan as
// the forward's.
extern "C" int ssd_backward_launch(const float* la, const float* dtx,
                                   const float* bm, const float* cm,
                                   const float* ck, const float* dy,
                                   const float* dh, float* dla, float* ddtx,
                                   float* db, float* dc, float* dh0,
                                   float* gb, float* dec, int* plan, int B,
                                   int S, int H, int P, int N, int heads,
                                   cudaStream_t s) {
  if (P > kD || N > kD || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = smem_attributes()) return err;
  const int nch = (S + kL - 1) / kL;
  const dim3 grid(nch, (H + heads - 1) / heads, B);
  const int64_t total = static_cast<int64_t>(B) * H * P * N;
  const int carry = carry_blocks(total);
  write_plan(plan, heads, grid, carry);
  ssd_local_kernel<true><<<grid, kT, kLocalSmem * sizeof(float), s>>>(
      la, dy, cm, gb, dh0, dec, S, H, P, N, heads);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  ssd_carry_kernel<true><<<carry, kT, 0, s>>>(
      dh, gb, dh0, dec, nch, H, P * N, total);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  ssd_grad_kernel<<<grid, kT, kGradSmem * sizeof(float), s>>>(
      la, dtx, bm, cm, ck, dy, gb, dla, ddtx, db, dc, S, H, P, N, heads);
  return static_cast<int>(cudaGetLastError());
}
