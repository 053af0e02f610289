// Mamba-2's SSD recurrence: a forward and a backward scan, one launch each
// per layer call.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// device-side jax.lax.scan (src/repro/models/ssm.py:95-104), which XLA
// compiles into a loop on the device; the plain version beside this kernel
// (kernels/ssd_scan/ref.py) loops over tokens on the host.  Per (b, h), with
// the float32 state h [p, N] and B_t, C_t [N] shared by every head:
//     h_t = a_t h_{t-1} + dtx_t B_t^T
//     y_t = h_t C_t
//
// What bounds it on the H100: 5 float32 FLOPs a state entry a token forward
// and 14 backward, and each input read and each output written once; as in
// wkv6_scan.cu the time is the latency of each (b, h)'s chain of tokens,
// B*H = 64 chains for one zamba2-1.2b sequence.  The same shape: a block of
// 256 threads owns one (b, h); its p rows and N columns, padded with zeros
// to 64, are spread over 64 owners of 4 adjacent lanes, PT = 16 entries a
// thread; a chunk of 8 tokens' inputs is
// copied into shared memory with cp.async while the chunk before runs.
//
// Forward: thread (row, q) holds h[row, PT*q ..], so y_t[row] is PT FMAs
// and two shuffles.  In training it also writes the state before every
// chunk (the checkpoints, [B, ceil(S/8), H, p, N]).
//
// Backward: G_t = dL/dh_t is held twice, as the row part G[row, PT*q ..]
// (for ddtx, a sum over a row) and the column part G[PT*q .., col] (for dB
// and dC, sums over a column), so those sums stay inside four lanes.  The
// column role recomputes its part of the chunk's states h_{t-1} from the
// checkpoint into registers; da_t, a sum over the whole state, is summed
// per warp and then over the 8 warps in a fixed order.  dB and dC come
// back per head ([B, S, H, N]) and the caller sums them over heads: no
// atomics, so every result is deterministic.
#include "scan.cuh"

namespace {

using namespace repro::scan;

constexpr int kRow = kChunk * kOwners;  // floats of one input in a stage
constexpr int kWarps = kThreads / 32;
constexpr int PT = kOwners / kParts;    // state entries a thread holds
// the forward's stage: a [kChunk], dtx, B, C [kChunk][kOwners]
constexpr int kFwdStage = kChunk + 3 * kRow;
// the backward's stage: a, dtx, B, C, dy and the checkpoint [64][64]
constexpr int kBwdStage = kChunk + 4 * kRow + kOwners * kOwners;
constexpr int kBwdSmem = static_cast<int>(sizeof(float)) *
                         (2 * kBwdStage + 3 * kRow + kChunk * kWarps);

// Issue the copies of tokens [t0, t0 + n) of a (zeros past p and N stay):
// a[b, t, h] into dst[0 ..), dtx[b, t, h, :] into dst[kChunk + tt*64 ..],
// then B, C (and dy, when given) the same way one kRow further each.
__device__ __forceinline__ void stage_tokens(
    float* dst, const float* a, const float* dtx, const float* bm,
    const float* cm, const float* dy, int b, int h, int t0, int n, int S,
    int H, int P, int N) {
  const int per = 1 + P + 2 * N + (dy != nullptr ? P : 0);
  for (int idx = threadIdx.x; idx < n * per; idx += kThreads) {
    const int tt = idx / per;
    int e = idx - tt * per;
    const int64_t bt = static_cast<int64_t>(b) * S + t0 + tt;
    if (e == 0) {
      cp_async4(dst + tt, a + bt * H + h);
      continue;
    }
    e -= 1;
    if (e < P) {
      cp_async4(dst + kChunk + tt * kOwners + e, dtx + (bt * H + h) * P + e);
      continue;
    }
    e -= P;
    if (e < N) {
      cp_async4(dst + kChunk + kRow + tt * kOwners + e, bm + bt * N + e);
      continue;
    }
    e -= N;
    if (e < N) {
      cp_async4(dst + kChunk + 2 * kRow + tt * kOwners + e, cm + bt * N + e);
      continue;
    }
    e -= N;
    cp_async4(dst + kChunk + 3 * kRow + tt * kOwners + e,
              dy + (bt * H + h) * P + e);
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_forward_kernel(const float* __restrict__ a,
                       const float* __restrict__ dtx,
                       const float* __restrict__ bm,
                       const float* __restrict__ cm,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_out, float* __restrict__ ck,
                       int S, int H, int P, int N) {
  __shared__ __align__(16) float stage[2][kFwdStage];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int row = threadIdx.x / kParts;  // the state row this thread holds
  const int q = threadIdx.x % kParts;    // its columns PT*q .. PT*q + PT-1
  const int nck = (S + kChunk - 1) / kChunk;
  // the copies never write past p or N: those entries stay zero
  for (int idx = threadIdx.x; idx < 2 * kFwdStage; idx += kThreads)
    (&stage[0][0])[idx] = 0.f;
  __syncthreads();
  const int64_t hw = static_cast<int64_t>(P) * N;
  const float* hp = h0 + bh * hw;
  float hs[PT];
#pragma unroll
  for (int e = 0; e < PT; ++e) {
    const int n = PT * q + e;
    hs[e] = (row < P && n < N) ? hp[row * N + n] : 0.f;
  }
  auto issue = [&](int c) {
    const int t0 = c * kChunk;
    stage_tokens(stage[c & 1], a, dtx, bm, cm, nullptr, b, h, t0,
                 min(kChunk, S - t0), S, H, P, N);
    cp_async_commit();
  };
  issue(0);
  for (int c = 0; c < nck; ++c) {
    if (c + 1 < nck) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ck != nullptr && row < P) {
      float* cp = ck + ((static_cast<int64_t>(b) * nck + c) * H + h) * hw;
#pragma unroll
      for (int e = 0; e < PT; ++e)
        if (PT * q + e < N) cp[row * N + PT * q + e] = hs[e];
    }
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    const float* sa = stage[c & 1];
    const float* sx = sa + kChunk;
    const float* sb = sx + kRow;
    const float* sc = sb + kRow;
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const float at = sa[tt], x = sx[tt * kOwners + row];
        const int o = tt * kOwners + PT * q;
        float yp = 0.f;
#pragma unroll
        for (int e = 0; e < PT; ++e) {
          hs[e] = fmaf(at, hs[e], x * sb[o + e]);
          yp = fmaf(hs[e], sc[o + e], yp);
        }
        yp = quad_sum(yp);
        if (q == 0 && row < P)
          y[((static_cast<int64_t>(b) * S + t0 + tt) * H + h) * P + row] = yp;
      }
    }
    __syncthreads();
  }
  if (row < P) {
    float* ho = h_out + bh * hw;
#pragma unroll
    for (int e = 0; e < PT; ++e)
      if (PT * q + e < N) ho[row * N + PT * q + e] = hs[e];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_backward_kernel(const float* __restrict__ a,
                        const float* __restrict__ dtx,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ ck,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh, float* __restrict__ da,
                        float* __restrict__ ddtx, float* __restrict__ db,
                        float* __restrict__ dc, float* __restrict__ dh0,
                        int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* out = smem + 2 * kBwdStage;  // ddtx, dB, dC [kChunk][64]
  float* out_da = out + 3 * kRow;     // da per warp [kChunk][kWarps]
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  // row role: row `own` of G, columns PT*q ..; column role: column `own`
  // of G and of the states, rows PT*q ..
  const int own = threadIdx.x / kParts;
  const int q = threadIdx.x % kParts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nck = (S + kChunk - 1) / kChunk;
  const int64_t hw = static_cast<int64_t>(P) * N;
  for (int idx = threadIdx.x; idx < 2 * kBwdStage; idx += kThreads)
    smem[idx] = 0.f;
  __syncthreads();
  const float* dhp = dh + bh * hw;
  float grow[PT], gcol[PT], hist[kChunk][PT];
#pragma unroll
  for (int e = 0; e < PT; ++e) {
    const int x = PT * q + e;
    grow[e] = (own < P && x < N) ? dhp[own * N + x] : 0.f;
    gcol[e] = (x < P && own < N) ? dhp[x * N + own] : 0.f;
  }
  auto issue = [&](int c) {
    const int t0 = c * kChunk;
    float* dst = smem + (c & 1) * kBwdStage;
    stage_tokens(dst, a, dtx, bm, cm, dy, b, h, t0, min(kChunk, S - t0), S,
                 H, P, N);
    const float* cp = ck + ((static_cast<int64_t>(b) * nck + c) * H + h) * hw;
    for (int idx = threadIdx.x; idx < P * N; idx += kThreads) {
      const int r = idx / N;
      cp_async4(dst + kChunk + 4 * kRow + r * kOwners + (idx - r * N),
                cp + idx);
    }
    cp_async_commit();
  };
  issue(nck - 1);
  for (int c = nck - 1; c >= 0; --c) {
    if (c > 0) {
      issue(c - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sa = smem + (c & 1) * kBwdStage;
    const float* sx = sa + kChunk;
    const float* sb = sx + kRow;
    const float* sc = sb + kRow;
    const float* sdy = sc + kRow;
    const float* sck = sdy + kRow;
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    // the column part of the chunk's states h_{t0-1} .. h_{t0+n-2}
#pragma unroll
    for (int e = 0; e < PT; ++e)
      hist[0][e] = sck[(PT * q + e) * kOwners + own];
#pragma unroll
    for (int m = 1; m < kChunk; ++m) {
      if (m < n) {
        const int o = (m - 1) * kOwners;
        const float am = sa[m - 1], bn = sb[o + own];
#pragma unroll
        for (int e = 0; e < PT; ++e)
          hist[m][e] = fmaf(am, hist[m - 1][e], sx[o + PT * q + e] * bn);
      }
    }
#pragma unroll
    for (int m = kChunk - 1; m >= 0; --m) {
      if (m < n) {
        const int o = m * kOwners;
        const float at = sa[m];
        // column role: column `own`, rows PT*q + e
        const float bn = sb[o + own], cn = sc[o + own];
        float pb = 0.f, pc = 0.f, pa = 0.f;
#pragma unroll
        for (int e = 0; e < PT; ++e) {
          const float x = sx[o + PT * q + e], d = sdy[o + PT * q + e];
          const float ht = fmaf(at, hist[m][e], x * bn);
          gcol[e] = fmaf(d, cn, gcol[e]);
          pc = fmaf(ht, d, pc);
          pb = fmaf(gcol[e], x, pb);
          pa = fmaf(gcol[e], hist[m][e], pa);
          gcol[e] *= at;
        }
        // row role: row `own`, columns PT*q + e
        const float dr = sdy[o + own];
        float px = 0.f;
#pragma unroll
        for (int e = 0; e < PT; ++e) {
          grow[e] = fmaf(dr, sc[o + PT * q + e], grow[e]);
          px = fmaf(grow[e], sb[o + PT * q + e], px);
          grow[e] *= at;
        }
        pb = quad_sum(pb);
        pc = quad_sum(pc);
        px = quad_sum(px);
        pa = warp_sum(pa);
        if (q == 0) {
          out[o + own] = px;
          out[kRow + o + own] = pb;
          out[2 * kRow + o + own] = pc;
        }
        if (lane == 0) out_da[m * kWarps + warp] = pa;
      }
    }
    __syncthreads();
    // the chunk's ddtx, dB, dC and da
    const int per = P + 2 * N + 1;
    for (int idx = threadIdx.x; idx < n * per; idx += kThreads) {
      const int tt = idx / per;
      int e = idx - tt * per;
      const int64_t bth = (static_cast<int64_t>(b) * S + t0 + tt) * H + h;
      const int o = tt * kOwners;
      if (e < P) {
        ddtx[bth * P + e] = out[o + e];
      } else if ((e -= P) < N) {
        db[bth * N + e] = out[kRow + o + e];
      } else if ((e -= N) < N) {
        dc[bth * N + e] = out[2 * kRow + o + e];
      } else {
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < kWarps; ++x) s += out_da[tt * kWarps + x];
        da[bth] = s;
      }
    }
  }
  if (own < P) {
    float* d0 = dh0 + bh * hw;
#pragma unroll
    for (int e = 0; e < PT; ++e)
      if (PT * q + e < N) d0[own * N + PT * q + e] = grow[e];
  }
}

}  // namespace

extern "C" int ssd_forward_launch(const float* a, const float* dtx,
                                  const float* bm, const float* cm,
                                  const float* h0, float* y, float* h_out,
                                  float* ck, int B, int S, int H, int P,
                                  int N, cudaStream_t s) {
  if (P > kOwners || N > kOwners)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_forward_kernel<<<B * H, kThreads, 0, s>>>(a, dtx, bm, cm, h0, y, h_out,
                                                ck, S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_backward_launch(const float* a, const float* dtx,
                                   const float* bm, const float* cm,
                                   const float* ck, const float* dy,
                                   const float* dh, float* da, float* ddtx,
                                   float* db, float* dc, float* dh0, int B,
                                   int S, int H, int P, int N,
                                   cudaStream_t s) {
  if (P > kOwners || N > kOwners)
    return static_cast<int>(cudaErrorInvalidValue);
  // once a process, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_backward_kernel<<<B * H, kThreads, kBwdSmem, s>>>(
      a, dtx, bm, cm, ck, dy, dh, da, ddtx, db, dc, dh0, S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
