// RWKV-6's WKV recurrence: a forward and a backward scan, one launch each
// per layer call.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// device-side jax.lax.scan (src/repro/models/rwkv.py:141-152), which XLA
// compiles into a loop on the device; the plain version beside this kernel
// (kernels/wkv6_scan/ref.py) loops over tokens on the host, a few launches
// a token.  Per (b, h), with the float32 state S [64, 64]:
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// What bounds it on the H100: 7 float32 FLOPs a state entry a token forward
// and 14 backward (outside the tensor cores), and each input read and each
// output written once.  A scan reaches neither: the tokens of one (b, h)
// form a chain, so the time is the chain's latency, and one sequence gives
// only B*H = 40 chains for 132 SMs.  The design shortens each link: a block
// of 256 threads owns one (b, h), each thread 16 of the state's 4096
// entries in registers, the four threads of a row or a column adjacent
// lanes, so that a per-token sum over a row or a column is 16 FMAs and two
// shuffles.  The inputs of a chunk of 8 tokens are copied into shared
// memory with cp.async while the chunk before runs: one barrier a chunk,
// none a token.
//
// Forward: thread (j, q) holds S[16q .. 16q+15, j], the column that y_t[j]
// reads.  In training it also writes the state before every chunk (the
// checkpoints, [B, ceil(S/8), H, 64, 64]).
//
// Backward: from a chunk's checkpoint each thread recomputes its row part
// of the chunk's 8 states S_{t-1} into registers, then runs the adjoint
// G_t = dL/dS_t back through the chunk.  It holds G twice: the row part
// G[i, 16q ..] for dr, dk and dw (sums over a row) and the column part
// G[16q .., i] for dv (a sum over a column), so every per-token sum stays
// inside four lanes.  The dot products dy_t . v_t and (u r_t) . k_t take
// one warp a token.  dr, dk, dv, dw are staged a chunk at a time in shared
// memory and written whole; du comes back per (b, h), and the caller sums
// it over b.
#include "scan.cuh"

namespace {

using namespace repro::scan;

constexpr int kHd = 64;               // head dim: S is kHd x kHd
constexpr int kPer = kHd / kParts;    // state entries a thread holds: 16
constexpr int kRow = kChunk * kHd;    // floats of one input in a stage
// the backward's stage: r, k, v, w, dy of a chunk and its checkpoint
constexpr int kBwdStage = 5 * kRow + kHd * kHd;
constexpr int kBwdSmem =
    static_cast<int>(sizeof(float)) * (2 * kBwdStage + 4 * kRow + 2 * kChunk);

static_assert(kOwners == kHd, "a block holds one head's rows or columns");

// tokens [0, n) of one (b, h)'s input (token stride ts floats) into
// dst[token][kHd], 16 bytes a copy
__device__ __forceinline__ void stage_tokens(float* dst, const float* src,
                                             int64_t ts, int n) {
  for (int idx = threadIdx.x; idx < n * (kHd / 4); idx += kThreads) {
    const int tt = idx / (kHd / 4), c4 = idx % (kHd / 4);
    cp_async16(dst + tt * kHd + 4 * c4, src + tt * ts + 4 * c4);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
    wkv6_forward_kernel(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ s0, float* __restrict__ y,
                        float* __restrict__ s_out, float* __restrict__ ck,
                        int S, int H) {
  // two stages of r, k, w, v [kChunk][kHd]
  __shared__ __align__(16) float stage[2][4 * kRow];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x / kParts;  // the column of S this thread updates
  const int q = threadIdx.x % kParts;  // its rows kPer*q .. kPer*q + 15
  const int64_t ts = static_cast<int64_t>(H) * kHd;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * kHd;
  const int nck = (S + kChunk - 1) / kChunk;
  const float* sp = s0 + static_cast<int64_t>(bh) * kHd * kHd;
  float st[kPer], uu[kPer];
#pragma unroll
  for (int ii = 0; ii < kPer; ++ii) {
    st[ii] = sp[(kPer * q + ii) * kHd + j];
    uu[ii] = u[h * kHd + kPer * q + ii];
  }
  auto issue = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    const int64_t off = base + t0 * ts;
    float* dst = stage[c & 1];
    stage_tokens(dst, r + off, ts, n);
    stage_tokens(dst + kRow, k + off, ts, n);
    stage_tokens(dst + 2 * kRow, w + off, ts, n);
    stage_tokens(dst + 3 * kRow, v + off, ts, n);
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
    if (ck != nullptr) {
      float* cp = ck + ((static_cast<int64_t>(b) * nck + c) * H + h) *
                           kHd * kHd;
#pragma unroll
      for (int ii = 0; ii < kPer; ++ii) cp[(kPer * q + ii) * kHd + j] = st[ii];
    }
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    const float* sr = stage[c & 1];
    const float* sk = sr + kRow;
    const float* sw = sr + 2 * kRow;
    const float* sv = sr + 3 * kRow;
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const float vj = sv[tt * kHd + j];
        float y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int ii = 0; ii < kPer; ii += 4) {
          const int o = tt * kHd + kPer * q + ii;
          const float4 r4 = ld4(sr + o), k4 = ld4(sk + o), w4 = ld4(sw + o);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kv = kk[e] * vj;
            const float a = fmaf(uu[ii + e], kv, st[ii + e]);
            if (e & 1) {
              y1 = fmaf(rr[e], a, y1);
            } else {
              y0 = fmaf(rr[e], a, y0);
            }
            st[ii + e] = fmaf(ww[e], st[ii + e], kv);
          }
        }
        const float yt = quad_sum(y0 + y1);
        if (q == 0) y[base + (t0 + tt) * ts + j] = yt;
      }
    }
    __syncthreads();
  }
  float* so = s_out + static_cast<int64_t>(bh) * kHd * kHd;
#pragma unroll
  for (int ii = 0; ii < kPer; ++ii) so[(kPer * q + ii) * kHd + j] = st[ii];
}

__global__ void __launch_bounds__(kThreads, 1)
    wkv6_backward_kernel(const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ ck,
                         const float* __restrict__ dy,
                         const float* __restrict__ ds, float* __restrict__ dr,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dw, float* __restrict__ du,
                         float* __restrict__ ds0, int S, int H) {
  extern __shared__ __align__(16) float smem[];
  float* out = smem + 2 * kBwdStage;  // dr, dk, dv, dw [kChunk][kHd]
  float* dots = out + 4 * kRow;       // dy.v and (u r).k [kChunk] each
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  // row role: row i of S and G, columns kPer*q ..; column role: column i
  // of G, rows kPer*q ..
  const int i = threadIdx.x / kParts;
  const int q = threadIdx.x % kParts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t ts = static_cast<int64_t>(H) * kHd;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * kHd;
  const int nck = (S + kChunk - 1) / kChunk;
  const float* dsp = ds + static_cast<int64_t>(bh) * kHd * kHd;
  float grow[kPer], gcol[kPer], sh[kChunk][kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    grow[e] = dsp[i * kHd + kPer * q + e];
    gcol[e] = dsp[(kPer * q + e) * kHd + i];
  }
  const float ui = u[h * kHd + i];
  const float ul0 = u[h * kHd + lane], ul1 = u[h * kHd + lane + 32];
  float du_acc = 0.f;
  auto issue = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    const int64_t off = base + t0 * ts;
    float* dst = smem + (c & 1) * kBwdStage;
    stage_tokens(dst, r + off, ts, n);
    stage_tokens(dst + kRow, k + off, ts, n);
    stage_tokens(dst + 2 * kRow, v + off, ts, n);
    stage_tokens(dst + 3 * kRow, w + off, ts, n);
    stage_tokens(dst + 4 * kRow, dy + off, ts, n);
    const float* cp =
        ck + ((static_cast<int64_t>(b) * nck + c) * H + h) * kHd * kHd;
    for (int idx = threadIdx.x; idx < kHd * kHd / 4; idx += kThreads)
      cp_async16(dst + 5 * kRow + 4 * idx, cp + 4 * idx);
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
    const float* sr = smem + (c & 1) * kBwdStage;
    const float* sk = sr + kRow;
    const float* sv = sr + 2 * kRow;
    const float* sw = sr + 3 * kRow;
    const float* sdy = sr + 4 * kRow;
    const float* sck = sr + 5 * kRow;
    const int t0 = c * kChunk, n = min(kChunk, S - t0);
    // the chunk's per-token dot products, one warp a token
    if (warp < n) {
      const int o = warp * kHd;
      float a = fmaf(sdy[o + lane], sv[o + lane],
                     sdy[o + lane + 32] * sv[o + lane + 32]);
      float bb = fmaf(ul0 * sr[o + lane], sk[o + lane],
                      ul1 * sr[o + lane + 32] * sk[o + lane + 32]);
      a = warp_sum(a);
      bb = warp_sum(bb);
      if (lane == 0) {
        dots[warp] = a;
        dots[kChunk + warp] = bb;
      }
    }
    // the row part of the chunk's states S_{t0-1} .. S_{t0+n-2}
#pragma unroll
    for (int e = 0; e < kPer; e += 4) {
      const float4 c4 = ld4(sck + i * kHd + kPer * q + e);
      sh[0][e] = c4.x;
      sh[0][e + 1] = c4.y;
      sh[0][e + 2] = c4.z;
      sh[0][e + 3] = c4.w;
    }
#pragma unroll
    for (int m = 1; m < kChunk; ++m) {
      if (m < n) {
        const int o = (m - 1) * kHd;
        const float wi = sw[o + i], ki = sk[o + i];
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          sh[m][e] = fmaf(wi, sh[m - 1][e], ki * sv[o + kPer * q + e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = kChunk - 1; m >= 0; --m) {
      if (m < n) {
        const int o = m * kHd;
        const float dyv = dots[m], urk = dots[kChunk + m];
        const float ri = sr[o + i], ki = sk[o + i], wi = sw[o + i];
        const float dyi = sdy[o + i];
        float pr = 0.f, pk = 0.f, pw = 0.f, pv = 0.f;
#pragma unroll
        for (int e0 = 0; e0 < kPer; e0 += 4) {
          const int oq = o + kPer * q + e0;
          const float4 dy4 = ld4(sdy + oq), v4 = ld4(sv + oq);
          const float4 k4 = ld4(sk + oq), w4 = ld4(sw + oq), r4 = ld4(sr + oq);
          const float dyj[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
          const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
          const float kc[4] = {k4.x, k4.y, k4.z, k4.w};
          const float wc[4] = {w4.x, w4.y, w4.z, w4.w};
          const float rc[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = e0 + x;
            // row role: entry (i, kPer*q + e)
            pr = fmaf(dyj[x], sh[m][e], pr);
            pk = fmaf(grow[e], vj[x], pk);
            pw = fmaf(grow[e], sh[m][e], pw);
            grow[e] = fmaf(wi, grow[e], ri * dyj[x]);
            // column role: entry (kPer*q + e, i)
            pv = fmaf(gcol[e], kc[x], pv);
            gcol[e] = fmaf(wc[x], gcol[e], rc[x] * dyi);
          }
        }
        pr = quad_sum(pr);
        pk = quad_sum(pk);
        pw = quad_sum(pw);
        pv = quad_sum(pv);
        if (q == 0) {
          out[o + i] = fmaf(ui * ki, dyv, pr);
          out[kRow + o + i] = fmaf(ui * ri, dyv, pk);
          out[2 * kRow + o + i] = fmaf(dyi, urk, pv);
          out[3 * kRow + o + i] = pw;
          du_acc = fmaf(ri * ki, dyv, du_acc);
        }
      }
    }
    __syncthreads();
    // the chunk's dr, dk, dv, dw, whole rows of 16 bytes
    for (int idx = threadIdx.x; idx < 4 * n * (kHd / 4); idx += kThreads) {
      const int a = idx / (n * (kHd / 4));
      const int rem = idx - a * n * (kHd / 4);
      const int tt = rem / (kHd / 4), c4 = rem % (kHd / 4);
      float* dst = a == 0 ? dr : a == 1 ? dk : a == 2 ? dv : dw;
      *reinterpret_cast<float4*>(dst + base + (t0 + tt) * ts + 4 * c4) =
          ld4(out + a * kRow + tt * kHd + 4 * c4);
    }
  }
  if (q == 0) du[static_cast<int64_t>(bh) * kHd + i] = du_acc;
  float* d0 = ds0 + static_cast<int64_t>(bh) * kHd * kHd;
#pragma unroll
  for (int e = 0; e < kPer; ++e) d0[i * kHd + kPer * q + e] = grow[e];
}

}  // namespace

extern "C" int wkv6_forward_launch(const float* r, const float* k,
                                   const float* v, const float* w,
                                   const float* u, const float* s0, float* y,
                                   float* s_out, float* ck, int B, int S,
                                   int H, cudaStream_t stream) {
  wkv6_forward_kernel<<<B * H, kThreads, 0, stream>>>(r, k, v, w, u, s0, y,
                                                      s_out, ck, S, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wkv6_backward_launch(const float* r, const float* k,
                                    const float* v, const float* w,
                                    const float* u, const float* ck,
                                    const float* dy, const float* ds,
                                    float* dr, float* dk, float* dv,
                                    float* dw, float* du, float* ds0, int B,
                                    int S, int H, cudaStream_t stream) {
  // once a process, before any graph capture (the first launch runs eagerly)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wkv6_backward_kernel<<<B * H, kThreads, kBwdSmem, stream>>>(
      r, k, v, w, u, ck, dy, ds, dr, dk, dv, dw, du, ds0, S, H);
  return static_cast<int>(cudaGetLastError());
}
