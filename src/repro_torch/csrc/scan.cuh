// Device helpers of the recurrence scans (wkv6_scan.cu, ssd_scan.cu): the
// chunk and tile shapes they share, asynchronous copies into shared memory,
// sums over lanes, 64 x 64 float32 tiles with their 16-byte units swizzled
// by row, the 4 x 4 FFMA register-tile product over such tiles, and the
// carry of the state across chunks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {
namespace scan {

constexpr int kL = 64;           // tokens a chunk: the checkpoint interval
constexpr int kD = 64;           // a state's rows and columns, at most
constexpr int kT = 256;          // threads a block
constexpr int kTile = kL * kD;   // floats of a tile
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(kAll, x, m);
  return x;
}

// Entry (r, c) of a 64 x 64 tile: rows of 16 units of 4 floats, unit u of
// row r stored at u ^ (r / 4 % 8).
__device__ __forceinline__ int sw(int r, int c) {
  return r * kD + (((c >> 2) ^ ((r >> 2) & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ float4 ld4(const float* t, int r, int c) {
  return *reinterpret_cast<const float4*>(t + sw(r, c));
}

// A thread's 4 x 4 block of a 64 x 64 product: rows 4ty .. 4ty+3, columns
// 4tx .. 4tx+3; warp w covers rows 16(w/2) .. +15, columns 32(w%2) .. +31.
struct Place {
  int ty, tx, wr;  // wr: the warp's first row
  __device__ Place() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    ty = 4 * (warp >> 1) + (lane >> 3);
    tx = 8 * (warp & 1) + (lane & 7);
    wr = 16 * (warp >> 1);
  }
  // the warp's block lies wholly above the diagonal (columns > rows)
  __device__ bool upper() const {
    return (threadIdx.x >> 5 & 1) && wr < 32;
  }
};

// gemm's B operand as it is read (no scaling)
struct NoScale {
  static constexpr bool kNone = true;
  __device__ void operator()(int, float (&)[4][4]) const {}
};

// acc += a b over k in [k0, k1) (multiples of 4), for the thread's rows
// 4ty+i and columns 4tx+j: a(m, k) is A[k][m], or A[m][k] when kAT; b(k, n)
// is Bt[k][n], or Bt[n][k] when kBT, times what sb(k, b) makes of the four
// steps k .. k+3 it is given (b[step][column]).
template <bool kAT, bool kBT, class Scale = NoScale>
__device__ __forceinline__ void gemm(float (&acc)[4][4], const float* A,
                                     const float* Bt, const Place& pl,
                                     int k0, int k1,
                                     const Scale& sb = Scale()) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float a[4][4], b[4][4];  // [k - step start][i], [k - step start][j]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 u =
          kAT ? ld4(A, 4 * pl.ty + q, k) : ld4(A, k + q, 4 * pl.ty);
      const float4 v =
          kBT ? ld4(Bt, 4 * pl.tx + q, k) : ld4(Bt, k + q, 4 * pl.tx);
      if (kAT) {
        a[0][q] = u.x; a[1][q] = u.y; a[2][q] = u.z; a[3][q] = u.w;
      } else {
        a[q][0] = u.x; a[q][1] = u.y; a[q][2] = u.z; a[q][3] = u.w;
      }
      if (kBT) {
        b[0][q] = v.x; b[1][q] = v.y; b[2][q] = v.z; b[3][q] = v.w;
      } else {
        b[q][0] = v.x; b[q][1] = v.y; b[q][2] = v.z; b[q][3] = v.w;
      }
    }
    if constexpr (!Scale::kNone) sb(k, b);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a[kk][i], b[kk][j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ void store_tile(float* t, const float (&acc)[4][4],
                                           const Place& pl) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(t + sw(4 * pl.ty + i, 4 * pl.tx)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// rows < rows and columns < cols of acc into g[row * ld + col]
__device__ __forceinline__ void store_global(float* g, int64_t ld, int rows,
                                             int cols,
                                             const float (&acc)[4][4],
                                             const Place& pl) {
  const int c0 = 4 * pl.tx;
  const bool vec = ((cols | ld) & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * pl.ty + i;
    if (r >= rows || c0 >= cols) continue;
    float* p = g + r * ld + c0;
    if (vec) {
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < cols) p[j] = acc[i][j];
    }
  }
}

// cp.async the [rows x cols] block at g (row stride ld floats) into tile t;
// the rest of t keeps its zeros.  16-byte copies where rows stay aligned.
__device__ __forceinline__ void stage(float* t, const float* g, int64_t ld,
                                      int rows, int cols) {
  if (((cols | ld) & 3) == 0) {
    const int units = cols >> 2;
    for (int i = threadIdx.x; i < rows * units; i += kT) {
      const int r = i / units, u = i - r * units;
      cp_async16(t + sw(r, 4 * u), g + r * ld + 4 * u);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kT) {
      const int r = i / cols, c = i - r * cols;
      cp_async4(t + sw(r, c), g + r * ld + c);
    }
  }
}

// The carry across chunks: one thread a state entry (of B * H states of PN
// entries, kRows rows of PN / kRows each) walks the chunks in order
// (backward: in reverse) from start, writing its value before every chunk
// into that chunk's slot of buf [B, nch, H, PN] and adding the chunk's own
// part, held in the next slot (or edge [B, H, PN]), after the chunk's decay
// of its row, dec [B, nch, H, kRows]; the last value into edge.  Each group
// of kAhead chunks reads all its parts before it writes.
template <bool kRev, int kRows>
__device__ __forceinline__ void carry(const float* __restrict__ start,
                                      float* buf, float* edge,
                                      const float* __restrict__ dec, int nch,
                                      int H, int PN, int64_t total) {
  constexpr int kAhead = 8;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kT + threadIdx.x;
  if (e >= total) return;
  const int64_t bh = e / PN, b = bh / H, h = bh - b * H;
  const int64_t step = static_cast<int64_t>(H) * PN;  // slot c to c + 1
  float* slot = buf + (b * nch * H + h) * PN + (e - bh * PN);
  // chunk c's decay at c * H * kRows
  const float* dc = dec + (b * nch * H + h) * kRows;
  if constexpr (kRows > 1) dc += (e - bh * PN) / (PN / kRows);
  float st = start[e];
  for (int k0 = 0; k0 < nch; k0 += kAhead) {
    float part[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = kRev ? nch - 1 - (k0 + k) : k0 + k;
      const int nx = kRev ? c - 1 : c + 1;
      part[k] = k0 + k >= nch ? 0.f
                : nx >= 0 && nx < nch ? slot[nx * step] : edge[e];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (k0 + k < nch) {
        const int c = kRev ? nch - 1 - (k0 + k) : k0 + k;
        slot[c * step] = st;
        st = fmaf(dc[static_cast<int64_t>(c) * H * kRows], st, part[k]);
      }
    }
  }
  edge[e] = st;
}

}  // namespace scan
}  // namespace repro
