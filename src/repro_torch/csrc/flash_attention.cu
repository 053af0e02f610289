// Causal grouped-query attention for training and chunked prefill: a
// forward kernel and a backward pair (dK/dV, dQ) with the pass that forms
// D = rowsum(dO o O).  No logit or probability tensor reaches device memory.
//
// Replaces no Pallas kernel: the reference computes this attention as a
// plain jnp chain (src/repro/models/layers.py:76-97, _attend_block under
// gqa_attention), which the port ran as PyTorch's float32 chain (logits,
// scale, where, softmax, probs @ v, each a pass over [B, qb, K, G, T]).
// Per (b, h) with h = kh G + g, query position base[b] + s and keys t:
//     logits = q k^T hd^-1/2, masked to t <= base[b] + s
//     O      = softmax(logits) v                 (float32, then bf16)
// kernels/flash_attention/ref.py holds this file's algorithm in plain torch.
//
// What bounds it on the H100: the tensor cores on the causal FLOPs (4 hd a
// visible (query, key) pair forward; 8 hd backward, for dP, dV, dK and dQ),
// at 989 TFLOP/s in bf16; the bytes (q, k, v, o once each) are far below.
// The kernels do more: the backward forms S again (twice: in the dK/dV
// and the dQ pass) and dP twice, and each split product runs twice.
// granite-3-2b's layer at S 4096 (32 heads of 64) is 69 GFLOP forward,
// 0.07 ms at that rate.
//
// Precision: the same products as the float32 chain.  q k^T and dO v^T take
// bf16 operands, exact products, float32 sums.  P (and dS) is float32: it
// is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), both multiplied
// against the bf16 operand in float32 accumulation, so P is carried to 16
// significant bits (relative error <= 2^-17, 2^8 below the bf16 rounding
// of the output).  Online softmax, the row statistics and the output's
// normalisation stay in float32 registers.
//
// Design (FlashAttention-2/3's shape for Hopper).  A block holds 288
// threads: two consumer warpgroups, each running wgmma on 64 rows, and one
// producer warp whose lane 0 keeps TMA loads in flight through a ring of
// shared-memory stages (full/empty mbarriers).  Tiles are stored as hd/64
// column blocks of [rows][128 bytes] in the 128-byte swizzle that TMA
// writes and the wgmma descriptors name; one stored tile serves as a
// K-major operand (rows x hd) and as an N-major B operand (its rows the
// product's depth), so no tile is transposed.  A block's rows are (query
// position, head of the group) pairs, r = p G + g, so each K/V tile is read
// once for the G query heads that share it.  Key tiles wholly above the
// causal diagonal of a block are never loaded; the diagonal is per lane
// (base[b] + s), so one kernel serves training (base 0) and the prefill
// chunk (base = the lane's start).
// * Forward (flash_attn_fwd_kernel): a block of 128 rows streams key tiles
//   of 64: S = Q K^T (wgmma, both operands in shared memory), masked
//   online softmax in registers, O += P_hi V + P_lo V with P as the wgmma's
//   register operand.  Writes O in bf16, O in float32 and the row
//   log-sum-exp [B, H, S] (natural log) when a backward will read them.
// * D (flash_attn_dot_kernel): a warp a row, D = rowsum(dO o O_f32), from
//   the float32 output and not its bf16 rounding, as autograd's softmax
//   backward through the chain forms it.
// * dK/dV (flash_attn_dkdv_kernel): a block owns 128 keys of one (lane, KV
//   head), loads K and V once and walks the query tiles (64 rows, all G
//   heads) at or below its diagonal: S^T = K Q^T and dP^T = V dO^T, P^T
//   again from the saved log-sum-exp, dS^T = P^T o (dP^T - D), then dV +=
//   P^T dO and dK += dS^T Q (split operands).  dK and dV for the group sum
//   over its heads in float32 registers and are rounded to bf16 once.
// * dQ (flash_attn_dq_kernel): its own pass, a block of 128 query rows
//   walking the key tiles as the forward does, dQ += dS K.  dQ sums over
//   key tiles that different dK/dV blocks own; summing it there would need
//   float atomics, whose order changes from run to run.  Every sum here
//   runs in a fixed order, so two runs agree bit for bit.
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int kRows = 128;      // query rows of a forward or dQ block
constexpr int kKeys = 64;       // keys of a streamed K/V tile
constexpr int kBwdKeys = 128;   // keys of a dK/dV block
constexpr int kBwdRows = 64;    // query rows of a streamed Q/dO tile
constexpr int kStages = 2;      // streamed tiles in flight
constexpr int kThreads = 288;   // two consumer warpgroups, a producer warp
constexpr int kTileRow = 128;   // bytes of a tile's row in a column block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- Hopper primitives ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// arrive, and expect ``bytes`` more from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity ``parity`` to complete.  The loop is in PTX
// so the control flow stays straight for the wgmma register analysis; a
// phase that never completes (a fault) traps after 2^26 polls instead of
// hanging the card, and the launch fails.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.eq.u32 p, n, 0x4000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}"
      :: "r"(bar), "r"(parity) : "memory");
}

// generic-proxy writes to shared memory made visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void st_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};"
               :: "r"(addr), "r"(0) : "memory");
}

// TMA: the box at coordinates (c0, c1, c2, c3) of ``map`` into shared
// memory at ``dst``, completing its bytes on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define FA_D8(o)                                                         \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
#define FA_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define FA_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 64] += A[64 x 16] B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the fragment of
// a 64 x 16 slice of an accumulator), B N-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with 128 columns
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keep the compiler from moving register accesses across wgmma's async span
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// (bf16(x0), bf16(x1)) and the bf16 rounding of what each leaves over, as
// two packed pairs (x0 in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- tiles ---------------------------------------------------------------

// A tile of R rows x HD columns: HD/64 column blocks of [R][128 bytes].
template <int HD, int R>
struct Tile {
  static constexpr int kBlocks = HD / 64;
  static constexpr int kBytes = kBlocks * R * kTileRow;
  // K-major operand: rows row0 .. row0 + 63, depth step ks (16 columns)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t t, int row0,
                                                    int ks) {
    return gmma_desc(t + (ks / 4) * R * kTileRow + row0 * kTileRow +
                         (ks % 4) * 32,
                     16, 1024);
  }
  // N-major B operand: depth rows 16 kk .. 16 kk + 15, every column
  static __device__ __forceinline__ uint64_t nmajor(uint32_t t, int kk) {
    return gmma_desc(t + kk * 16 * kTileRow, R * kTileRow, 1024);
  }
  // TMA the box (rows of ``map``) at (c1, c2, c3) into every column block
  static __device__ __forceinline__ void load(uint32_t t,
                                              const CUtensorMap* map, int c1,
                                              int c2, int c3, uint32_t bar) {
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load(t + cb * R * kTileRow, map, cb * 64, c1, c2, c3, bar);
  }
  // zero rows r0 .. R - 1, which no TMA box writes (threads of the block)
  static __device__ __forceinline__ void zero_rows(uint32_t t, int r0) {
    const int units = (R - r0) * 8;
    for (int i = threadIdx.x; i < kBlocks * units; i += kThreads)
      st_zero16(t + (i / units) * R * kTileRow + r0 * kTileRow +
                (i % units) * 16);
  }
};

// A thread's place in its warpgroup's accumulators: fragment 4j + e is row
// 16 warp + lane/4 + 8 (e/2), column 8j + 2 (lane%4) + e%2.
struct Frag {
  int wg, row, col;  // row of e < 2 in the warpgroup's 64, column of j = 0
  __device__ Frag() {
    const int t = threadIdx.x;
    wg = t / 128;
    row = 16 * ((t % 128) / 32) + (t % 32) / 4;
    col = 2 * (t % 4);
  }
};

// The slice kk (depth 16 kk .. 16 kk + 15) of a 64 x 64 accumulator as the
// register operand of the next product, split in high and low halves.
__device__ __forceinline__ void split_operand(const float (&x)[32],
                                              uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// the shared-memory base, 1024-byte aligned for the swizzle
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---- forward -------------------------------------------------------------

template <int HD>
struct FwdSmem {
  using Q = Tile<HD, kRows>;
  using KV = Tile<HD, kKeys>;
  static constexpr int kStage = 2 * KV::kBytes;  // K then V
  static constexpr int kBars = Q::kBytes + kStages * kStage;
  // full[kStages], empty[kStages], the Q tile's barrier; alignment slack
  static constexpr int kSize = kBars + (2 * kStages + 1) * 8 + 1024;
};

// q [B, S, H, hd] through tm_q (box hd 64 x G heads x 128/G positions),
// k, v [B, T, K, hd] through tm_k, tm_v (box 64 x 1 x 64 keys).  Grid
// (query tiles, K, B), the last query tile first (the most key tiles).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const int* __restrict__ base_pos,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
                      float* __restrict__ lse, int S, int T, int H, int G,
                      float scale_log2) {
  using L = FwdSmem<HD>;
  using KV = typename L::KV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;
  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int pt = kRows / G, ru = pt * G, s0 = qt * pt;
  const int b0 = base_pos ? base_pos[b] : 0;
  // keys any row of the block sees: t <= b0 + (its last position)
  const int kmax = min(T, b0 + min(s0 + pt, S));
  const int n_tiles = (kmax + kKeys - 1) / kKeys;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  L::Q::zero_rows(base, ru);
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {  // the producer warp: lane 0 issues every load
    if (tid == 256) {
      mbar_expect_tx(qbar, L::Q::kBlocks * ru * kTileRow);
      L::Q::load(base, &tm_q, kh * G, s0, b, qbar);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        if (n >= kStages) mbar_wait(empty0 + 8 * st, (n / kStages - 1) & 1);
        const uint32_t kv = base + L::Q::kBytes + st * L::kStage;
        mbar_expect_tx(full0 + 8 * st, 2 * KV::kBytes);
        KV::load(kv, &tm_k, kh, n * kKeys, b, full0 + 8 * st);
        KV::load(kv + KV::kBytes, &tm_v, kh, n * kKeys, b, full0 + 8 * st);
      }
    }
    return;
  }

  const Frag f;
  int pos[2];  // each of the thread's two rows' query position
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * f.wg + f.row + 8 * i;
    pos[i] = b0 + s0 + (r < ru ? r / G : 0);
  }
  float acc[HD / 2];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    const uint32_t kt = base + L::Q::kBytes + st * L::kStage;
    mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    float s[32];
    zero(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(s, L::Q::kmajor(base, 64 * f.wg, ks), KV::kmajor(kt, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    // masked online softmax in the log2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = n * kKeys + 8 * j + f.col + (e & 1);
        const float x = (t <= pos[e / 2] && t < T) ? s[4 * j + e] * scale_log2
                                                   : -INFINITY;
        s[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m[e / 2]);
        s[4 * j + e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
    uint32_t ph[4][4], pl[4][4];
    split_operand(s, ph, pl);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc, ph[kk], KV::nmajor(kt + KV::kBytes, kk));
      wgmma_rs(acc, pl[kk], KV::nmajor(kt + KV::kBytes, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (tid % 128 == 0) mbar_arrive(empty0 + 8 * st);
  }

  // epilogue: O / l, one bf16 rounding; the log-sum-exp in natural log
  const int lane_q = tid % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * f.wg + f.row + 8 * i;
    const float lsum = quad_sum(l[i]);
    const int s = s0 + r / G;
    if (r >= ru || s >= S) continue;
    const int h = kh * G + r % G;
    const int64_t row = (static_cast<int64_t>(b) * S + s) * H + h;
    const float inv = 1.f / lsum;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float v0 = acc[4 * j + 2 * i] * inv;
      const float v1 = acc[4 * j + 2 * i + 1] * inv;
      const int64_t at = row * HD + 8 * j + f.col;
      *reinterpret_cast<uint32_t*>(o + at) = pack_bf16(v0, v1);
      if (o32) *reinterpret_cast<float2*>(o32 + at) = make_float2(v0, v1);
    }
    if (lse && lane_q == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + s] =
          (m[i] + log2f(lsum)) * kLn2;
  }
}

// ---- backward ------------------------------------------------------------

// D[b, h, s] = sum over hd of dO o O_f32: a warp a row (b, s, h)
template <int HD>
__global__ void __launch_bounds__(256)
flash_attn_dot_kernel(const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ o32, float* __restrict__ d,
                      int64_t rows, int S, int H) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  constexpr int kPer = HD / 32;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t at = r * HD + lane * kPer + i;
    sum = fmaf(__bfloat162float(dout[at]), o32[at], sum);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) {
    const int64_t bs = r / H, h = r - bs * H, b = bs / S, s = bs - b * S;
    d[(b * H + h) * S + s] = sum;
  }
}

template <int HD>
struct DkdvSmem {
  using KV = Tile<HD, kBwdKeys>;
  using Q = Tile<HD, kBwdRows>;
  // a stage: Q, dO, then the rows' log2-sum-exp and D (padded so the
  // next stage's tiles stay 1024-byte aligned)
  static constexpr int kStage = 2 * Q::kBytes + 1024;
  static constexpr int kStages0 = 2 * KV::kBytes;
  static constexpr int kBars = kStages0 + kStages * kStage;
  static constexpr int kSize = kBars + (2 * kStages + 1) * 8 + 1024;
};

// Grid (key tiles of 128, K, B).  Query tiles of 64 rows hold 64/G
// positions of all G heads; lse and D are [B, H, S].
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const int* __restrict__ base_pos,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int T, int H,
                       int G, float scale, float scale_log2) {
  using L = DkdvSmem<HD>;
  using KV = typename L::KV;
  using Q = typename L::Q;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t kbar = empty0 + 8 * kStages;
  const int tid = threadIdx.x;
  const int kt0 = blockIdx.x * kBwdKeys, kh = blockIdx.y, b = blockIdx.z;
  const int K = H / G;
  const int pt = kBwdRows / G, ru = pt * G;
  const int b0 = base_pos ? base_pos[b] : 0;
  // the query tiles with a position at or past the block's first key
  const int j0 = max(0, kt0 - b0) / pt;
  const int n_q = (S + pt - 1) / pt;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2);
    }
    mbar_init(kbar, 1);
    mbar_init_fence();
  }
  for (int i = 0; i < kStages; ++i) {
    const uint32_t st = base + L::kStages0 + i * L::kStage;
    Q::zero_rows(st, ru);
    Q::zero_rows(st + Q::kBytes, ru);
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    const int lane = tid - 256;
    if (lane == 0) {
      mbar_expect_tx(kbar, 2 * KV::kBytes);
      KV::load(base, &tm_k, kh, kt0, b, kbar);
      KV::load(base + KV::kBytes, &tm_v, kh, kt0, b, kbar);
    }
    for (int j = j0; j < n_q; ++j) {
      const int n = j - j0, st = n % kStages;
      if (n >= kStages) mbar_wait(empty0 + 8 * st, (n / kStages - 1) & 1);
      const uint32_t qs = base + L::kStages0 + st * L::kStage;
      float* rows = reinterpret_cast<float*>(gbase + (qs - base) +
                                             2 * Q::kBytes);
      // rows past the group's tiles or the sequence: log-sum-exp +inf
      // gives P = 0 there
      for (int r = lane; r < kBwdRows; r += 32) {
        const int s = j * pt + r / G;
        float x = INFINITY, dd = 0.f;
        if (r < ru && s < S) {
          const int64_t at =
              (static_cast<int64_t>(b) * H + kh * G + r % G) * S + s;
          x = lse[at] * kLog2e;
          dd = dsum[at];
        }
        rows[r] = x;
        rows[kBwdRows + r] = dd;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full0 + 8 * st, 2 * Q::kBlocks * ru * kTileRow);
        Q::load(qs, &tm_q, kh * G, j * pt, b, full0 + 8 * st);
        Q::load(qs + Q::kBytes, &tm_do, kh * G, j * pt, b, full0 + 8 * st);
      }
    }
    return;
  }

  const Frag f;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = kt0 + 64 * f.wg + f.row + 8 * i;
  float gk[HD / 2], gv[HD / 2];
  zero(gk);
  zero(gv);
  mbar_wait(kbar, 0);
  for (int j = j0; j < n_q; ++j) {
    const int n = j - j0, st = n % kStages;
    const uint32_t qs = base + L::kStages0 + st * L::kStage;
    const float* rows = reinterpret_cast<const float*>(
        gbase + (qs - base) + 2 * Q::kBytes);
    mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(s, KV::kmajor(base, 64 * f.wg, ks), Q::kmajor(qs, 0, ks));
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(dp, KV::kmajor(base + KV::kBytes, 64 * f.wg, ks),
               Q::kmajor(qs + Q::kBytes, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    // rows: keys; columns: the tile's query rows
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * c + f.col + (e & 1);
        const int pos = b0 + j * pt + r / G;
        const int t = key[e / 2];
        const float p = (t <= pos && t < T)
                            ? exp2f(s[4 * c + e] * scale_log2 - rows[r])
                            : 0.f;
        s[4 * c + e] = p;
        dp[4 * c + e] = p * (dp[4 * c + e] - rows[kBwdRows + r]);
      }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    split_operand(s, ph, pl);
    split_operand(dp, dh, dl);
    fence_regs(gv);
    fence_regs(gk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(gv, ph[kk], Q::nmajor(qs + Q::kBytes, kk));
      wgmma_rs(gv, pl[kk], Q::nmajor(qs + Q::kBytes, kk));
      wgmma_rs(gk, dh[kk], Q::nmajor(qs, kk));
      wgmma_rs(gk, dl[kk], Q::nmajor(qs, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(gv);
    fence_regs(gk);
    if (tid % 128 == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = key[i];
    if (t >= T) continue;
    const int64_t row = (static_cast<int64_t>(b) * T + t) * K + kh;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int64_t at = row * HD + 8 * c + f.col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(gk[4 * c + 2 * i] * scale, gk[4 * c + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(gv[4 * c + 2 * i], gv[4 * c + 2 * i + 1]);
    }
  }
}

template <int HD>
struct DqSmem {
  using Q = Tile<HD, kRows>;
  using KV = Tile<HD, kKeys>;
  static constexpr int kStage = 2 * KV::kBytes;
  static constexpr int kBars = 2 * Q::kBytes + kStages * kStage;
  static constexpr int kSize = kBars + (2 * kStages + 1) * 8 + 1024;
};

// Grid (query tiles, K, B) as the forward's.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int* __restrict__ base_pos,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     __nv_bfloat16* __restrict__ dq, int S, int T, int H,
                     int G, float scale, float scale_log2) {
  using L = DqSmem<HD>;
  using KV = typename L::KV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;
  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int pt = kRows / G, ru = pt * G, s0 = qt * pt;
  const int b0 = base_pos ? base_pos[b] : 0;
  const int kmax = min(T, b0 + min(s0 + pt, S));
  const int n_tiles = (kmax + kKeys - 1) / kKeys;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  L::Q::zero_rows(base, ru);
  L::Q::zero_rows(base + L::Q::kBytes, ru);
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    if (tid == 256) {
      mbar_expect_tx(qbar, 2 * L::Q::kBlocks * ru * kTileRow);
      L::Q::load(base, &tm_q, kh * G, s0, b, qbar);
      L::Q::load(base + L::Q::kBytes, &tm_do, kh * G, s0, b, qbar);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        if (n >= kStages) mbar_wait(empty0 + 8 * st, (n / kStages - 1) & 1);
        const uint32_t kv = base + 2 * L::Q::kBytes + st * L::kStage;
        mbar_expect_tx(full0 + 8 * st, 2 * KV::kBytes);
        KV::load(kv, &tm_k, kh, n * kKeys, b, full0 + 8 * st);
        KV::load(kv + KV::kBytes, &tm_v, kh, n * kKeys, b, full0 + 8 * st);
      }
    }
    return;
  }

  const Frag f;
  int pos[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * f.wg + f.row + 8 * i;
    const int s = s0 + r / G;
    pos[i] = b0 + s0 + (r < ru ? r / G : 0);
    lse2[i] = INFINITY;
    dd[i] = 0.f;
    if (r < ru && s < S) {
      const int64_t at = (static_cast<int64_t>(b) * H + kh * G + r % G) * S + s;
      lse2[i] = lse[at] * kLog2e;
      dd[i] = dsum[at];
    }
  }
  float acc[HD / 2];
  zero(acc);
  mbar_wait(qbar, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    const uint32_t kt = base + 2 * L::Q::kBytes + st * L::kStage;
    mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(s, L::Q::kmajor(base, 64 * f.wg, ks), KV::kmajor(kt, 0, ks));
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(dp, L::Q::kmajor(base + L::Q::kBytes, 64 * f.wg, ks),
               KV::kmajor(kt + KV::kBytes, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = n * kKeys + 8 * j + f.col + (e & 1);
        const int i = e / 2;
        const float p = (t <= pos[i] && t < T)
                            ? exp2f(s[4 * j + e] * scale_log2 - lse2[i])
                            : 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dd[i]);
      }
    uint32_t dh[4][4], dl[4][4];
    split_operand(dp, dh, dl);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc, dh[kk], KV::nmajor(kt, kk));
      wgmma_rs(acc, dl[kk], KV::nmajor(kt, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (tid % 128 == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * f.wg + f.row + 8 * i;
    const int s = s0 + r / G;
    if (r >= ru || s >= S) continue;
    const int64_t row = (static_cast<int64_t>(b) * S + s) * H + kh * G + r % G;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + row * HD + 8 * j + f.col) =
          pack_bf16(acc[4 * j + 2 * i] * scale,
                    acc[4 * j + 2 * i + 1] * scale);
  }
}

// ---- host side -----------------------------------------------------------

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the driver library the CUDA
// runtime has loaded (no link against libcuda)
EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      fn = reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The map of a bf16 [batch, len, heads, hd] tensor whose box is hd 64 x
// box_heads heads x box_len positions of one batch entry, 128-byte swizzle;
// positions past len read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int len,
              int heads, int hd, int box_heads, int box_len) {
  const EncodeFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2,
      static_cast<cuuint64_t>(heads) * hd * 2,
      static_cast<cuuint64_t>(len) * heads * hd * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_len), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The logits' scale hd^-1/2, rounded once from double as the plain
// version's (and the float32 chain's) Python float is.
inline float logit_scale(int hd) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, const void* base_pos,
        void* o, void* o32, void* lse, int B, int S, int T, int H, int K,
        cudaStream_t st) {
  const int G = H / K, pt = kRows / G;
  const float scale = logit_scale(HD);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, HD, G, pt) ||
      !make_map(&mk, k, B, T, K, HD, 1, kKeys) ||
      !make_map(&mv, v, B, T, K, HD, 1, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attn_fwd_kernel<HD>;
  cudaError_t err = prepare(kernel, FwdSmem<HD>::kSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + pt - 1) / pt, K, B);
  kernel<<<grid, kThreads, FwdSmem<HD>::kSize, st>>>(
      mq, mk, mv, static_cast<const int*>(base_pos),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(o32),
      static_cast<float*>(lse), S, T, H, G, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* base_pos,
        const void* o32, const void* lse, const void* dout, void* dsum,
        void* dq, void* dk, void* dv, int B, int S, int T, int H, int K,
        cudaStream_t st) {
  const int G = H / K, pt = kRows / G, pt2 = kBwdRows / G;
  const float scale = logit_scale(HD);
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  flash_attn_dot_kernel<HD><<<static_cast<unsigned>((rows * 32 + 255) / 256),
                              256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(o32),
      static_cast<float*>(dsum), rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mk2, mv2, mq2, mdo2, mq, mdo, mk, mv;
  if (!make_map(&mk2, k, B, T, K, HD, 1, kBwdKeys) ||
      !make_map(&mv2, v, B, T, K, HD, 1, kBwdKeys) ||
      !make_map(&mq2, q, B, S, H, HD, G, pt2) ||
      !make_map(&mdo2, dout, B, S, H, HD, G, pt2) ||
      !make_map(&mq, q, B, S, H, HD, G, pt) ||
      !make_map(&mdo, dout, B, S, H, HD, G, pt) ||
      !make_map(&mk, k, B, T, K, HD, 1, kKeys) ||
      !make_map(&mv, v, B, T, K, HD, 1, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bp = static_cast<const int*>(base_pos);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dsum);
  auto kv_kernel = flash_attn_dkdv_kernel<HD>;
  err = prepare(kv_kernel, DkdvSmem<HD>::kSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<dim3((T + kBwdKeys - 1) / kBwdKeys, K, B), kThreads,
              DkdvSmem<HD>::kSize, st>>>(
      mk2, mv2, mq2, mdo2, bp, l, d, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, T, H, G, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto q_kernel = flash_attn_dq_kernel<HD>;
  err = prepare(q_kernel, DqSmem<HD>::kSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kernel<<<dim3((S + pt - 1) / pt, K, B), kThreads, DqSmem<HD>::kSize,
             st>>>(mq, mdo, mk, mv, bp, l, d,
                   static_cast<__nv_bfloat16*>(dq), S, T, H, G, scale,
                   scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, hd], k and v [B, T, K, hd]: bf16, contiguous, 16-byte
// aligned; H = K G with G <= 16, hd 64 or 128.  base_pos int32 [B] (each
// lane's first query position) or null (0).  o bf16 [B, S, H, hd]; o32
// float32 [B, S, H, hd] and lse float32 [B, H, S] or null (not written).
// Returns the first CUDA error (cudaErrorInvalidValue for a shape the
// kernel does not take or a tensor map the driver refuses).
extern "C" int flash_attn_forward(const void* q, const void* k,
                                  const void* v, const void* base_pos,
                                  void* o, void* o32, void* lse, int B, int S,
                                  int T, int H, int K, int hd, void* stream) {
  if (K <= 0 || H % K || H / K > 16 || S <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return fwd<64>(q, k, v, base_pos, o, o32, lse, B, S, T, H, K, st);
  if (hd == 128)
    return fwd<128>(q, k, v, base_pos, o, o32, lse, B, S, T, H, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward's inputs, its float32 output and log-sum-exp, and dout bf16
// [B, S, H, hd] (contiguous) -> dq [B, S, H, hd], dk and dv [B, T, K, hd]
// in bf16; dsum float32 [B, H, S] is scratch (D).  Three launches.
extern "C" int flash_attn_backward(const void* q, const void* k,
                                   const void* v, const void* base_pos,
                                   const void* o32, const void* lse,
                                   const void* dout, void* dsum, void* dq,
                                   void* dk, void* dv, int B, int S, int T,
                                   int H, int K, int hd, void* stream) {
  if (K <= 0 || H % K || H / K > 16 || S <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return bwd<64>(q, k, v, base_pos, o32, lse, dout, dsum, dq, dk, dv, B, S,
                   T, H, K, st);
  if (hd == 128)
    return bwd<128>(q, k, v, base_pos, o32, lse, dout, dsum, dq, dk, dv, B,
                    S, T, H, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
