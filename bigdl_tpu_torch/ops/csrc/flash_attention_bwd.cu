// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the JAX package's flash backward, the custom VJP of its one
//   Pallas kernel (pallas_call at bigdl_tpu/ops/flash_attention.py:116):
//   bigdl_tpu/ops/flash_attention.py::_flash_bwd, and ::_flash_lse_bwd for
//   the lse cotangent. That backward is XLA there (a lax.scan over kv
//   blocks), not a Pallas kernel.
// Computes exactly its (dq, dk, dv) from the forward's saved q, k, v, out
// and lse, the cotangent dO of out and, when the lse output was used, its
// cotangent d_lse: with P = exp(S * scale - lse) and
// D = rowsum(dO * O) - d_lse,
//   dS = P * (dO V^T - D),  dQ = scale * sum_j dS_j K_j,
//   dK_j = scale * dS_j^T Q,  dV_j = P_j^T dO.
// The causal mask is last-query-aligned (row r sees keys <= r + tk - t); a
// dead row (lse <= -1e30 / 2: t > tk, causal) gets dq 0 and adds nothing to
// dk or dv; with GQA, the `group` consecutive q heads of kv head hk add
// their dk and dv together. Each grad is written in its input's dtype,
// contiguous (B, H, T, D) or (B, H_kv, Tk, D). dO absent (only lse used)
// is read as zeros, so only the lse term enters.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// training flagship's shape (B 32, H = H_kv = 8, t = tk = 1024, d 64, bf16,
// causal) the five products of the algorithm (S, dP, dQ, dK, dV) do
// 10 * d * (t (t + 1) / 2) * B * H = 86.0 GFLOP against 33.6 MB of
// q, k, v, out, dO, lse in and dq, dk, dv out: 0.0869 ms of tensor-core
// time against 0.0100 ms of memory time, so it is compute-bound. This
// design does seven products (S and dP twice), 1.4x that work.
//
// The design, point by point:
// (1) Deterministic, with no atomics: three kernels, each output element
//   written by one block once, every sum taken in a fixed order, so two
//   calls on the same inputs agree to the bit.
//   flash_bwd_prep: D = rowsum(dO * O) - d_lse into a (B, H, T) f32 scratch
//   the wrapper allocates, one warp a row (a reduction, kept in CUDA C++
//   since the library is built by nvcc alone).
//   flash_bwd_dkdv: grid (B * H_kv, ceil(tk / 64)); a block owns one
//   64-key tile of one kv head, K_j and V_j in shared memory, and loops over
//   the g query heads of the group and, for each, over the q tiles from the
//   first row that sees the tile (r0 = max(0, j0 - (tk - t)) when causal).
//   Per q tile: S^T = K Q^T, P^T = 2^(S^T scale log2 e - lse log2 e),
//   dV += P^T dO, dP^T = V dO^T, dS^T = P^T * (dP^T - D), dK += dS^T Q.
//   dK and dV stay in f32 registers over the whole group and are written
//   once, dK times the scale: the group sum happens inside the block.
//   flash_bwd_dq: grid (B * H, ceil(t / 64)), the heaviest causal q tiles
//   first; a block owns one q tile, Q and dO in shared memory, and loops
//   over the kv tiles up to its last visible one, recomputing S, P, dP and
//   dS, dQ += dS K, written once times the scale.
// (2) bf16: every product on the tensor cores through inline-PTX
//   mma.sync.m16n8k16 (f32 accumulate), four warps a block, each owning
//   16 keys (dkdv) or 16 q rows (dq) of the 64. Operands come from shared
//   memory through ldmatrix (.trans where the product reads a tile along
//   its rows), in tiles padded to DP + 8 columns so that the 8 rows an
//   ldmatrix reads fall in distinct banks. The f32 accumulator of S (or
//   dP) for two adjacent 8-column tiles is exactly an A fragment, so P and
//   dS are rounded to bf16 in registers, as the forward rounds P, and never
//   touch shared memory.
// (3) The exponent is one FMA: scale * log2 e is folded into the score and
//   the saved lse is kept in log2 units, ex2.approx as in the forward; a
//   scale of any sign is right, since no row max is taken. Dead rows and
//   rows past t get lse = +inf, so their P is 2^-inf = 0 with no test;
//   keys past tk and the causal diagonal are masked only in the tiles that
//   cross them (a warp-uniform test).
// (4) The streamed tiles (Q and dO in dkdv, K and V in dq) are double
//   buffered with 16-byte cp.async copies, the next tile in flight while
//   the block computes on the current one. q, k, v and dO are read
//   through their (batch, head, row) strides, so views of a fused qkv
//   projection and the strided cotangent of a transposed output need no
//   copy; an operand whose D, strides or base are not multiples of 16 bytes
//   is copied element by element instead. The last dim must be contiguous:
//   the wrapper copies a dO whose last stride is not 1 (the stride-0
//   cotangent of out.sum()) and a d_lse that is not contiguous.
// (5) Head dims 1-128, zero-padded in shared memory to DP = 64 or 128.
//   Shared memory: 55 KB (DP 64) or 103 KB (DP 128) a block.
// (6) f32 inputs run the same three kernels on CUDA-core FMAs in full f32
//   (exp2f), 256 threads a block, each thread a 4 x 4 (or 4 x DP/16)
//   register tile, the operand tiles in shared memory padded to DP + 1.
//
// A single pass that sums dQ with f32 atomics, wgmma, TMA and warp
// specialisation are later work; this version is the simple one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;               // q rows a tile
constexpr int BK = 64;               // keys a tile
constexpr int NTHREADS = 128;        // bf16: 4 warps of 16 keys or rows
constexpr int F_NTHREADS = 256;      // f32: 16 x 16 threads
constexpr int PREP_ROWS = 8;         // rows a prep block, one a warp
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;        // the JAX kernel's _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* d_out;                 // null: dO reads as zeros
  const float* lse;                  // (B, H, T) contiguous
  const float* d_lse;                // (B, H, T) contiguous, or null
  void* dq;                          // (B, H, T, D) contiguous
  void* dk;                          // (B, H_kv, Tk, D) contiguous
  void* dv;
  float* delta;                      // (B, H, T) scratch: D of each row
  int B, H, H_kv, T, Tk, D, group;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  long long do_sb, do_sh, do_st;
  int causal;
  int vec_q, vec_k, vec_v, vec_do;   // bf16: 16-byte copies allowed
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------------- prep

// D[row] = sum_c dO[row, c] * O[row, c] - d_lse[row], in f32, a warp a row
template <typename T>
__global__ void __launch_bounds__(PREP_ROWS * 32)
flash_bwd_prep(const __grid_constant__ Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * PREP_ROWS + warp;
  if (row >= (long long)p.B * p.H * p.T) return;
  const long long bh = row / p.T;
  const long long r = row % p.T;
  const long long b = bh / p.H, h = bh % p.H;
  float acc = 0.0f;
  if (p.d_out != nullptr) {
    const T* o = static_cast<const T*>(p.out) + b * p.o_sb + h * p.o_sh
                 + r * p.o_st;
    const T* g = static_cast<const T*>(p.d_out) + b * p.do_sb
                 + h * p.do_sh + r * p.do_st;
    for (int c = lane; c < p.D; c += 32)
      acc = fmaf(to_f32(g[c]), to_f32(o[c]), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0)
    p.delta[row] = p.d_lse != nullptr ? acc - p.d_lse[row] : acc;
}

// ------------------------------------------------------ bf16 (tensor cores)

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i, and register i holds row lane / 4, columns
// 2 (lane % 4), +1 of matrix i (of its transpose with .trans)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col). Lane
// (g = lane / 4, t = lane % 4) holds c at rows g, g + 8, columns 2t, 2t + 1
// (c[0], c[1] row g; c[2], c[3] row g + 8)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats as a bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x; 2^-inf = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__host__ __device__ constexpr int lds() { return DP + 8; }

template <int DP>
__host__ __device__ constexpr size_t smem_bytes_bf16() {
  // six 64-row tiles (two fixed, two streamed in two stages) and the
  // streamed rows' lse and D, two stages each
  return 6 * size_t(64) * lds<DP>() * 2 + 4 * BQ * sizeof(float);
}

// A 64-row tile of `rows` rows of D elements (row stride `st`) into shared
// memory at leading dimension DP + 8, rows >= `rows` and columns >= D
// zero-filled; a null `src` fills zeros. With `vec`, 16-byte cp.async
// copies (the caller commits and waits), else element by element.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int rows, int D,
                                          bool vec) {
  constexpr int LDS = lds<DP>();
  if (src != nullptr && vec) {
    constexpr int CH = DP / 8;       // 16-byte chunks a row
    for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      bf16* d = dst + r * LDS + c;
      if (r < rows && c < D)
        cp_async16(smem_u32(d), src + r * st + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LDS + c] = (src != nullptr && r < rows && c < D)
                             ? src[r * st + c]
                             : __float2bfloat16(0.0f);
    }
  }
}

// The lse (in log2 units; +inf for dead rows and rows past the tile's
// `rows`, so that their P is 0) and D of a tile's rows from `row0`
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const Params& p, long long row0,
                                          int rows) {
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const float l = r < rows ? p.lse[row0 + r] : NEG;
    lse_s[r] = l > NEG / 2 ? l * LOG2E : INFINITY;
    d_s[r] = r < rows ? p.delta[row0 + r] : 0.0f;
  }
}

// acc (16 x 64: 8 n-tiles) = A (16 rows of `a` from row a0, DP wide) times
// B^T, B the 64 rows of `b` (DP wide): both read along DP
template <int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a,
                                        int a0, const bf16* b, int lane) {
  constexpr int LDS = lds<DP>();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldsm(af, smem_u32(a + (a0 + (lane & 15)) * LDS + kk * 16
                      + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm(bf, smem_u32(b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS
                        + kk * 16 + ((lane >> 3) & 1) * 8));
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x DP) += X (16 x 64, as f32 accumulator tiles, rounded to bf16)
// times the 64 rows of `b` (DP wide), read across its rows (.trans)
template <int DP>
__device__ __forceinline__ void mma_xb(float (&acc)[DP / 8][4],
                                       const float (&x)[8][4], const bf16* b,
                                       int lane) {
  constexpr int LDS = lds<DP>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // two adjacent 8-column accumulator tiles are one A fragment
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t bf[4];
      ldsm_t(bf, smem_u32(b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * LDS
                          + dp * 16 + (lane >> 4) * 8));
      mma(acc[2 * dp], af, bf[0], bf[1]);
      mma(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// rows [0, rows) of a warp's 16-row accumulator (rows g, g + 8 of the lane)
// times `mul` into a contiguous (rows, D) bf16 block at `dst`
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DP / 8][4],
                                           int r0, int rows, int D,
                                           float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= rows) continue;
    bf16* row = dst + (long long)r * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * tq;
      const float x0 = acc[n][2 * i] * mul, x1 = acc[n][2 * i + 1] * mul;
      if (pairs) {
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(row + c) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) row[c] = __float2bfloat16(x0);
        if (c + 1 < D) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_bf16(const __grid_constant__ Params p) {
  constexpr int LDS = lds<DP>();
  constexpr int TILE = 64 * LDS;
  constexpr int ND = DP / 8;         // 8-column tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;              // two stages
  bf16* dOs = Qs + 2 * TILE;         // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);
  float* d_s = lse_s + 2 * BQ;

  const int bkv = blockIdx.x, j0 = blockIdx.y * BK;
  const int b = bkv / p.H_kv, hk = bkv % p.H_kv;
  const int k_rows = min(BK, p.Tk - j0);
  const int kv_off = p.Tk - p.T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = warp * 16;          // the warp's first key in the tile
  const float sl2 = p.scale * LOG2E;

  load_tile<DP>(Ks, static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh
                        + (long long)j0 * p.k_st,
                p.k_st, k_rows, p.D, p.vec_k);
  load_tile<DP>(Vs, static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh
                        + (long long)j0 * p.v_st,
                p.v_st, k_rows, p.D, p.vec_v);

  // the q tiles that see this kv tile: from the one holding the first row
  // that sees key j0 (r0 < T: the last row sees every key)
  const int i_first = (p.causal ? max(0, j0 - kv_off) : 0) / BQ;
  const int n_q = (p.T + BQ - 1) / BQ - i_first;
  const int n_it = n_q * p.group;

  auto stage = [&](int it, int st) {
    const int h = hk * p.group + it / n_q;
    const int i0 = (i_first + it % n_q) * BQ;
    const int rows = min(BQ, p.T - i0);
    load_tile<DP>(Qs + st * TILE,
                  static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh
                      + (long long)i0 * p.q_st,
                  p.q_st, rows, p.D, p.vec_q);
    load_tile<DP>(dOs + st * TILE,
                  p.d_out == nullptr
                      ? nullptr
                      : static_cast<const bf16*>(p.d_out) + b * p.do_sb
                            + h * p.do_sh + (long long)i0 * p.do_st,
                  p.do_st, rows, p.D, p.vec_do);
    load_rows(lse_s + st * BQ, d_s + st * BQ, p,
              ((long long)b * p.H + h) * p.T + i0, rows);
    cp_async_commit();
  };

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  stage(0, 0);                       // with K and V
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      stage(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = (i_first + it % n_q) * BQ;
    const bf16* Q = Qs + st * TILE;
    const bf16* dO = dOs + st * TILE;
    const float* L = lse_s + st * BQ;
    const float* Dr = d_s + st * BQ;
    // the warp's keys past tk, or a key past the diagonal of the tile's
    // first row: mask this tile (rows past T have P = 0 through lse)
    const bool masked = j0 + kw + 16 > p.Tk
                        || (p.causal && j0 + kw + 15 > i0 + kv_off);

    // P^T (16 keys x 64 rows) from S^T = K Q^T
    float s[8][4];
    mma_abt<DP>(s, Ks, kw, Q, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * tq + (e & 1);
        float x = ex2(fmaf(s[n][e], sl2, -L[r]));
        if (masked) {
          const int key = j0 + kw + g + 8 * (e >> 1);
          if (key >= p.Tk || (p.causal && key > i0 + r + kv_off)) x = 0.0f;
        }
        s[n][e] = x;
      }
    // dV += P^T dO
    mma_xb<DP>(dv, s, dO, lane);
    // dS^T = P^T * (dP^T - D), dP^T = V dO^T
    float ds[8][4];
    mma_abt<DP>(ds, Vs, kw, dO, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = s[n][e] * (ds[n][e] - Dr[n * 8 + 2 * tq + (e & 1)]);
    // dK += dS^T Q
    mma_xb<DP>(dk, ds, Q, lane);
    __syncthreads();                 // stage st is refilled next iteration
  }

  const long long base = ((long long)bkv * p.Tk + j0) * p.D;
  store_rows<DP>(static_cast<bf16*>(p.dk) + base, dk, kw, k_rows, p.D,
                 p.scale, lane);
  store_rows<DP>(static_cast<bf16*>(p.dv) + base, dv, kw, k_rows, p.D, 1.0f,
                 lane);
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_bf16(const __grid_constant__ Params p) {
  constexpr int LDS = lds<DP>();
  constexpr int TILE = 64 * LDS;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;             // two stages
  bf16* Vs = Ks + 2 * TILE;          // two stages
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * TILE);
  float* d_s = lse_s + BQ;

  // heaviest causal tiles (the last q tiles) are scheduled first
  const int bh = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int bkv = bh / p.group;
  const int bk = bkv / p.H_kv, hk = bkv % p.H_kv;
  const int rows = min(BQ, p.T - i0);
  const int kv_off = p.Tk - p.T;
  const int kv_end = p.causal ? min(p.Tk, i0 + rows + kv_off) : p.Tk;
  const int n_kt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wq = warp * 16;          // the warp's first row in the tile
  // the kv tiles this warp needs: none past its last row's diagonal
  const int n_w = p.causal
                      ? max(0, min(n_kt, (i0 + wq + 16 + kv_off + BK - 1) / BK))
                      : n_kt;
  const float sl2 = p.scale * LOG2E;
  bf16* dq = static_cast<bf16*>(p.dq) + ((long long)bh * p.T + i0) * p.D;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  if (n_kt == 0) {                   // every row dead: dq = 0
    store_rows<DP>(dq, acc, wq, rows, p.D, 0.0f, lane);
    return;
  }

  load_tile<DP>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh
                        + (long long)i0 * p.q_st,
                p.q_st, rows, p.D, p.vec_q);
  load_tile<DP>(dOs,
                p.d_out == nullptr
                    ? nullptr
                    : static_cast<const bf16*>(p.d_out) + b * p.do_sb
                          + h * p.do_sh + (long long)i0 * p.do_st,
                p.do_st, rows, p.D, p.vec_do);
  load_rows(lse_s, d_s, p, (long long)bh * p.T + i0, rows);

  auto stage = [&](int j, int st) {
    const int k0 = j * BK;
    const int k_rows = min(BK, p.Tk - k0);
    load_tile<DP>(Ks + st * TILE,
                  static_cast<const bf16*>(p.k) + bk * p.k_sb + hk * p.k_sh
                      + (long long)k0 * p.k_st,
                  p.k_st, k_rows, p.D, p.vec_k);
    load_tile<DP>(Vs + st * TILE,
                  static_cast<const bf16*>(p.v) + bk * p.v_sb + hk * p.v_sh
                      + (long long)k0 * p.v_st,
                  p.v_st, k_rows, p.D, p.vec_v);
    cp_async_commit();
  };

  stage(0, 0);                       // with Q and dO
  float lr[2], dr[2];                // lse and D of the lane's two rows
  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      stage(j + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lr[i] = lse_s[wq + g + 8 * i];
        dr[i] = d_s[wq + g + 8 * i];
      }
    }
    if (j < n_w) {
      const int k0 = j * BK;
      const bf16* K = Ks + st * TILE;
      const bf16* V = Vs + st * TILE;
      const bool masked = k0 + BK > p.Tk
                          || (p.causal && k0 + BK - 1 > i0 + wq + kv_off);
      // P (16 rows x 64 keys) from S = Q K^T
      float s[8][4];
      mma_abt<DP>(s, Qs, wq, K, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(s[n][e], sl2, -lr[e >> 1]));
          if (masked) {
            const int key = k0 + n * 8 + 2 * tq + (e & 1);
            const int r = i0 + wq + g + 8 * (e >> 1);
            if (key >= p.Tk || (p.causal && key > r + kv_off)) x = 0.0f;
          }
          s[n][e] = x;
        }
      // dS = P * (dP - D), dP = dO V^T
      float ds[8][4];
      mma_abt<DP>(ds, dOs, wq, V, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = s[n][e] * (ds[n][e] - dr[e >> 1]);
      // dQ += dS K
      mma_xb<DP>(acc, ds, K, lane);
    }
    __syncthreads();                 // stage st is refilled next iteration
  }
  store_rows<DP>(dq, acc, wq, rows, p.D, p.scale, lane);
}

// ---------------------------------------------------- f32 (CUDA cores)

template <int DP>
__host__ __device__ constexpr int f_ld() { return DP + 1; }
__host__ __device__ constexpr int f_ldp() { return 64 + 1; }

template <int DP>
__host__ __device__ constexpr size_t f_smem_bytes() {
  // four 64-row operand tiles, two 64 x 64 score tiles, lse and D
  return 4 * size_t(64) * f_ld<DP>() * 4 + 2 * size_t(64) * f_ldp() * 4
         + 2 * BQ * sizeof(float);
}

// `rows` rows of D floats (row stride `st`) into a 64-row tile at leading
// dimension DP + 1, zero-filled past `rows` and D; a null `src` fills zeros
template <int DP>
__device__ __forceinline__ void f_load_tile(float* dst, const float* src,
                                            long long st, int rows, int D) {
  constexpr int LD = f_ld<DP>();
  for (int i = threadIdx.x; i < 64 * DP; i += F_NTHREADS) {
    const int r = i / DP, c = i % DP;
    dst[r * LD + c] =
        (src != nullptr && r < rows && c < D) ? src[r * st + c] : 0.0f;
  }
}

template <int DP>
__global__ void __launch_bounds__(F_NTHREADS)
flash_bwd_dkdv_f32(const __grid_constant__ Params p) {
  constexpr int LD = f_ld<DP>();
  constexpr int LDP = f_ldp();
  constexpr int NC = DP / 16;        // head-dim columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LD;         // P^T: (key, row)
  float* dSs = Ps + 64 * LDP;        // dS^T: (key, row)
  float* lse_s = dSs + 64 * LDP;
  float* d_s = lse_s + BQ;

  const int bkv = blockIdx.x, j0 = blockIdx.y * BK;
  const int b = bkv / p.H_kv, hk = bkv % p.H_kv;
  const int k_rows = min(BK, p.Tk - j0);
  const int kv_off = p.Tk - p.T;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sl2 = p.scale * LOG2E;

  f_load_tile<DP>(Ks, static_cast<const float*>(p.k) + b * p.k_sb
                          + hk * p.k_sh + (long long)j0 * p.k_st,
                  p.k_st, k_rows, p.D);
  f_load_tile<DP>(Vs, static_cast<const float*>(p.v) + b * p.v_sb
                          + hk * p.v_sh + (long long)j0 * p.v_st,
                  p.v_st, k_rows, p.D);
  const int i_first = (p.causal ? max(0, j0 - kv_off) : 0) / BQ;
  const int n_q = (p.T + BQ - 1) / BQ - i_first;

  // keys 4 ty + a; score rows tx + 16 c; head-dim columns tx + 16 c
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[a][c] = dv[a][c] = 0.0f;

  for (int it = 0; it < n_q * p.group; ++it) {
    const int h = hk * p.group + it / n_q;
    const int i0 = (i_first + it % n_q) * BQ;
    const int rows = min(BQ, p.T - i0);
    __syncthreads();                 // done with the previous tiles
    f_load_tile<DP>(Qs, static_cast<const float*>(p.q) + b * p.q_sb
                            + h * p.q_sh + (long long)i0 * p.q_st,
                    p.q_st, rows, p.D);
    f_load_tile<DP>(dOs,
                    p.d_out == nullptr
                        ? nullptr
                        : static_cast<const float*>(p.d_out) + b * p.do_sb
                              + h * p.do_sh + (long long)i0 * p.do_st,
                    p.do_st, rows, p.D);
    load_rows(lse_s, d_s, p, ((long long)b * p.H + h) * p.T + i0, rows);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kv[a] = Ks[(4 * ty + a) * LD + d];
        vv[a] = Vs[(4 * ty + a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = Qs[(tx + 16 * c) * LD + d];
        ov[c] = dOs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(kv[a], qv[c], s[a][c]);
          dp[a][c] = fmaf(vv[a], ov[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = j0 + 4 * ty + a, r = tx + 16 * c;
        float x = exp2f(fmaf(s[a][c], sl2, -lse_s[r]));
        if (key >= p.Tk || (p.causal && key > i0 + r + kv_off)) x = 0.0f;
        Ps[(4 * ty + a) * LDP + r] = x;
        dSs[(4 * ty + a) * LDP + r] = x * (dp[a][c] - d_s[r]);
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4], ov[NC], qv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pv[a] = Ps[(4 * ty + a) * LDP + r];
        sv[a] = dSs[(4 * ty + a) * LDP + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ov[c] = dOs[r * LD + tx + 16 * c];
        qv[c] = Qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[a][c] = fmaf(pv[a], ov[c], dv[a][c]);
          dk[a][c] = fmaf(sv[a], qv[c], dk[a][c]);
        }
    }
  }

  float* dkg = static_cast<float*>(p.dk) + ((long long)bkv * p.Tk + j0) * p.D;
  float* dvg = static_cast<float*>(p.dv) + ((long long)bkv * p.Tk + j0) * p.D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = 4 * ty + a;
    if (key >= k_rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) {
        dkg[(long long)key * p.D + col] = dk[a][c] * p.scale;
        dvg[(long long)key * p.D + col] = dv[a][c];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(F_NTHREADS)
flash_bwd_dq_f32(const __grid_constant__ Params p) {
  constexpr int LD = f_ld<DP>();
  constexpr int LDP = f_ldp();
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* dSs = Vs + 64 * LD;         // dS: (row, key)
  float* lse_s = dSs + 2 * 64 * LDP;
  float* d_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int bkv = bh / p.group;
  const int bk = bkv / p.H_kv, hk = bkv % p.H_kv;
  const int rows = min(BQ, p.T - i0);
  const int kv_off = p.Tk - p.T;
  const int kv_end = p.causal ? min(p.Tk, i0 + rows + kv_off) : p.Tk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sl2 = p.scale * LOG2E;

  f_load_tile<DP>(Qs, static_cast<const float*>(p.q) + b * p.q_sb
                          + h * p.q_sh + (long long)i0 * p.q_st,
                  p.q_st, rows, p.D);
  f_load_tile<DP>(dOs,
                  p.d_out == nullptr
                      ? nullptr
                      : static_cast<const float*>(p.d_out) + b * p.do_sb
                            + h * p.do_sh + (long long)i0 * p.do_st,
                  p.do_st, rows, p.D);
  load_rows(lse_s, d_s, p, (long long)bh * p.T + i0, rows);

  // rows 4 ty + a; score keys tx + 16 c; head-dim columns tx + 16 c
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int k_rows = min(BK, p.Tk - k0);
    __syncthreads();                 // done with the previous tiles
    f_load_tile<DP>(Ks, static_cast<const float*>(p.k) + bk * p.k_sb
                            + hk * p.k_sh + (long long)k0 * p.k_st,
                    p.k_st, k_rows, p.D);
    f_load_tile<DP>(Vs, static_cast<const float*>(p.v) + bk * p.v_sb
                            + hk * p.v_sh + (long long)k0 * p.v_st,
                    p.v_st, k_rows, p.D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = Qs[(4 * ty + a) * LD + d];
        ov[a] = dOs[(4 * ty + a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * LD + d];
        vv[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
          dp[a][c] = fmaf(ov[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 4 * ty + a, key = k0 + tx + 16 * c;
        float x = exp2f(fmaf(s[a][c], sl2, -lse_s[r]));
        if (key >= p.Tk || (p.causal && key > i0 + r + kv_off)) x = 0.0f;
        dSs[r * LDP + tx + 16 * c] = x * (dp[a][c] - d_s[r]);
      }
    __syncthreads();
    // dQ += dS K
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = dSs[(4 * ty + a) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(sv[a], kv[c], acc[a][c]);
    }
  }

  float* dqg = static_cast<float*>(p.dq) + ((long long)bh * p.T + i0) * p.D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) dqg[(long long)r * p.D + col] = acc[a][c] * p.scale;
    }
  }
}

// ------------------------------------------------------------- launchers

// the dynamic shared memory a kernel asks for, set once per device
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int dev, bool (&done)[64]) {
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int DP>
cudaError_t launch_bf16(const Params& p, int dev, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_bf16<DP>();
  static bool sized_kv[64] = {}, sized_q[64] = {};
  cudaError_t err = allow_smem(flash_bwd_dkdv_bf16<DP>, smem, dev, sized_kv);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_bf16<DP>, smem, dev, sized_q);
  if (err != cudaSuccess) return err;
  if (p.Tk > 0) {
    flash_bwd_dkdv_bf16<DP><<<dim3(p.B * p.H_kv, (p.Tk + BK - 1) / BK),
                              NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_bf16<DP><<<dim3(p.B * p.H, (p.T + BQ - 1) / BQ), NTHREADS,
                          smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const Params& p, int dev, cudaStream_t stream) {
  constexpr size_t smem = f_smem_bytes<DP>();
  static bool sized_kv[64] = {}, sized_q[64] = {};
  cudaError_t err = allow_smem(flash_bwd_dkdv_f32<DP>, smem, dev, sized_kv);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_f32<DP>, smem, dev, sized_q);
  if (err != cudaSuccess) return err;
  if (p.Tk > 0) {
    flash_bwd_dkdv_f32<DP><<<dim3(p.B * p.H_kv, (p.Tk + BK - 1) / BK),
                             F_NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_f32<DP><<<dim3(p.B * p.H, (p.T + BQ - 1) / BQ), F_NTHREADS,
                         smem, stream>>>(p);
  return cudaGetLastError();
}

// 16-byte copies of a bf16 operand: D, the strides and the base pointer
// are multiples of 16 bytes (a stride of 0 is one)
bool vec16(const void* ptr, long long sb, long long sh, long long st, int D) {
  return ptr != nullptr && D % 8 == 0
         && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0
         && sh % 8 == 0 && st % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, d_out and the grads);
// lse, d_lse and delta are f32, contiguous (B, H, T); dq, dk, dv are
// contiguous. Strides are in elements; the last dim of q, k, v, out and
// d_out must be contiguous. d_out or d_lse may be null (that cotangent is
// zero). Launches flash_bwd_prep, flash_bwd_dkdv and flash_bwd_dq on
// `device` (the current device is restored after) into `stream`. Returns 0
// on success, else a cudaError_t (see bigdl_cuda_error_string).
int bigdl_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* d_out, const void* d_lse, void* dq,
    void* dk, void* dv, void* delta, int B, int H, int H_kv, int T, int Tk,
    int D, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st,
    long long do_sb, long long do_sh, long long do_st, int dtype,
    int causal, float scale, int device, void* stream) {
  if (D < 1 || D > MAX_D || H_kv < 1 || H % H_kv != 0 || B < 1 || T < 1
      || Tk < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.d_out = d_out;
  p.lse = static_cast<const float*>(lse);
  p.d_lse = static_cast<const float*>(d_lse);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = static_cast<float*>(delta);
  p.B = B;
  p.H = H;
  p.H_kv = H_kv;
  p.T = T;
  p.Tk = Tk;
  p.D = D;
  p.group = H / H_kv;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.do_sb = do_sb;
  p.do_sh = do_sh;
  p.do_st = do_st;
  p.causal = causal;
  p.vec_q = vec16(q, q_sb, q_sh, q_st, D);
  p.vec_k = vec16(k, k_sb, k_sh, k_st, D);
  p.vec_v = vec16(v, v_sb, v_sh, v_st, D);
  p.vec_do = vec16(d_out, do_sb, do_sh, do_st, D);
  p.scale = scale;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * T;
  const dim3 prep_grid(static_cast<unsigned>((rows + PREP_ROWS - 1)
                                             / PREP_ROWS));
  if (dtype == 0)
    flash_bwd_prep<float><<<prep_grid, PREP_ROWS * 32, 0, s>>>(p);
  else
    flash_bwd_prep<bf16><<<prep_grid, PREP_ROWS * 32, 0, s>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    if (dtype == 0)
      err = D <= 64 ? launch_f32<64>(p, device, s)
                    : launch_f32<128>(p, device, s);
    else
      err = D <= 64 ? launch_bf16<64>(p, device, s)
                    : launch_bf16<128>(p, device, s);
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // extern "C"
