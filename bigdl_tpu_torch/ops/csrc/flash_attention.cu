// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the JAX package's one Pallas kernel,
//   bigdl_tpu/ops/flash_attention.py::_flash_kernel (launched by
//   _flash_forward, pallas_call at flash_attention.py:116).
// Computes exactly its (out, lse): online-softmax attention with m, l and
// the accumulator in f32; scale defaults to 1/sqrt(d) (set by the caller,
// of any sign); the causal mask is last-query-aligned (row r sees keys <=
// r + tk - t); kv tiles wholly above the diagonal are skipped; a row that
// sees no key emits 0 and lse = -1e30; with GQA, flattened q head bh reads
// kv head bh / group in place; q, k and v are read through their strides
// (last dim contiguous), so split views of a fused projection need no
// copy.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// flagship shape (B=4, H=8, H_kv=2, t=tk=2048, d=64, bf16, causal) the two
// products do 4 * d * (t*(t+1)/2) * B*H = 17.2 GFLOP against 21.2 MB of
// q/k/v/out/lse traffic: 17.4 us of tensor-core time against 6.3 us of
// memory time, so it is compute-bound.
//
// The first version of this kernel (WMMA, 64-row q tiles, 4 warps) took
// 22x that bound. WMMA fragments have no defined element-to-row map, so it
// (1) stored every score tile to shared memory as f32, (2) wrote P back as
// bf16, (3) kept the output accumulator in shared memory, rescaled there
// and reloaded into fragments for every P V product, (4) reloaded Q's
// fragments for every key sub-tile, (5) loaded K/V synchronously through
// registers between two barriers in one stage, (6) used ~70 KB of shared
// memory for 4 warps, and (7) took e^x through __expf of a scaled score.
//
// This design (bf16), point by point:
// (1)-(3) Both products run on wgmma.mma_async (m64nNk16, f32 accumulate),
//   one warpgroup per 64 query rows. The accumulator layout is defined:
//   lane (g = lane/4, t = lane%4) of warp w holds rows 16w+g and 16w+g+8
//   at columns 2t, 2t+1 of each 8-column tile. So S, P, m, l and O stay in
//   registers for the whole kv loop: a row's max and sum are reduced over
//   the four lanes that share it with two shuffles (l only once, at the
//   end), O is rescaled in registers, and the S accumulator of two
//   adjacent 8-key tiles is exactly a register A fragment of P V, so P is
//   rounded to bf16 in registers and never touches shared memory.
// (4) Q (A of Q K^T) and K (its K-major B) are read from shared memory
//   through descriptors; Q is loaded once per block. V is the MN-major B
//   of P V (tnspB). Tiles are stored in the 128-byte-swizzled layout, one
//   64-column atom (8 rows = 1024 bytes per swizzle period) after another.
// (5) One producer warp loads Q and the K/V tiles with TMA
//   (cp.async.bulk.tensor, 4-d tensor maps over (d, and the row, head and
//   batch strides of the caller's view), swizzle and ragged tails done by
//   the copy engine, zeros out of bounds) into a ring of NSTAGES stages,
//   handed over by mbarriers: full[s] counts the stage's bytes in,
//   empty[s] the consumer warps done with it. The warpgroups never wait on
//   a block-wide barrier and each runs at its own pace. On the card the
//   same pipeline fed by per-thread 16-byte cp.async copies was bound by
//   those copies (PERF.md); the copy engine's are not. A tensor map is
//   encoded on the host per call (three per launch); a map the driver
//   refuses is an error, never a silent slow path. Operands TMA cannot take
//   (d not a multiple of 8, strides or bases off 16 bytes, a zero stride),
//   as the wrapper decides, are stored element by element instead.
// (6) 128-row q tiles (two warpgroups plus the producer warp, 288
//   threads), 64-key kv tiles, two stages: 48 KB of shared memory at d <=
//   64 and at most 113 registers, so two blocks share an SM.
// (7) exp2 through ex2.approx with scale * log2(e) folded into one FMA per
//   score (a scale that is not positive is applied before the row max, one
//   FMUL more per score, in an instantiation of its own); masks only on the
//   tiles that cross the diagonal or the tk tail (a warp-uniform test per
//   tile); a warpgroup stops at its own last visible tile; the heaviest
//   causal q tiles are scheduled first.
// Head dims are zero-padded to DP = 64 or 128. f32 inputs, used by no main
// path, run the first version's loop on CUDA-core FMAs in full f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;              // keys per kv tile
constexpr int NWG = 2;              // warpgroups a block, 64 q rows each
constexpr int BQ = 64 * NWG;        // query rows per block (bf16)
constexpr int PRODUCER = 4 * NWG;   // the warp after the warpgroups loads
constexpr int NTHREADS = 128 * NWG + 32;
constexpr int NSTAGES = 2;          // K/V stages of the ring
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;       // the JAX kernel's _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr uint64_t SWIZZLE_128B = uint64_t(1) << 62;  // descriptor layout

struct Params {
  CUtensorMap qmap, kmap, vmap;     // bf16 with vec: 4-d maps, see encode
  int qpos[3], kpos[3], vpos[3];    // map dim of (row, head, batch)
  const void* q;
  const void* k;
  const void* v;
  void* out;                        // (B, H, T, D) contiguous, q's dtype
  float* lse;                       // (B, H, T) contiguous, f32
  int H, H_kv, T, Tk, D, DP, group;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  int causal, vec, n_qtiles;
  float scale;
};

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// ------------------------------------------------------------ bf16 kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory: init with an arrival count, arrive (plain or
// announcing the bytes a TMA copy will bring), wait for the phase of the
// given parity to complete
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: one 64-column box of `map` at (col, row, head, batch) into shared
// memory, completing on `bar`; pos gives the map dims of row, head, batch
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         const int (&pos)[3], int col,
                                         int row, int head, int batch,
                                         uint64_t* bar) {
  auto at = [&](int dim) {
    return pos[0] == dim ? row : pos[1] == dim ? head : batch;
  };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(at(1)), "r"(at(2)),
      "r"(at(3)), "r"(smem_u32(bar))
      : "memory");
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

// Byte offset of element (r, c) of a ROWS-row tile in the layout TMA's
// 128-byte swizzle writes: 64-column atoms of ROWS rows of 128 bytes, the
// 16-byte chunks of row r permuted by r % 8.
template <int ROWS>
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c / 64) * ROWS * 128 + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16)
         + (c % 8) * 2;
}

// The element-by-element copy for operands TMA cannot take: rows >= `rows`
// and columns >= D zero-filled, by the 32 lanes of one warp, then made
// visible to wgmma (the async proxy).
template <int ROWS, int DP>
__device__ __forceinline__ void store_tile(unsigned char* dst,
                                           const bf16* src, long long st,
                                           int rows, int D, int lane) {
  for (int i = lane; i < ROWS * DP; i += 32) {
    const int r = i / DP, c = i % DP;
    *reinterpret_cast<bf16*>(dst + swizzled<ROWS>(r, c)) =
        (r < rows && c < D) ? src[r * st + c] : __float2bfloat16(0.0f);
  }
  wgmma::fence_proxy_async();
}

template <int DP>
__host__ __device__ constexpr size_t smem_bytes_bf16() {
  return 1024                                    // room to align to 1024
         + size_t(BQ) * DP * 2                   // Q
         + 2 * NSTAGES * size_t(BK) * DP * 2     // K, V stages
         + 2 * NSTAGES * sizeof(uint64_t);       // full and empty barriers
}

// POS: scale > 0, so the row max of the raw scores is the max in log2
// units and the scale folds into the exponent's FMA
template <int DP, bool POS>
__global__ void __launch_bounds__(NTHREADS, DP <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const __grid_constant__ Params p) {
  constexpr int KD = DP / 16;       // k-steps of Q K^T
  constexpr int NS = BK / 8;        // 8-key column tiles of S
  constexpr int NO = DP / 8;        // 8-column tiles of O
  constexpr int KVB = BK * DP * 2;  // bytes of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms must start on 1024 bytes
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + BQ * DP * 2;
  unsigned char* Vs = Ks + NSTAGES * KVB;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NSTAGES * KVB);
  uint64_t* empty = full + NSTAGES;

  // heaviest causal tiles (the last q tiles) are scheduled first
  const int bh = blockIdx.x;
  const int q0 = (p.n_qtiles - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int bkv = bh / p.group;
  const int bk = bkv / p.H_kv, hk = bkv % p.H_kv;
  const int q_rows = min(BQ, p.T - q0);
  const int kv_off = p.Tk - p.T;
  // keys past the last visible one of this tile's last row are never needed
  const int kv_end = p.causal ? min(p.Tk, q0 + q_rows + kv_off) : p.Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wq = warp * 16;         // this warp's first row in the q tile
  const int wr0 = q0 + wq;          // ... and in the sequence
  const int gr0 = q0 + (warp / 4) * 64;  // its warpgroup's first row
  // the kv tiles this warpgroup needs: none past its last row's diagonal
  const int n_wg =
      gr0 >= p.T ? 0
      : p.causal ? max(0, min(n_tiles, (gr0 + 64 + kv_off + BK - 1) / BK))
                 : n_tiles;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER) {
    // Q rides with tile 0; a stage is refilled once every consumer warp
    // has released it
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NSTAGES, k0 = j * BK;
      if (j >= NSTAGES) mbar_wait(empty + st, ((j / NSTAGES) - 1) & 1);
      unsigned char* kt = Ks + st * KVB;
      unsigned char* vt = Vs + st * KVB;
      if (p.vec) {
        if (lane == 0) {
          mbar_arrive_tx(full + st, 2 * KVB + (j == 0 ? BQ * DP * 2 : 0));
#pragma unroll
          for (int a = 0; a < DP / 64; ++a) {
            if (j == 0)
              tma_load(Qs + a * BQ * 128, &p.qmap, p.qpos, a * 64, q0, h, b,
                       full + st);
            tma_load(kt + a * BK * 128, &p.kmap, p.kpos, a * 64, k0, hk, bk,
                     full + st);
            tma_load(vt + a * BK * 128, &p.vmap, p.vpos, a * 64, k0, hk, bk,
                     full + st);
          }
        }
      } else {
        const bf16* kg = static_cast<const bf16*>(p.k) + bk * p.k_sb
                         + hk * p.k_sh + (long long)k0 * p.k_st;
        const bf16* vg = static_cast<const bf16*>(p.v) + bk * p.v_sb
                         + hk * p.v_sh + (long long)k0 * p.v_st;
        const int rows = min(BK, p.Tk - k0);
        if (j == 0)
          store_tile<BQ, DP>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb
                                     + h * p.q_sh + (long long)q0 * p.q_st,
                             p.q_st, q_rows, p.D, lane);
        store_tile<BK, DP>(kt, kg, p.k_st, rows, p.D, lane);
        store_tile<BK, DP>(vt, vg, p.v_st, rows, p.D, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
  } else {
    // rows g (index 0) and g + 8 (index 1) of the warp's 16; m in log2
    // units (scores times scale * log2 e); l summed over the row's lanes at
    // the end
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
    uint32_t pa[BK / 16][4];        // P of one tile as A fragments of P V
    const float sl2 = p.scale * LOG2E;
    const uint32_t qt = smem_u32(Qs) + (warp / 4) * 64 * 128;

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NSTAGES, k0 = j * BK;
      mbar_wait(full + st, (j / NSTAGES) & 1);
      if (j < n_wg) {
        const uint32_t kt = smem_u32(Ks + st * KVB);
        const uint32_t vt = smem_u32(Vs + st * KVB);

        // S = Q K^T for the warpgroup's 64 rows: Q and K are K-major, a
        // k-step is 32 bytes into a 64-column atom
        float s[BK / 2];
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          wgmma::SS<BK>::mma(
              s,
              wgmma::desc(qt + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024)
                  | SWIZZLE_128B,
              wgmma::desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024)
                  | SWIZZLE_128B,
              kk > 0);
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::hold(s);
        if constexpr (!POS) {
          // to log2 units before the max, so a scale of any sign is right
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
        }

        // mask only where the tile crosses the diagonal or the tk tail
        if (k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > wr0 + kv_off)) {
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + n * 8 + 2 * tq + (e & 1);
              const int row = wr0 + g + (e >> 1) * 8;
              if (col >= p.Tk || (p.causal && col > row + kv_off))
                s[4 * n + e] = -INFINITY;
            }
        }

        // online softmax; P overwrites S in place
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        float corr[2], neg_m[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          // a row with nothing visible yet keeps m = NEG, so corr = 1 and
          // its masked scores (-inf) give p = 0: l stays 0
          const float m_new = fmaxf(m[i], POS ? mx[i] * sl2 : mx[i]);
          corr[i] = ex2(m[i] - m_new);
          m[i] = m_new;
          neg_m[i] = -m_new;
        }
        float rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float nm = neg_m[(i >> 1) & 1];
          s[i] = ex2(POS ? fmaf(s[i], sl2, nm) : s[i] + nm);
          rs[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        // two adjacent 8-key S tiles are one A fragment of P
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

        // O += P V: V is MN-major; a k-step is 16 keys (2048 bytes), the
        // next 64 columns of d the next atom
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma::RS<DP>::mma(
              o, pa[kk],
              wgmma::desc(vt + kk * 2048, BK * 128, 1024) | SWIZZLE_128B);
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::hold(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma::hold(pa[kk]);
      }
      __syncwarp();                 // the warp is done with stage st
      if (lane == 0) mbar_arrive(empty + st);
    }

    // finalize: out = acc / l (0 for a dead row), lse = m + log(l) or -1e30
    const bool pairs = (p.D & 1) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int r = wq + g + i * 8;   // row within the q tile
      if (r >= q_rows) continue;
      const float den = li > 0.0f ? li : 1.0f;
      bf16* og = static_cast<bf16*>(p.out)
                 + ((long long)bh * p.T + q0 + r) * p.D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + 2 * tq;
        const float x0 = o[4 * n + 2 * i] / den;
        const float x1 = o[4 * n + 2 * i + 1] / den;
        if (pairs) {
          if (c < p.D)
            *reinterpret_cast<__nv_bfloat162*>(og + c) =
                __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < p.D) og[c] = __float2bfloat16(x0);
          if (c + 1 < p.D) og[c + 1] = __float2bfloat16(x1);
        }
      }
      if (tq == 0)
        p.lse[(long long)bh * p.T + q0 + r] =
            li > 0.0f ? m[i] * LN2 + logf(li) : NEG;
    }
  }
}

// errors of the entry point beside cudaError_t's (which are positive)
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_MAP_REFUSED = -2;

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no link against the driver
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 4-d bf16 tensor map of a (batch, head, row, D) view with element
// strides (sb, sh, st, 1): dim 0 is d, dims 1-3 are row, head and batch
// in ascending order of stride (pos[i]: the dim of row, head, batch). The
// box is 64 columns (one 128-byte swizzle atom) by box_rows rows; out of
// bounds reads as zeros. False if the driver refuses it or is too old to
// encode one.
bool encode_map(CUtensorMap* map, int (&pos)[3], const void* ptr, int D,
                int rows, int heads, int batch, long long st, long long sh,
                long long sb, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  long long size[3] = {rows, heads, batch}, stride[3] = {st, sh, sb};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int k = i; k > 0 && stride[order[k]] < stride[order[k - 1]]; --k) {
      const int t = order[k];
      order[k] = order[k - 1];
      order[k - 1] = t;
    }
  cuuint64_t dims[4] = {cuuint64_t(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, ones[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = cuuint64_t(size[order[i]]);
    strides[i] = cuuint64_t(stride[order[i]]) * 2;
    if (order[i] == 0) box[i + 1] = cuuint32_t(box_rows);
    pos[order[i]] = i + 1;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool POS>
int launch_bf16(Params& p, int B, int dev, cudaStream_t stream) {
  if (p.vec) {
    if (encoder() == nullptr) return ERR_NO_ENCODER;
    if (!encode_map(&p.qmap, p.qpos, p.q, p.D, p.T, p.H, B, p.q_st, p.q_sh,
                    p.q_sb, BQ)
        || !encode_map(&p.kmap, p.kpos, p.k, p.D, p.Tk, p.H_kv, B, p.k_st,
                       p.k_sh, p.k_sb, BK)
        || !encode_map(&p.vmap, p.vpos, p.v, p.D, p.Tk, p.H_kv, B, p.v_st,
                       p.v_sh, p.v_sb, BK))
      return ERR_MAP_REFUSED;
  }
  constexpr size_t smem = smem_bytes_bf16<DP>();
  static bool sized[64] = {};       // once per device and instantiation
  if (dev >= 64 || !sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<DP, POS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) sized[dev] = true;
  }
  const dim3 grid(B * p.H, (p.T + BQ - 1) / BQ);
  p.n_qtiles = grid.y;
  flash_fwd_bf16_kernel<DP, POS><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------- f32 kernel (CUDA cores)

constexpr int F_BQ = 64;            // query rows per block
constexpr int F_BK = 64;            // keys per kv tile
constexpr int F_NTHREADS = 128;     // 4 warps of 16 rows, two lanes a row

__host__ __device__ constexpr int f_ld(int dp) { return dp + 4; }
__host__ __device__ constexpr int f_ldp() { return F_BK + 4; }

__host__ __device__ constexpr size_t f_smem_bytes(int dp) {
  return align128(sizeof(float) * F_BQ * f_ld(dp))         // Q tile
         + 2 * align128(sizeof(float) * F_BK * f_ld(dp))   // K, V tiles
         + align128(sizeof(float) * F_BQ * f_ldp())        // P
         + align128(sizeof(float) * F_BQ * f_ld(dp))       // accumulator
         + 2 * align128(sizeof(float) * F_BQ);             // m, l
}

// Copy `rows` rows of D elements (row stride `st`) into a (ROWS, DP) shared
// tile of leading dimension `ld`, zero-filling rows >= `rows` and columns
// >= D. `vec`: D, the strides and the base are multiples of 16 bytes.
template <int ROWS>
__device__ void load_tile_f32(float* dst, int ld, const float* src,
                              long long st, int rows, int D, int DP,
                              bool vec) {
  if (vec) {
    const int per_row = DP / 4;
    for (int i = threadIdx.x; i < ROWS * per_row; i += F_NTHREADS) {
      const int r = i / per_row, c = (i % per_row) * 4;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && c < D)
        val = *reinterpret_cast<const float4*>(src + r * st + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += F_NTHREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] = (r < rows && c < D) ? src[r * st + c] : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(F_NTHREADS)
flash_fwd_f32_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int DP = p.DP;
  const int LDT = f_ld(DP);
  constexpr int LDP = f_ldp();
  const int LDO = f_ld(DP);

  unsigned char* base = smem;
  float* Qs = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * F_BQ * LDT);
  float* Ks = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * F_BK * LDT);
  float* Vs = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * F_BK * LDT);
  float* P = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * F_BQ * LDP);
  float* O = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * F_BQ * LDO);
  float* m_s = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * F_BQ);
  float* l_s = reinterpret_cast<float*>(base);

  // heaviest causal tiles (the last q tiles) are scheduled first
  const int bh = blockIdx.x;
  const int q0 = (p.n_qtiles - 1 - blockIdx.y) * F_BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int bkv = bh / p.group;
  const int bk = bkv / p.H_kv, hk = bkv % p.H_kv;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb
                    + h * p.q_sh + (long long)q0 * p.q_st;
  const float* kg = static_cast<const float*>(p.k) + bk * p.k_sb
                    + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bk * p.v_sb
                    + hk * p.v_sh;
  const int q_rows = min(F_BQ, p.T - q0);
  const int kv_off = p.Tk - p.T;
  // keys past the last visible one of this tile's last row are never needed
  const int kv_end = p.causal ? min(p.Tk, q0 + q_rows + kv_off) : p.Tk;
  const bool vec = p.vec != 0;

  load_tile_f32<F_BQ>(Qs, LDT, qg, p.q_st, q_rows, p.D, DP, vec);
  for (int i = threadIdx.x; i < F_BQ * LDO; i += F_NTHREADS) O[i] = 0.0f;
  for (int i = threadIdx.x; i < F_BQ; i += F_NTHREADS) {
    m_s[i] = NEG;
    l_s[i] = 0.0f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int row = warp * 16 + (lane >> 1);  // this lane's row in the tile
  const int gr = q0 + row;                  // and in the sequence

  for (int k0 = 0; k0 < kv_end; k0 += F_BK) {
    const int k_rows = min(F_BK, p.Tk - k0);
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile_f32<F_BK>(Ks, LDT, kg + k0 * p.k_st, p.k_st, k_rows, p.D, DP,
                        vec);
    load_tile_f32<F_BK>(Vs, LDT, vg + k0 * p.v_st, p.v_st, k_rows, p.D, DP,
                        vec);
    __syncthreads();

    // scores of this lane's row at columns 2c + half, c < 32
    float sv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) sv[c] = 0.0f;
    for (int kk = 0; kk < DP; ++kk) {
      const float qv = Qs[row * LDT + kk];
#pragma unroll
      for (int c = 0; c < 32; ++c)
        sv[c] = fmaf(qv, Ks[(2 * c + half) * LDT + kk], sv[c]);
    }

    // online-softmax update of this lane's row (two lanes per row)
    const float m_prev = m_s[row];
    const float l_prev = l_s[row];
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kc = k0 + 2 * c + half;
      const bool ok = kc < p.Tk && (!p.causal || kc <= gr + kv_off);
      sv[c] = ok ? sv[c] * p.scale : NEG;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kc = k0 + 2 * c + half;
      const bool ok = kc < p.Tk && (!p.causal || kc <= gr + kv_off);
      // masked entries are zeroed so a fully masked row keeps l == 0
      const float pv = ok ? __expf(sv[c] - m_new) : 0.0f;
      sum += pv;
      P[row * LDP + 2 * c + half] = pv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = __expf(m_prev - m_new);
    for (int c = half; c < DP; c += 2) O[row * LDO + c] *= corr;
    __syncwarp();
    if (half == 0) {
      m_s[row] = m_new;
      l_s[row] = l_prev * corr + sum;
    }

    // O += P V for this lane's row
    for (int c = half; c < DP; c += 2) {
      float acc = O[row * LDO + c];
      for (int j = 0; j < F_BK; ++j)
        acc = fmaf(P[row * LDP + j], Vs[j * LDT + c], acc);
      O[row * LDO + c] = acc;
    }
    __syncwarp();
  }

  __syncthreads();
  // finalize: out = acc / l (0 for a dead row), lse = m + log(l) or -1e30
  float* og = static_cast<float*>(p.out) + ((long long)bh * p.T + q0) * p.D;
  for (int i = threadIdx.x; i < q_rows * p.D; i += F_NTHREADS) {
    const int r = i / p.D, c = i % p.D;
    const float l = l_s[r];
    og[i] = O[r * LDO + c] / (l > 0.0f ? l : 1.0f);
  }
  float* lg = p.lse + (long long)bh * p.T + q0;
  for (int r = threadIdx.x; r < q_rows; r += F_NTHREADS) {
    const float l = l_s[r];
    lg[r] = l > 0.0f ? m_s[r] + logf(l) : NEG;
  }
}

cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = f_smem_bytes(p.DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.T + F_BQ - 1) / F_BQ);
  Params pp = p;
  pp.n_qtiles = grid.y;
  flash_fwd_f32_kernel<<<grid, F_NTHREADS, smem, stream>>>(pp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim
// of q, k and v must be contiguous. vec (bf16): load through TMA tensor
// maps, else element by element. Launches on `device` (the current device
// is restored after) into `stream`. Returns 0 on success, else a
// cudaError_t or one of the ERR_ codes above (see
// bigdl_cuda_error_string).
int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int H, int H_kv, int T, int Tk, int D,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    int dtype, int causal, float scale, int vec, int device, void* stream) {
  if (D < 1 || D > MAX_D || H_kv < 1 || H % H_kv != 0 || B < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.H_kv = H_kv;
  p.T = T;
  p.Tk = Tk;
  p.D = D;
  p.DP = (D + 15) / 16 * 16;
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
  p.causal = causal;
  p.vec = vec;
  p.n_qtiles = 0;                   // set by the launcher from its q tile
  p.scale = scale;
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pos = scale > 0.0f;
  int res;
  if (dtype == 0)
    res = static_cast<int>(launch_f32(p, B, s));
  else if (D <= 64)
    res = pos ? launch_bf16<64, true>(p, B, device, s)
              : launch_bf16<64, false>(p, B, device, s);
  else
    res = pos ? launch_bf16<128, true>(p, B, device, s)
              : launch_bf16<128, false>(p, B, device, s);
  if (prev != device) cudaSetDevice(prev);
  return res;
}

const char* bigdl_cuda_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == ERR_MAP_REFUSED)
    return "the CUDA driver refused a TMA tensor map of q, k or v";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
