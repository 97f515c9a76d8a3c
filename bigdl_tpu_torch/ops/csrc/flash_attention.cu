// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the JAX package's one Pallas kernel,
//   bigdl_tpu/ops/flash_attention.py::_flash_kernel (launched by
//   _flash_forward, pallas_call at flash_attention.py:116).
// Computes exactly its (out, lse): online-softmax attention with m, l and
// the accumulator in f32; scale defaults to 1/sqrt(d) (set by the caller);
// the causal mask is last-query-aligned (row r sees keys <= r + tk - t);
// kv tiles wholly above the diagonal are skipped; a row that sees no key
// emits 0 and lse = -1e30; with GQA, flattened q head bh reads kv head
// bh / group.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// flagship shape (B=4, H=8, H_kv=2, t=tk=2048, d=64, bf16, causal) the two
// products do 4 * d * (t*(t+1)/2) * B*H = 17.2 GFLOP against 21.2 MB of
// q/k/v/out/lse traffic: 17.4 us of tensor-core time against 6.3 us of
// memory time, so it is compute-bound.
//
// What this design does about it: one thread block per (flattened q head,
// 64-row q tile), looping over 64-row kv tiles inside the block (the TPU's
// sequential kv grid axis becomes that loop). K/V tiles are staged in shared
// memory and each is read from device memory once per q tile. In bf16 both
// products (Q K^T and P V) run on the tensor cores through WMMA
// m16n16k16 fragments with f32 accumulation; scores, m, l and the
// accumulator stay f32 in shared memory, and P is rounded to bf16 only as the
// A operand of P V. Each warp owns 16 query rows, so the softmax update
// needs no block-wide barrier. f32 inputs run the same loop on CUDA-core
// FMAs in full f32. Tails of t, tk and d that do not fill a tile are
// guarded (zero-filled on load, masked in the softmax, never stored).
// It is a first, simple kernel: no TMA, no wgmma, no warp specialisation
// and no double buffering, so it does not reach the bound above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int NWARPS = 4;           // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;       // the JAX kernel's _NEG_INF

struct Params {
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

// Shared-memory leading dimensions: padded rows keep WMMA fragment pointers
// 32-byte aligned and spread rows over banks.
template <typename T>
__host__ __device__ constexpr int ld_tile(int dp) {
  return dp + (sizeof(T) == 2 ? 8 : 4);
}
__host__ __device__ constexpr int ld_s() { return BK + 4; }
template <typename T>
__host__ __device__ constexpr int ld_p() {
  return BK + (sizeof(T) == 2 ? 8 : 4);
}
__host__ __device__ constexpr int ld_o(int dp) { return dp + 4; }

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return align128(sizeof(T) * BQ * ld_tile<T>(dp))         // Q tile
         + 2 * align128(sizeof(T) * BK * ld_tile<T>(dp))   // K, V tiles
         + align128(sizeof(float) * BQ * ld_s())           // scores
         + align128(sizeof(T) * BQ * ld_p<T>())            // P
         + align128(sizeof(float) * BQ * ld_o(dp))         // accumulator
         + 2 * align128(sizeof(float) * BQ);               // m, l
}

// Copy `rows` rows of D elements (row stride `st`) into a (ROWS, DP) shared
// tile of leading dimension `ld`, zero-filling rows >= `rows` and columns
// >= D. `vec`: D, the strides and the base are multiples of 16 bytes.
template <typename T, int ROWS>
__device__ void load_tile(T* dst, int ld, const T* src, long long st,
                          int rows, int D, int DP, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = DP / V;
    for (int i = threadIdx.x; i < ROWS * per_row; i += NTHREADS) {
      const int r = i / per_row, c = (i % per_row) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < D)
        val = *reinterpret_cast<const uint4*>(src + r * st + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      T val;
      if (r < rows && c < D) {
        val = src[r * st + c];
      } else {
        val = T(0.0f);
      }
      dst[r * ld + c] = val;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];

  const int DP = p.DP;
  const int LDT = ld_tile<T>(DP);
  constexpr int LDS = ld_s();
  constexpr int LDP = ld_p<T>();
  const int LDO = ld_o(DP);

  unsigned char* base = smem;
  T* Qs = reinterpret_cast<T*>(base);
  base += align128(sizeof(T) * BQ * LDT);
  T* Ks = reinterpret_cast<T*>(base);
  base += align128(sizeof(T) * BK * LDT);
  T* Vs = reinterpret_cast<T*>(base);
  base += align128(sizeof(T) * BK * LDT);
  float* S = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * BQ * LDS);
  T* P = reinterpret_cast<T*>(base);
  base += align128(sizeof(T) * BQ * LDP);
  float* O = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * BQ * LDO);
  float* m_s = reinterpret_cast<float*>(base);
  base += align128(sizeof(float) * BQ);
  float* l_s = reinterpret_cast<float*>(base);

  // heaviest causal tiles (the last q tiles) are scheduled first
  const int bh = blockIdx.x;
  const int q0 = (p.n_qtiles - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int bkv = bh / p.group;
  const int bk = bkv / p.H_kv, hk = bkv % p.H_kv;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
                + (long long)q0 * p.q_st;
  const T* kg = static_cast<const T*>(p.k) + bk * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bk * p.v_sb + hk * p.v_sh;
  const int q_rows = min(BQ, p.T - q0);
  const int kv_off = p.Tk - p.T;
  // keys past the last visible one of this tile's last row are never needed
  const int kv_end = p.causal ? min(p.Tk, q0 + q_rows + kv_off) : p.Tk;
  const bool vec = p.vec != 0;

  load_tile<T, BQ>(Qs, LDT, qg, p.q_st, q_rows, p.D, DP, vec);
  for (int i = threadIdx.x; i < BQ * LDO; i += NTHREADS) O[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    m_s[i] = NEG;
    l_s[i] = 0.0f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int row = warp * 16 + (lane >> 1);  // this lane's row in the tile
  const int gr = q0 + row;                  // and in the sequence

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int k_rows = min(BK, p.Tk - k0);
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<T, BK>(Ks, LDT, kg + k0 * p.k_st, p.k_st, k_rows, p.D, DP, vec);
    load_tile<T, BK>(Vs, LDT, vg + k0 * p.v_st, p.v_st, k_rows, p.D, DP, vec);
    __syncthreads();

    // scores of this lane's row at columns 2c + half, c < 32
    float sv[32];
    if constexpr (TC) {
      using namespace nvcuda;
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> kb;
          wmma::load_matrix_sync(a, Qs + warp * 16 * LDT + kk * 16, LDT);
          wmma::load_matrix_sync(kb, Ks + j * 16 * LDT + kk * 16, LDT);
          wmma::mma_sync(acc, a, kb, acc);
        }
        wmma::store_matrix_sync(S + warp * 16 * LDS + j * 16, acc, LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; ++c) sv[c] = S[row * LDS + 2 * c + half];
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) sv[c] = 0.0f;
      for (int kk = 0; kk < DP; ++kk) {
        const float qv = Qs[row * LDT + kk];
#pragma unroll
        for (int c = 0; c < 32; ++c)
          sv[c] = fmaf(qv, Ks[(2 * c + half) * LDT + kk], sv[c]);
      }
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
      P[row * LDP + 2 * c + half] = from_float<T>(pv);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = __expf(m_prev - m_new);
    for (int c = half; c < DP; c += 2) O[row * LDO + c] *= corr;
    __syncwarp();
    if (half == 0) {
      m_s[row] = m_new;
      l_s[row] = l_prev * corr + sum;
    }

    // O += P V for this warp's 16 rows
    if constexpr (TC) {
      using namespace nvcuda;
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, O + warp * 16 * LDO + j * 16, LDO,
                               wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> vb;
          wmma::load_matrix_sync(a, P + warp * 16 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(vb, Vs + kk * 16 * LDT + j * 16, LDT);
          wmma::mma_sync(acc, a, vb, acc);
        }
        wmma::store_matrix_sync(O + warp * 16 * LDO + j * 16, acc, LDO,
                                wmma::mem_row_major);
      }
    } else {
      for (int c = half; c < DP; c += 2) {
        float acc = O[row * LDO + c];
        for (int j = 0; j < BK; ++j)
          acc = fmaf(P[row * LDP + j], Vs[j * LDT + c], acc);
        O[row * LDO + c] = acc;
      }
    }
    __syncwarp();
  }

  __syncthreads();
  // finalize: out = acc / l (0 for a dead row), lse = m + log(l) or -1e30
  T* og = static_cast<T*>(p.out) + ((long long)bh * p.T + q0) * p.D;
  for (int i = threadIdx.x; i < q_rows * p.D; i += NTHREADS) {
    const int r = i / p.D, c = i % p.D;
    const float l = l_s[r];
    og[i] = from_float<T>(O[r * LDO + c] / (l > 0.0f ? l : 1.0f));
  }
  float* lg = p.lse + (long long)bh * p.T + q0;
  for (int r = threadIdx.x; r < q_rows; r += NTHREADS) {
    const float l = l_s[r];
    lg[r] = l > 0.0f ? m_s[r] + logf(l) : NEG;
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, p.n_qtiles);
  flash_fwd_kernel<T><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim
// of q, k and v must be contiguous. Returns a cudaError_t (0 on success).
int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int H, int H_kv, int T, int Tk, int D,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    int dtype, int causal, float scale, int vec, void* stream) {
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
  p.n_qtiles = (T + BQ - 1) / BQ;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(p, B, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(p, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
