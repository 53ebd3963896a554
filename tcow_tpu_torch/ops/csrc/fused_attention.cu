// Fused multi-head self-attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces: tcow_tpu/ops/pallas_attention.py:_kernel (:87-155), the Pallas TPU kernel
// behind fused_attention (:171) with rope off and no residual outputs. It computes
//   qkv  = (x . qkv_w + qkv_b) in f32, cast to the compute dtype       (:101-104)
//   attn = per head softmax_mask(q k^T * dh^-0.5) v, f32 logits and f32 softmax, the
//          probabilities cast to the compute dtype before P.v, f32 accumulation (:130-146)
//   out  = (attn . proj_w + proj_b) in f32, cast to the compute dtype   (:147-150)
// as a chain of three launches: gemm_bias -> attn_core -> gemm_bias. The TPU layout is
// not carried over: no 128-row sequence packing with a block-diagonal mask, no VMEM
// group picker, no padding of S.
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s): at the config of record
// (D=768, 12 heads, dh=64) one temporal call (600 sequences of 30) is ~86.6 GFLOP
// (qkv 63.7, proj 21.2, scores+PV 1.7 counted over the full square) and one spatial call
// (60 sequences of 301) ~101.9 GFLOP (63.9 + 21.3 + 16.7), against ~65 MB of compulsory
// traffic: about 1300 FLOP per byte, so the call is compute-bound, ~88 us and ~103 us.
// What the design does about that bound: nothing yet. The GEMMs use wmma bf16 tensor-core
// tiles without a copy pipeline; attn_core runs on the CUDA cores in f32 and computes
// the logits twice (two passes, see below); qkv and attn make a round trip through HBM.
// wgmma, TMA and fusing the three stages are later work.
//
// attn_core keeps the rounding points of the plain version (attention_ref): pass 1 over
// the key tiles finds each row's max and sum of exp, pass 2 recomputes the same logits,
// forms p = exp(l - m) / s, rounds p to the compute dtype and accumulates p.v in f32. An
// online softmax would rescale partial outputs and round elsewhere. Shared memory is
// bounded for any S: one query tile, one key tile and one value tile at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// ---------------------------------------------------------------------------------------
// gemm_bias: C (M, N) = cast_T(A (M, K) . cast_T(W (K, N) f32) + bias (N) f32), the sum
// and the bias in f32. Needs K % 8 == 0, N % 4 == 0 and 16-byte aligned pointers.
// ---------------------------------------------------------------------------------------

// bf16: wmma 16x16x16 tensor-core tiles. Block tile 128x128x32, 8 warps as 4 (M) x 2 (N),
// each warp 32x64 = 2x4 accumulator fragments.
constexpr int GB_M = 128, GB_N = 128, GB_K = 32, GB_THREADS = 256;
constexpr int GA_LD = GB_K + 8;    // bf16 elements; rows stay 16-byte aligned
constexpr int GW_LD = GB_N + 8;

__global__ void __launch_bounds__(GB_THREADS)
gemm_bias_bf16(const bf16* __restrict__ A, const float* __restrict__ W,
               const float* __restrict__ bias, bf16* __restrict__ C, int M, int N, int K) {
    using namespace nvcuda;
    __shared__ __align__(128) bf16 As[GB_M * GA_LD];
    __shared__ __align__(128) bf16 Ws[GB_K * GW_LD];
    __shared__ __align__(128) float Cs[GB_THREADS / 32][16 * 16];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wm = warp / 2, wn = warp % 2;
    const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += GB_K) {
        // A tile: 128 rows x 32 bf16, 16 bytes (8 values) per load.
        for (int i = tid; i < GB_M * (GB_K / 8); i += GB_THREADS) {
            const int r = i / (GB_K / 8), c = (i % (GB_K / 8)) * 8;
            const int gr = m0 + r, gc = k0 + c;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (gr < M && gc < K) v = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + gc);
            *reinterpret_cast<uint4*>(As + r * GA_LD + c) = v;
        }
        // W tile: 32 rows x 128 f32, read as float4 and rounded to bf16.
        for (int i = tid; i < GB_K * (GB_N / 4); i += GB_THREADS) {
            const int r = i / (GB_N / 4), c = (i % (GB_N / 4)) * 4;
            const int gr = k0 + r, gc = n0 + c;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (gr < K && gc < N) v = *reinterpret_cast<const float4*>(W + (size_t)gr * N + gc);
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Ws + r * GW_LD + c);
            dst[0] = __floats2bfloat162_rn(v.x, v.y);
            dst[1] = __floats2bfloat162_rn(v.z, v.w);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GB_K; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * GA_LD + kk, GA_LD);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wmma::load_matrix_sync(b[j], Ws + kk * GW_LD + wn * 64 + j * 16, GW_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    // Epilogue: each warp stages one 16x16 fragment at a time, adds the bias in f32,
    // rounds once and writes the rows that exist.
    float* cs = Cs[warp];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int rb = m0 + wm * 32 + i * 16, cb = n0 + wn * 64 + j * 16;
            for (int e = lane; e < 256; e += 32) {
                const int gr = rb + e / 16, gc = cb + e % 16;
                if (gr < M && gc < N) C[(size_t)gr * N + gc] = __float2bfloat16(cs[e] + bias[gc]);
            }
            __syncwarp();
        }
    }
}

// f32: CUDA-core FMA, for parity runs on the card. Block tile 64x64x16, 256 threads,
// 4x4 outputs each.
constexpr int GF_T = 64, GF_K = 16;

__global__ void __launch_bounds__(256)
gemm_bias_f32(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
    __shared__ float As[GF_K][GF_T + 4];   // transposed: As[k][m]
    __shared__ float Ws[GF_K][GF_T + 4];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * GF_T, n0 = blockIdx.x * GF_T;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += GF_K) {
        for (int i = tid; i < GF_T * GF_K; i += 256) {
            const int r = i / GF_K, c = i % GF_K;
            As[c][r] = (m0 + r < M && k0 + c < K) ? A[(size_t)(m0 + r) * K + k0 + c] : 0.f;
            const int wr = i / GF_T, wc = i % GF_T;
            Ws[wr][wc] = (k0 + wr < K && n0 + wc < N) ? W[(size_t)(k0 + wr) * N + n0 + wc] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GF_K; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gr = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gc = n0 + tx * 4 + j;
            if (gr < M && gc < N) C[(size_t)gr * N + gc] = acc[i][j] + bias[gc];
        }
    }
}

// ---------------------------------------------------------------------------------------
// attn_core: qkv (B, S, 3D) -> attn (B, S, D), heads concatenated (h * dh + d).
// One block per (sequence, query tile of QT rows, head); 4 warps of RPW query rows each.
// In the logit loops a lane owns one key of the tile; in P.v a lane owns columns
// d = lane + 32 c of the head.
// ---------------------------------------------------------------------------------------
constexpr int QT = 32, KT = 32, AC_WARPS = 4, RPW = QT / AC_WARPS;

__host__ __device__ constexpr int ks_ld(int dh) { return dh + 4; }   // conflict-free float4

__host__ __device__ inline size_t attn_smem_floats(int dh) {
    return (size_t)QT * dh + (size_t)KT * ks_ld(dh) + (size_t)KT * dh + (size_t)QT * KT;
}

// Logits of this warp's RPW rows against key `lane` of the staged tile, unscaled.
__device__ __forceinline__ void tile_dots(const float* qs, const float* ks, int warp, int lane,
                                          int dh, float (&acc)[RPW]) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
    const float* krow = ks + lane * ks_ld(dh);
    for (int d = 0; d < dh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + (warp * RPW + r) * dh + d);
            acc[r] = fmaf(qv.x, kv.x, acc[r]);
            acc[r] = fmaf(qv.y, kv.y, acc[r]);
            acc[r] = fmaf(qv.z, kv.z, acc[r]);
            acc[r] = fmaf(qv.w, kv.w, acc[r]);
        }
    }
}

// Masked, scaled logit: -inf for keys past the tile's valid range (they do not exist or
// are masked for every row of the block, and so add exactly 0 to the sum), -1e10 for
// causal-masked keys as in the reference.
__device__ __forceinline__ float masked_logit(float dot, float scale, int key, int kend,
                                              int qi, int causal, int diag) {
    if (key >= kend) return -INFINITY;
    const float l = dot * scale;
    return (causal && key > qi + diag) ? -1e10f : l;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, size_t row_stride,
                                           int row0, int nrows_valid, int nrows, int dh) {
    for (int i = threadIdx.x; i < nrows * dh; i += blockDim.x) {
        const int r = i / dh, d = i % dh;
        dst[r * ld + d] = (r < nrows_valid) ? to_f32(src[(size_t)(row0 + r) * row_stride + d])
                                            : 0.f;
    }
}

template <typename T, int DC>
__global__ void __launch_bounds__(AC_WARPS * 32)
attn_core(const T* __restrict__ qkv, T* __restrict__ out, int S, int H, int dh, int causal,
          int diag, float scale, int q_tiles) {
    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                       // QT x dh
    float* ks = qs + QT * dh;               // KT x ks_ld(dh)
    float* vs = ks + KT * ks_ld(dh);        // KT x dh
    float* ps = vs + KT * dh;               // QT x KT probabilities of the current tile

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * QT, h = blockIdx.y;
    const int D = H * dh;
    const size_t stride = 3 * (size_t)D;
    const T* base = qkv + (size_t)b * S * stride;
    const int q_end = min(S, q0 + QT);
    // Keys past q_end - 1 + diag are masked for every row of this tile under the causal
    // mask: exp(-1e10 - m) is exactly 0 in f32, so they are not visited at all.
    const int kend = causal ? min(S, q_end + diag) : S;

    stage_rows(qs, dh, base + h * dh, stride, q0, q_end - q0, QT, dh);

    float m[RPW], s[RPW], acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) { m[r] = -INFINITY; s[r] = 0.f; }

    // Pass 1: row max and sum of exp over all key tiles.
    for (int k0 = 0; k0 < kend; k0 += KT) {
        __syncthreads();
        stage_rows(ks, ks_ld(dh), base + D + h * dh, stride, k0, min(KT, kend - k0), KT, dh);
        __syncthreads();
        tile_dots(qs, ks, warp, lane, dh, acc);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float l = masked_logit(acc[r], scale, k0 + lane, kend,
                                         q0 + warp * RPW + r, causal, diag);
            const float m_new = fmaxf(m[r], warp_max(l));
            s[r] = s[r] * expf(m[r] - m_new) + warp_sum(expf(l - m_new));
            m[r] = m_new;
        }
    }

    // Pass 2: the same logits, p = exp(l - m) / s rounded to T, then p.v in f32.
    float o[RPW][DC];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) o[r][c] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += KT) {
        const int nk = min(KT, kend - k0);
        __syncthreads();
        stage_rows(ks, ks_ld(dh), base + D + h * dh, stride, k0, nk, KT, dh);
        stage_rows(vs, dh, base + 2 * D + h * dh, stride, k0, nk, KT, dh);
        __syncthreads();
        tile_dots(qs, ks, warp, lane, dh, acc);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float l = masked_logit(acc[r], scale, k0 + lane, kend,
                                         q0 + warp * RPW + r, causal, diag);
            const float p = expf(l - m[r]) / s[r];
            ps[(warp * RPW + r) * KT + lane] = to_f32(from_f32<T>(p));
        }
        __syncwarp();
        for (int j = 0; j < nk; ++j) {
            float vv[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = lane + 32 * c;
                vv[c] = d < dh ? vs[j * dh + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float p = ps[(warp * RPW + r) * KT + j];
#pragma unroll
                for (int c = 0; c < DC; ++c) o[r][c] = fmaf(p, vv[c], o[r][c]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int qi = q0 + warp * RPW + r;
        if (qi >= S) continue;
        T* orow = out + ((size_t)b * S + qi) * D + h * dh;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            const int d = lane + 32 * c;
            if (d < dh) orow[d] = from_f32<T>(o[r][c]);
        }
    }
}

template <typename T, int DC>
cudaError_t launch_attn_core(const void* qkv, void* out, int B, int S, int H, int dh,
                             int causal, int diag, float scale, cudaStream_t stream) {
    const size_t smem = attn_smem_floats(dh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attn_core<T, DC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int q_tiles = (S + QT - 1) / QT;
    dim3 grid((unsigned)B * q_tiles, H);
    attn_core<T, DC><<<grid, AC_WARPS * 32, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), S, H, dh, causal, diag, scale,
        q_tiles);
    return cudaGetLastError();
}

template <typename T>
cudaError_t attn_core_dispatch(const void* qkv, void* out, int B, int S, int H, int dh,
                               int causal, int diag, float scale, cudaStream_t stream) {
    if (dh <= 32) return launch_attn_core<T, 1>(qkv, out, B, S, H, dh, causal, diag, scale, stream);
    if (dh <= 64) return launch_attn_core<T, 2>(qkv, out, B, S, H, dh, causal, diag, scale, stream);
    return launch_attn_core<T, 4>(qkv, out, B, S, H, dh, causal, diag, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns cudaGetLastError() after
// its launch (0 on success); the caller checks shapes, dtypes and alignment.
extern "C" int tcow_gemm_bias(int dtype, const void* A, const void* W, const void* bias,
                              void* C, int M, int N, int K, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* w = static_cast<const float*>(W);
    const float* b = static_cast<const float*>(bias);
    if (dtype == 1) {
        dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);
        gemm_bias_bf16<<<grid, GB_THREADS, 0, st>>>(static_cast<const bf16*>(A), w, b,
                                                    static_cast<bf16*>(C), M, N, K);
    } else if (dtype == 0) {
        dim3 grid((N + GF_T - 1) / GF_T, (M + GF_T - 1) / GF_T);
        gemm_bias_f32<<<grid, 256, 0, st>>>(static_cast<const float*>(A), w, b,
                                            static_cast<float*>(C), M, N, K);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int tcow_attn_core(int dtype, const void* qkv, void* out, int B, int S, int H,
                              int dh, int causal, int diag, float scale, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh > 128 || dh % 4) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return (int)attn_core_dispatch<bf16>(qkv, out, B, S, H, dh, causal, diag, scale, st);
    if (dtype == 0) return (int)attn_core_dispatch<float>(qkv, out, B, S, H, dh, causal, diag, scale, st);
    return (int)cudaErrorInvalidValue;
}
