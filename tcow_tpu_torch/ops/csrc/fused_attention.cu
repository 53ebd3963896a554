// Fused multi-head self-attention for Hopper (sm_90a), bound through ctypes: the forward
// (K1) with its residual variants (K2, K3) and the backward (K4) with its variants (K5, K6),
// one per backward mode of tcow_tpu/ops/pallas_attention.py:fused_attention (:171-199).
// The wrappers in fused_attention.py chain the entry points below (the attention cores)
// and those of gemm_sm90.cu (gemm_bias, wgrad, colsum: the GEMMs and row reductions, a
// library of their own) into each kernel.
//
// ---- K1, the forward ----
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
// traffic: about 1300 FLOP per byte, so the chain is compute-bound, ~88 us and ~103 us.
// The GEMMs are gemm_sm90.cu's wgmma kernels fed by TMA (its source note); qkv and attn
// make a round trip through HBM. Fusing the three stages is later work.
//
// attn_core alone is bytes-bound: it reads qkv once (R S 3D bf16) and writes attn (R S D)
// and, for K3, the probabilities (R H S S), against 4 dh operations per kept (query, key)
// pair and head: ~0.099 ms of bytes against ~0.05 ms of operations at training 180x301.
// In bf16 it is attn_core_mma, on tensor cores:
//   - mma.sync m16n8k16 (bf16 in, f32 accumulate) through the fragment helpers below
//     (frag::), for q k^T and for p v; ldmatrix loads, .trans for v as the B operand. A
//     warp owns 16 query rows and keeps its q fragments in registers for the whole call.
//   - bf16 staging: q once per block, k and v per tile of 64 keys, into shared rows of
//     stride dh + 8 (dh padded to a multiple of 16 with zero columns, which add exactly 0),
//     so ldmatrix has no bank conflicts. Without rope the rows arrive by 16-byte cp.async
//     (8-byte when dh % 8 != 0), and the next tile's copy overlaps the current tile's
//     products (two buffers). With rope q and k rows are rotated in f32 by rope_rotate and
//     rounded to bf16 as they are stored (the values stage_qk<bf16, true> gives).
//   - Tile shapes from S at launch: warps per block = ceil(S / 16) up to 4, so S = 30 (the
//     temporal calls, 600 or 1800 sequences) takes 2 warps and a 32-row tile instead of
//     half-filling a 64-row one, and S = 301 takes 4 warps and five 64-row query tiles. A
//     block whose keys fit one 64-key tile (S <= 64) stages k and v once for both passes,
//     in one buffer sized round_up(S, 16). Under the causal mask each warp skips the
//     16-key chunks wholly past its own last row + diag, not only the block's.
//   - Rounding points of the plain version (attention_ref), kept: pass 1 over the key
//     tiles finds each row's max m and sum s from f32 logits q.k * scale (fill -1e10 for
//     causal-masked keys, -inf past the visited range: both add exactly 0); pass 2
//     recomputes the same logits on the tensor cores, forms p = exp(l - m) / s, rounds it
//     to bf16 in registers, writes it there for K3, and packs two n8 accumulator
//     fragments into the A fragment of p v, with no shared-memory round trip. An online
//     softmax would rescale partial outputs and round elsewhere. No atomics and no split
//     over keys: the same inputs give the same bits on every run (full remat re-runs K1,
//     and the res pairing K3).
// In f32, attn_core_f32 stays on the CUDA cores (one block per sequence, 32-query tile and
// head, f32 staging, fmaf logits in tile_dots, the same two passes): tensor cores take no
// f32 inputs, and TF32 keeps ~10 mantissa bits, too few for the 1e-4 f32 limit.
//
// ---- K4, the backward ----
//
// Replaces: tcow_tpu/ops/pallas_attention.py:_bwd_kernel (:548-637) as launched by
// _fused_attention_bwd_impl(qkv=None, inkernel_wgrads=False) (`pallas_call` :755), the
// backward of the 'kernel_x' mode with rope off. From x, the incoming gradient g and the
// weights it computes
//   qkv   = (x . qkv_w + qkv_b) in f32, rounded to the compute dtype        (:573-575)
//   dattn = (g . proj_w^T) in f32, rounded                                  (:587-590)
//   per head, with pf = softmax_mask(q k^T * scale) in f32 and p_c = pf rounded:
//     attn = p_c . v          dv = p_c^T . dA            (rounded)          (:611-617)
//     dp   = dA . v^T (f32)   dlog = (pf * (dp - rowsum(dp * pf)) * scale) rounded
//     dq   = dlog . k         dk = dlog^T . q            (rounded)          (:618-625)
// and writes dqkv = [dq | dk | dv] (R, S, 3D) and attn (R, S, D). The weight, bias and
// input gradients are products outside the kernel (:765-778), in the Python wrapper.
//
// Launches: gemm_bias (qkv) -> gemm_bias with W^T and no bias (dattn) -> attn_bwd_q ->
// attn_bwd_kv. The TPU kernel holds a whole group of sequences in VMEM and sums dk and dv
// over all queries inside one grid step. On Hopper the query tiles of one sequence sit in
// different blocks, so the sum over queries would cross blocks. The design keeps it
// inside a block and needs no atomics, so the result is deterministic:
//   attn_bwd_q:  one block per (sequence, query tile, head). Pass 1 over the key tiles
//                finds each row's max m and sum s (as the forward's attn_core); pass 2
//                forms pf and p_c, accumulates attn = p_c . v and delta = rowsum(dp * pf);
//                pass 3 forms dlog and accumulates dq = dlog . k. It writes attn, dq and
//                the f32 row statistics (m, s, delta) to a (3, R, H, S) buffer.
//   attn_bwd_kv: one block per (sequence, key tile, head). For every query tile that can
//                see its keys (under the causal mask the earlier ones are skipped) it
//                recomputes pf and dlog from the saved statistics and accumulates
//                dv = p_c^T . dA and dk = dlog^T . q in f32.
// pf and dlog are bit-identical in the two launches; rounding points follow
// attention_bwd_ref (logits and softmax in f32, p_c and dlog rounded before their
// products, attn, dq, dk, dv accumulated in f32 and rounded once).
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s) at the training step of record
// (D=768, 12 heads of 64, bf16): the two products inside the kernel are 8 R S D^2
// operations (2.55e11 temporal, 1800 sequences of 30; 2.56e11 spatial, 180 of 301), the
// attention 12 D per (query, key) pair the mask keeps (7.7e9 temporal, 1.50e11 spatial),
// against ~0.5 GB of compulsory traffic: operations-bound, ~0.27 ms temporal and ~0.41 ms
// spatial. The GEMMs are the forward's (gemm_sm90.cu: wgmma fed by TMA); qkv, dattn and
// the statistics make a round trip through HBM. The core
// alone reads qkv and dattn and writes attn and dqkv (16 D bytes a row in bf16, 0.66 GB
// at the step of record's shapes) against 12 dh operations per kept pair and head:
// ~0.2 ms at both shapes. In bf16 it is attn_bwd_q_mma + attn_bwd_kv_mma, on tensor
// cores, built from attn_core_mma's pieces:
//   - mma.sync m16n8k16 (bf16 in, f32 accumulate) through frag::: load_a for query-side
//     rows (q, dA), load_bt for key-side rows as X^T (k for q k^T, v for dA v^T), load_b
//     (.trans) for the depth operand of the products (v for p v, k for dlog k, dA for
//     P^T dA, q for dlog^T q), p_as_a to turn rounded accumulators into an A operand.
//   - bf16 staging by cp.async (16- or 8-byte; 4-byte for the f32 statistics), rows of
//     stride 16 DK + 8 (dh padded to 16 DK with zero columns), two buffers so the next
//     tile's copy overlaps the current tile's products; rope rows by stage_rope.
//   - Tiles from S as in attn_core_mma: a warp owns 16 rows, warps per block ceil(S / 16)
//     up to 4 (2 at S = 30, 4 at S = 301), tiles of 64 keys (queries) or round_up(S, 16)
//     rows staged once when S <= 64. attn_bwd_q_mma keeps a warp's q and dA fragments in
//     registers for its three passes; attn_bwd_kv_mma keeps its warp's k and v B
//     fragments (dh <= 64) and walks the query chunks of 16 that see its keys.
//   - dV and dK need P^T and dlog^T as the A operand. The A fragment of a 16 x 16 operand
//     is four 8 x 8 blocks; the transpose's is the same blocks swapped and each transposed
//     by movmatrix.m8n8.trans (frag::transpose_a), all in registers.
//   - Bit-identity of pf and dlog across the launches: both form every logit and every dp
//     with the query rows as the A operand and the key rows as B (attn_bwd_kv_mma does not
//     compute k q^T, which need not give the same bits), from a zero accumulator over
//     the depth slices kd = 0 .. DK - 1 in order (chunk_dots), with query and key chunks
//     that start at multiples of 16, so element (i, j) sits at the same place of its mma
//     tile with the same operand bits in both launches. The scale, the subtraction of m,
//     the division by s and dlog's products are rounded one by one (__fmul_rn, __fsub_rn,
//     __fdiv_rn: never contracted into an fma), from the same (m, s, delta) floats. Keys
//     one launch skips or fills with -inf are causal-masked in the other: pf = 0 in both.
//   - No atomics and no split over keys or queries: the same inputs give the same bits on
//     every run (full remat re-runs the backward).
// In f32, attn_bwd_q / attn_bwd_kv below stay on the CUDA cores (f32 staging, fmaf logits
// in tile_dots, the same order in both launches): TF32 keeps ~10 mantissa bits, too few
// for the 1e-4 f32 limit.

// ---- K2, K3: the forward with residuals ----
//
// K2 replaces _fused_attention_fwd_impl(want_residuals='qkv') (`pallas_call` :293), the
// forward of the 'kernel_qkv' mode: K1's chain, which already writes qkv (B, S, 3D) to
// device memory between its launches; the wrapper returns it. No device code of its own.
// K3 replaces _fused_attention_fwd_impl(want_residuals=True) (`pallas_call` :327, probs and
// attn stored at :141-142 and :152-155), the forward of the 'res' mode: K1's chain with
// attn_core_{mma,f32}<PROBS = true>, which stores each p_c it forms in pass 2 into probs
// (B, H, S, S) in the compute dtype, per sequence and not in the TPU's packed
// (B/pack, H, SP, SP) layout, and zeros for the keys the causal mask drops. attn (B, S, D)
// is K1's intermediate. In bf16 attn_core_mma<PROBS> writes p_c from the registers that
// feed p v. Bound at the training step of record (bf16): K1's operations
// (2.6e11 temporal, 3.1e11 spatial) against K1's bytes plus qkv, attn and the
// probabilities (0.39 GB spatial, 0.04 GB temporal): operations-bound, ~0.26 / ~0.31 ms.
// What the design does about it: nothing beyond K1's design.
//
// ---- K5, K6: the backward variants ----
//
// K5 replaces _fused_attention_bwd_impl(qkv=...) (`pallas_call` :755, qkv_ref :570-571),
// the backward of 'kernel_qkv': K4 reading the saved qkv, so the chain starts at the
// g . proj_w^T GEMM (attn_bwd_q / attn_bwd_kv unchanged).
// K6 replaces _fused_attention_bwd_impl(inkernel_wgrads=True) (`pallas_call` :735, body
// :640-660), the backward of 'kernel_x_wg', which computes inside the TPU kernel what K4
// leaves to plain products: K4's chain, then
//   dx      = dqkv . qkv_w^T rounded to the compute dtype: gemm_bias with W^T, no bias
//   dqkv_w  = x^T . dqkv, dproj_w = attn^T . g in f32: wgrad
//   dqkv_b, dproj_b = column sums of dqkv and g in f32: colsum
// The weight gradients sum over all R S rows (54,000 at the step of record), across
// blocks. The TPU kernel accumulates them in VMEM over its sequential grid; here the rows
// are cut into runs, one block per (output tile, run) sums its run in row order, and a
// second pass adds the runs in order: deterministic, no atomics. Bound (bf16, step of
// record): 22 R S D^2 operations in products plus K4's attention (7.1e11 temporal, 8.5e11
// spatial, ~0.72 / ~0.86 ms), operations-bound. What the design does about it: dx and
// the weight gradients run on gemm_sm90.cu's wgmma + TMA mainloop (wgrad with both
// operands MN-major); the bias gradients (colsum) are plain bytes-bound column sums.
//
// ---- K1r ... K6r: the same kernels with rope ----
//
// Replace: the six launches above with rope=True (temporal attention under temporal_rope):
// the rotation of q and k in _kernel (:120-136) and _bwd_kernel (:592-605), the
// un-rotation of dq and dk (:626-628), and the per-row tables (_pos_tables :242-249) or
// row positions (packed_tables, rope.py:49-60). ROPE is a compile-time flag of attn_core,
// attn_bwd_q and attn_bwd_kv (and of their _mma forms in bf16); the GEMMs, wgrad and
// colsum do not change, since qkv and
// dqkv stay un-rotated in device memory. The wrapper builds f32 cos / sin tables with the
// port's rope.py (one (S, dh/2) table, or one per sequence from its positions), and the
// plain version rotates by the same tables, so no cosf of a ~230 rad angle differs by
// ulps between the two. Where they round (apply_rope's .astype):
//   staging q and k rows: rotate in f32 from the rounded qkv -> round to T -> f32, in every
//   launch that reads them (attn_core, attn_bwd_q, attn_bwd_kv, identically, so pf and dlog
//   stay bit-identical between the two backward launches); v is never rotated;
//   dq, dk: accumulate in f32 -> round to T -> un-rotate in f32 -> round to T, one rounding
//   more than K4. Element d pairs with d +- dh/2, which another lane owns (in f32 a lane
//   owns d = lane + 32 c; in bf16 the accumulator fragments spread a row over a quad), so
//   each lane parks its rounded values as f32 in rows only its warp reads (park_rounded;
//   store_rows_unrotated for fragments), and store_unrotated writes each row.
// Bound: K1's (K4's ...) operations plus 6 per rotated element pair of q and k (and dq,
// dk), against K1's bytes plus the tables: operations-bound, as the kernel without rope.
// What the design does about it: nothing beyond the kernels' own design; the tables are
// read from device memory (L2) at every staging.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// Attention core pieces. A block of AC_WARPS warps owns QT rows (RPW per warp); in the
// logit loops a lane owns one row of the other operand's tile of KT rows.
// ---------------------------------------------------------------------------------------
constexpr int QT = 32, KT = 32, AC_WARPS = 4, RPW = QT / AC_WARPS;

__host__ __device__ constexpr int ks_ld(int dh) { return dh + 4; }   // conflict-free float4

// Dot products of this warp's RPW rows of `own` (row stride dh) with row `lane` of `other`
// (row stride ks_ld(dh)), summed in order d = 0..dh-1. fmaf is symmetric in its first two
// arguments, so swapping the roles of the operands gives bit-identical results.
__device__ __forceinline__ void tile_dots(const float* own, const float* other, int warp,
                                          int lane, int dh, float (&acc)[RPW]) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
    const float* orow = other + lane * ks_ld(dh);
    for (int d = 0; d < dh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(own + (warp * RPW + r) * dh + d);
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

// Copies rows row0 .. row0 + nrows - 1 (dh values each, source row stride row_stride) into
// dst (row stride ld) as f32; rows past nrows_valid are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, size_t row_stride,
                                           int row0, int nrows_valid, int nrows, int dh) {
    for (int i = threadIdx.x; i < nrows * dh; i += blockDim.x) {
        const int r = i / dh, d = i % dh;
        dst[r * ld + d] = (r < nrows_valid) ? to_f32(src[(size_t)(row0 + r) * row_stride + d])
                                            : 0.f;
    }
}

// ---- rope (K1r ... K6r) ----
// Half-split rotation of one element of a head row x = [x1, x2] (dh/2 values each): element
// j of the first half becomes x1 c - x2 s, element j of the second half x1 s + x2 c, with
// c, s entry j of the table row of the row's position; INVERSE rotates by -s. Every product
// and sum is rounded on its own (no fma contraction), as apply_rope's f32 torch ops round
// them, so the kernel and its plain version get the same f32 value from the same tables.
template <bool INVERSE>
__device__ __forceinline__ float rope_rotate(float x1, float x2, float c, float s, bool first) {
    if (INVERSE) s = -s;
    return first ? __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s))
                 : __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

// stage_rows for the q or k rows of a head. With ROPE each row is rotated in f32 by the
// table row of its position row0 + r (tc, ts: this sequence's (S, dh/2) tables) and rounded
// to T again, as apply_rope rounds its output (:72), before it is stored as f32.
template <typename T, bool ROPE>
__device__ __forceinline__ void stage_qk(float* dst, int ld, const T* src, size_t row_stride,
                                         int row0, int nrows_valid, int nrows, int dh,
                                         const float* tc, const float* ts) {
    if (!ROPE) {
        stage_rows(dst, ld, src, row_stride, row0, nrows_valid, nrows, dh);
        return;
    }
    const int h = dh / 2;
    for (int i = threadIdx.x; i < nrows * dh; i += blockDim.x) {
        const int r = i / dh, d = i % dh;
        float v = 0.f;
        if (r < nrows_valid) {
            const T* row = src + (size_t)(row0 + r) * row_stride;
            const bool first = d < h;
            const int j = first ? d : d - h;
            const size_t t = (size_t)(row0 + r) * h + j;
            v = to_f32(from_f32<T>(rope_rotate<false>(to_f32(row[j]), to_f32(row[j + h]), tc[t],
                                                      ts[t], first)));
        }
        dst[r * ld + d] = v;
    }
}

// The backward's dq or dk under ROPE: a warp's RPW accumulator rows (d = lane + 32 c) are
// rounded to T and parked in shared memory rows of stride dh that only this warp reads,
// because element d pairs with d +- dh/2, which another lane may own (dh <= 32 or dh not a
// multiple of 64).
template <typename T, int DC>
__device__ __forceinline__ void park_rounded(float* rows, const float (&acc)[RPW][DC], int dh,
                                             int lane) {
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            const int d = lane + 32 * c;
            if (d < dh) rows[r * dh + d] = to_f32(from_f32<T>(acc[r][c]));
        }
    __syncwarp();
}

// Writes one parked row, un-rotated in f32 by its position's table row (tc, ts: dh/2
// values) and rounded to T again (:626-628).
template <typename T>
__device__ __forceinline__ void store_unrotated(T* out, const float* row, int dh,
                                                const float* tc, const float* ts, int lane) {
    const int h = dh / 2;
    for (int d = lane; d < dh; d += 32) {
        const bool first = d < h;
        const int j = first ? d : d - h;
        out[d] = from_f32<T>(rope_rotate<true>(row[j], row[j + h], tc[j], ts[j], first));
    }
}

// Operands and geometry of one attention launch (attn_core, or attn_bwd_q + attn_bwd_kv).
// cos / sin are null without rope; table_stride is 0 when every sequence shares one
// (S, dh/2) table, S dh/2 for per-sequence tables.
struct AttnArgs {
    const void* qkv;
    const void* dattn;
    void* attn;
    void* probs;
    void* dqkv;
    void* stats;
    const float* cos;
    const float* sin;
    int table_stride, B, S, H, dh, causal, diag;
    float scale;
};

// ---------------------------------------------------------------------------------------
// attn_core_f32: qkv (B, S, 3D) -> attn (B, S, D) in f32, heads concatenated (h * dh + d).
// One block per (sequence, query tile of QT rows, head); 4 warps of RPW query rows each.
// In the logit loops a lane owns one key of the tile; in P.v a lane owns columns
// d = lane + 32 c of the head.
// ---------------------------------------------------------------------------------------
__host__ __device__ inline size_t attn_smem_floats(int dh) {
    return (size_t)QT * dh + (size_t)KT * ks_ld(dh) + (size_t)KT * dh + (size_t)QT * KT;
}

template <int DC, bool PROBS, bool ROPE>
__global__ void __launch_bounds__(AC_WARPS * 32)
attn_core_f32(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ probs,
              const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
              int table_stride, int S, int H, int dh, int causal, int diag, float scale,
              int q_tiles) {
    using T = float;
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
    // ROPE: this sequence's tables.
    const float* tc = ROPE ? rope_cos + (size_t)b * table_stride : nullptr;
    const float* ts = ROPE ? rope_sin + (size_t)b * table_stride : nullptr;

    stage_qk<T, ROPE>(qs, dh, base + h * dh, stride, q0, q_end - q0, QT, dh, tc, ts);

    float m[RPW], s[RPW], acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) { m[r] = -INFINITY; s[r] = 0.f; }

    // Pass 1: row max and sum of exp over all key tiles.
    for (int k0 = 0; k0 < kend; k0 += KT) {
        __syncthreads();
        stage_qk<T, ROPE>(ks, ks_ld(dh), base + D + h * dh, stride, k0, min(KT, kend - k0), KT,
                          dh, tc, ts);
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
        stage_qk<T, ROPE>(ks, ks_ld(dh), base + D + h * dh, stride, k0, nk, KT, dh, tc, ts);
        stage_rows(vs, dh, base + 2 * D + h * dh, stride, k0, nk, KT, dh);
        __syncthreads();
        tile_dots(qs, ks, warp, lane, dh, acc);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float l = masked_logit(acc[r], scale, k0 + lane, kend,
                                         q0 + warp * RPW + r, causal, diag);
            const T pc = from_f32<T>(expf(l - m[r]) / s[r]);
            ps[(warp * RPW + r) * KT + lane] = to_f32(pc);
            if (PROBS) {
                const int qi = q0 + warp * RPW + r, key = k0 + lane;
                if (qi < S && key < kend) probs[(((size_t)b * H + h) * S + qi) * S + key] = pc;
            }
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
        // Keys from kend on were not visited: masked for every row of the tile, p = 0.
        if (PROBS) {
            T* prow = probs + (((size_t)b * H + h) * S + qi) * S;
            for (int key = kend + lane; key < S; key += 32) prow[key] = from_f32<T>(0.f);
        }
    }
}

template <int DC, bool PROBS, bool ROPE>
cudaError_t launch_attn_core_f32(const AttnArgs& a, cudaStream_t stream) {
    const size_t smem = attn_smem_floats(a.dh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attn_core_f32<DC, PROBS, ROPE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int q_tiles = (a.S + QT - 1) / QT;
    dim3 grid((unsigned)a.B * q_tiles, a.H);
    attn_core_f32<DC, PROBS, ROPE><<<grid, AC_WARPS * 32, smem, stream>>>(
        static_cast<const float*>(a.qkv), static_cast<float*>(a.attn),
        static_cast<float*>(a.probs), a.cos, a.sin, a.table_stride, a.S, a.H, a.dh, a.causal,
        a.diag, a.scale, q_tiles);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// Tensor-core fragment helpers: mma.sync m16n8k16, bf16 operands, f32 accumulation, fed by
// ldmatrix from bf16 tiles in shared memory. Lane = 4 g + t (g = lane / 4, t = lane % 4).
// An accumulator fragment c[4] of a 16 x 8 tile holds row g at columns 2t, 2t + 1 (c[0],
// c[1]) and row g + 8 at the same columns (c[2], c[3]): a row lives in the four lanes of one
// quad, so a row reduction is two shuffles. Two n8 accumulator fragments (columns 0-7 and
// 8-15), rounded to bf16, are exactly the A fragment of a 16 x 16 operand (p_as_a). Tiles
// are row-major with a row stride of (a multiple of 16) + 8 elements: eight consecutive
// rows then start in eight different 16-byte bank groups, and ldmatrix has no conflicts.
// ---------------------------------------------------------------------------------------
namespace frag {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A fragment of rows 0-15, columns 0-15 of the tile at `tile` (row stride ld).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int lane) {
    const bf16* p = tile + (lane & 15) * ld + (lane >> 4) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(smem_u32(p)));
}

// B fragments of X^T for two n8 tiles, X (n rows, k columns) at `tile`: n 0-7 in b[0], b[1],
// n 8-15 in b[2], b[3], k 0-15. For a . x^T with x stored by rows (q k^T: x = k).
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int ld, int lane) {
    const bf16* p = tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(smem_u32(p)));
}

// B fragments of X for two n8 tiles, X (k rows 0-15, n columns) at `tile`, transposed by
// ldmatrix: n 0-7 in b[0], b[1], n 8-15 in b[2], b[3]. For a . x (p v: x = v).
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int ld, int lane) {
    const bf16* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max and sum of a row over the four lanes of its quad.
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The A fragment of a 16 x 16 operand from its two n8 accumulator fragments, rounded.
__device__ __forceinline__ void p_as_a(uint32_t (&a)[4], const bf16 (&p)[2][4]) {
    a[0] = pack(p[0][0], p[0][1]);
    a[1] = pack(p[0][2], p[0][3]);
    a[2] = pack(p[1][0], p[1][1]);
    a[3] = pack(p[1][2], p[1][3]);
}

// One 8 x 8 b16 block of a fragment, transposed across the warp: the lane that held
// elements (g, 2t) and (g, 2t + 1) receives (2t, g) and (2t + 1, g).
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
    uint32_t y;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
    return y;
}

// The A fragment of M^T from the A fragment of a 16 x 16 operand M. a[0..3] are M's 8 x 8
// blocks (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); block (r, c) of M^T
// is block (c, r) of M transposed. In registers, with no shared-memory round trip.
__device__ __forceinline__ void transpose_a(uint32_t (&at)[4], const uint32_t (&a)[4]) {
    at[0] = transpose8(a[0]);
    at[1] = transpose8(a[2]);
    at[2] = transpose8(a[1]);
    at[3] = transpose8(a[3]);
}

// Asynchronous copy of BYTES (16, 8 or 4) from global to shared memory; zeros when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "cp.async copies 16, 8 or 4 bytes");
    const int n = valid ? BYTES : 0;
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
    else if (BYTES == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace frag

// Stages rows row0 .. row0 + nrows - 1 of one head (dh bf16 values each, source row stride
// `stride` elements) into the bf16 tile dst (row stride ld) by cp.async: 16 bytes a copy
// when dh % 8 == 0, else 8 (dh % 4 == 0, 8-byte aligned rows). Rows from nvalid on are
// zero-filled; columns from dh on are not touched.
__device__ __forceinline__ void stage_async(bf16* dst, int ld, const bf16* src, size_t stride,
                                            int row0, int nvalid, int nrows, int dh) {
    const bool wide = (dh & 7) == 0;
    const int w = wide ? 8 : 4, per_row = dh / w;
    for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
        const int r = i / per_row, c = (i - r * per_row) * w;
        const bool ok = r < nvalid;
        const bf16* g = src + (size_t)(row0 + (ok ? r : 0)) * stride + c;
        if (wide)
            frag::cp_async<16>(dst + r * ld + c, g, ok);
        else
            frag::cp_async<8>(dst + r * ld + c, g, ok);
    }
}

// stage_qk<bf16, true> into a bf16 tile: row r rotated in f32 by the table row of position
// row0 + r and rounded to bf16 (the values apply_rope gives), zero from nvalid on. Plain
// loads and stores, since the rotation needs the data in registers: a thread item is the
// element pairs (j, j + h) and (j + 1, j + h + 1), read as bf16 and f32 pairs (dh % 4 == 0,
// so j and h are even), and a thread loads RB items before it stores any, so that their
// loads are in flight together.
__device__ __forceinline__ void stage_rope(bf16* dst, int ld, const bf16* __restrict__ src,
                                           size_t stride, int row0, int nvalid, int nrows,
                                           int dh, const float* __restrict__ tc,
                                           const float* __restrict__ ts) {
    constexpr int RB = 4;
    const int h = dh / 2, per_row = h / 2, items = nrows * per_row;
    for (int i0 = threadIdx.x; i0 < items; i0 += RB * blockDim.x) {
        float2 x1[RB], x2[RB], c[RB], s[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u) {
            const int i = i0 + u * blockDim.x, r = i / per_row, j = 2 * (i - r * per_row);
            x1[u] = x2[u] = c[u] = s[u] = make_float2(0.f, 0.f);
            if (i < items && r < nvalid) {
                const bf16* row = src + (size_t)(row0 + r) * stride;
                const size_t at = (size_t)(row0 + r) * h + j;
                x1[u] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + j));
                x2[u] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + j + h));
                c[u] = *reinterpret_cast<const float2*>(tc + at);
                s[u] = *reinterpret_cast<const float2*>(ts + at);
            }
        }
#pragma unroll
        for (int u = 0; u < RB; ++u) {
            const int i = i0 + u * blockDim.x, r = i / per_row, j = 2 * (i - r * per_row);
            if (i >= items) break;
            bf16* out = dst + r * ld + j;
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(
                rope_rotate<false>(x1[u].x, x2[u].x, c[u].x, s[u].x, true),
                rope_rotate<false>(x1[u].y, x2[u].y, c[u].y, s[u].y, true));
            *reinterpret_cast<__nv_bfloat162*>(out + h) = __floats2bfloat162_rn(
                rope_rotate<false>(x1[u].x, x2[u].x, c[u].x, s[u].x, false),
                rope_rotate<false>(x1[u].y, x2[u].y, c[u].y, s[u].y, false));
        }
    }
}

// ---------------------------------------------------------------------------------------
// attn_core_mma: qkv (B, S, 3D) -> attn (B, S, D) in bf16 on tensor cores (design in the
// note at the top). One block per (sequence, query tile of 16 W rows, head), W warps of 16
// query rows; key tiles of MK rows; dh padded to DHP = 16 DK. Shared memory: the query
// tile, then nbuf buffers of kt key rows followed by kt value rows, all of row stride
// DHP + 8.
// ---------------------------------------------------------------------------------------
constexpr int MQ = 16, MK = 64, MMA_MAX_WARPS = 4;

__host__ __device__ inline size_t mma_smem_bytes(int dk, int warps, int kt, int nbuf) {
    return (size_t)(MQ * warps + 2 * nbuf * kt) * (16 * dk + 8) * sizeof(bf16);
}

// c (16 x 16, f32) = A . X^T from a zero accumulator, depth slices kd = 0 .. DK - 1 in
// order: A's 16 rows as fragments af, X's 16 rows at xs. Every logit (A = q, X = k) of
// both cores, and every dp (A = dA, X = v) of both backward launches, is formed this way,
// with the query rows as A.
template <int DK>
__device__ __forceinline__ void chunk_dots(float (&c)[2][4], const uint32_t (&af)[DK][4],
                                           const bf16* xs, int lane) {
    constexpr int LD = 16 * DK + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK; ++kd) {
        uint32_t xb[4];
        frag::load_bt(xb, xs + kd * 16, LD, lane);
        frag::mma(c[0], af[kd], xb[0], xb[1]);
        frag::mma(c[1], af[kd], xb[2], xb[3]);
    }
}

// Writes a warp's 16 x dh accumulator (its row r to out + r stride) in bf16; rows from
// nrows on are not written.
template <int DK>
__device__ __forceinline__ void store_rows(bf16* out, size_t stride,
                                           const float (&acc)[2 * DK][4], int nrows, int dh,
                                           int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (g + 8 * r >= nrows) continue;
        bf16* row = out + (size_t)(g + 8 * r) * stride;
#pragma unroll
        for (int n = 0; n < 2 * DK; ++n) {
            const int col = 8 * n + 2 * t;   // dh is even: col < dh means col + 1 < dh
            if (col < dh)
                *reinterpret_cast<__nv_bfloat162*>(row + col) =
                    __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
        }
    }
}

// Masked logits of this warp's 16 query rows (from wq0) against the 16 keys of tile rows
// kc .. kc + 15 of ks, which are keys key0 .. key0 + 15: l[j] is the n8 fragment of keys
// key0 + 8 j ...
template <int DK>
__device__ __forceinline__ void chunk_logits(float (&l)[2][4], const uint32_t (&qf)[DK][4],
                                             const bf16* ks, int kc, int key0, int wq0,
                                             int kend, int causal, int diag, float scale,
                                             int lane) {
    chunk_dots<DK>(l, qf, ks + kc * (16 * DK + 8), lane);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            l[j][e] = masked_logit(l[j][e], scale, key0 + 8 * j + 2 * t + (e & 1), kend,
                                   wq0 + g + 8 * (e >> 1), causal, diag);
}

template <int DK, bool PROBS, bool ROPE>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
attn_core_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out, bf16* __restrict__ probs,
              const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
              int table_stride, int S, int H, int dh, int causal, int diag, float scale,
              int q_tiles, int kt, int nbuf) {
    constexpr int DHP = 16 * DK, LD = DHP + 8, CHUNKS = MK / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = blockDim.x / 32, QTW = MQ * W;
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* kv = qs + QTW * LD;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * QTW, h = blockIdx.y;
    const int D = H * dh;
    const size_t stride = 3 * (size_t)D;
    const bf16* base = qkv + (size_t)b * S * stride + h * dh;
    const int q_end = min(S, q0 + QTW);
    // Keys past q_end - 1 + diag are masked for every row of the block, and keys past
    // min(S, wq0 + 16) - 1 + diag for every row of the warp: exp(-1e10 - m) is exactly 0
    // in f32, so they are not visited.
    const int kend = causal ? min(S, q_end + diag) : S;
    const int nt = (kend + MK - 1) / MK;
    const int wq0 = q0 + warp * MQ;
    const bool active = wq0 < S;
    const int kend_w = causal ? min(S, min(S, wq0 + MQ) + diag) : S;
    const float* tc = ROPE ? rope_cos + (size_t)b * table_stride : nullptr;
    const float* ts = ROPE ? rope_sin + (size_t)b * table_stride : nullptr;

    // Zero columns dh .. DHP - 1 of every tile once; the staging never writes them.
    if (dh < DHP) {
        const int rows = QTW + 2 * nbuf * kt, pad = DHP - dh;
        for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
            qs[(i / pad) * LD + dh + i % pad] = __float2bfloat16(0.f);
    }

    // Step s < nt is pass 1 over key tile s, step nt + i pass 2 over key tile i. Each step's
    // tiles are staged during the step before (two buffers); with one key tile, k and v are
    // staged once, in step 0, and both passes read buffer 0.
    const int steps = 2 * nt;
    auto keys_of = [&](int s) { return kv + (size_t)(nt == 1 ? 0 : (s & 1)) * 2 * kt * LD; };
    auto stage_step = [&](int s) {
        if (nt == 1 && s > 0) return;
        const int k0 = (s < nt ? s : s - nt) * MK;
        const int nk = min(MK, kend - k0), rows = (nk + 15) & ~15;
        bf16* ks = keys_of(s);
        if (ROPE)
            stage_rope(ks, LD, base + D, stride, k0, nk, rows, dh, tc, ts);
        else
            stage_async(ks, LD, base + D, stride, k0, nk, rows, dh);
        if (nt == 1 || s >= nt)
            stage_async(ks + kt * LD, LD, base + 2 * D, stride, k0, nk, rows, dh);
    };

    if (ROPE)
        stage_rope(qs, LD, base, stride, q0, q_end - q0, QTW, dh, tc, ts);
    else
        stage_async(qs, LD, base, stride, q0, q_end - q0, QTW, dh);
    stage_step(0);
    frag::cp_async_commit();

    uint32_t qf[DK][4];
    float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float o[2 * DK][4];
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) {
            stage_step(s + 1);
            frag::cp_async_commit();
            frag::cp_async_wait<1>();
        } else {
            frag::cp_async_wait<0>();
        }
        __syncthreads();
        if (s == 0 && active) {
#pragma unroll
            for (int kd = 0; kd < DK; ++kd)
                frag::load_a(qf[kd], qs + warp * MQ * LD + kd * 16, LD, lane);
        }
        const int k0 = (s < nt ? s : s - nt) * MK;
        const bf16* ks = keys_of(s);
        if (active && k0 < kend_w && s < nt) {
            // Pass 1: the tile's row max, then the sum of exp against the new max.
            float l[CHUNKS][2][4];
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                if (k0 + 16 * c < kend_w) {
                    chunk_logits<DK>(l[c], qf, ks, 16 * c, k0 + 16 * c, wq0, kend_w, causal,
                                     diag, scale, lane);
                } else {
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) l[c][j][e] = -INFINITY;
                }
            }
            float mx[2] = {-INFINITY, -INFINITY}, add[2] = {0.f, 0.f};
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], l[c][j][e]);
#pragma unroll
            for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], frag::quad_max(mx[r]));
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) add[e >> 1] += expf(l[c][j][e] - mx[e >> 1]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                sum[r] = sum[r] * expf(m[r] - mx[r]) + frag::quad_sum(add[r]);
                m[r] = mx[r];
            }
        } else if (active && k0 < kend_w) {
            // Pass 2: p = exp(l - m) / s rounded to bf16, then o += p . v, 16 keys at a time.
            const bf16* vs = ks + kt * LD;
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                if (k0 + 16 * c >= kend_w) continue;
                const int key0 = k0 + 16 * c;
                float l[2][4];
                chunk_logits<DK>(l, qf, ks, 16 * c, key0, wq0, kend_w, causal, diag, scale,
                                 lane);
                bf16 p[2][4];
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        p[j][e] = __float2bfloat16(expf(l[j][e] - m[e >> 1]) / sum[e >> 1]);
                if (PROBS) {
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const int qi = wq0 + g + 8 * r;
                        if (qi >= S) continue;
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                            const int key = key0 + 8 * j + 2 * t;
                            const size_t at = (((size_t)b * H + h) * S + qi) * S + key;
                            if (key + 1 < S && (at & 1) == 0) {
                                __nv_bfloat162 pair;
                                pair.x = p[j][2 * r];
                                pair.y = p[j][2 * r + 1];
                                *reinterpret_cast<__nv_bfloat162*>(probs + at) = pair;
                            } else {
                                if (key < S) probs[at] = p[j][2 * r];
                                if (key + 1 < S) probs[at + 1] = p[j][2 * r + 1];
                            }
                        }
                    }
                }
                uint32_t a[4];
                frag::p_as_a(a, p);
#pragma unroll
                for (int dn = 0; dn < DK; ++dn) {
                    uint32_t vb[4];
                    frag::load_b(vb, vs + 16 * c * LD + dn * 16, LD, lane);
                    frag::mma(o[2 * dn], a, vb[0], vb[1]);
                    frag::mma(o[2 * dn + 1], a, vb[2], vb[3]);
                }
            }
        }
        __syncthreads();
    }
    if (!active) return;

    store_rows<DK>(out + ((size_t)b * S + wq0) * D + h * dh, (size_t)D, o, S - wq0, dh, lane);
    // Keys from the first unvisited 16-key chunk on: masked for every row of the warp, p = 0.
    if (PROBS) {
        const int kz = min(S, (kend_w + 15) & ~15);
        for (int r = 0; r < MQ && wq0 + r < S; ++r) {
            bf16* prow = probs + (((size_t)b * H + h) * S + wq0 + r) * S;
            for (int key = kz + lane; key < S; key += 32) prow[key] = __float2bfloat16(0.f);
        }
    }
}

template <int DK, bool PROBS, bool ROPE>
cudaError_t launch_attn_core_mma(const AttnArgs& a, cudaStream_t stream) {
    // Tile shapes from S: one warp per 16 query rows up to 4; key buffers of round_up(S,
    // 16) rows up to MK, two of them only when a block can see more than one key tile.
    const int warps = min(MMA_MAX_WARPS, (a.S + MQ - 1) / MQ);
    const int kt = min(MK, (a.S + 15) & ~15), nbuf = a.S > MK ? 2 : 1;
    const size_t smem = mma_smem_bytes(DK, warps, kt, nbuf);
    cudaError_t err = cudaFuncSetAttribute(attn_core_mma<DK, PROBS, ROPE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int q_tiles = (a.S + MQ * warps - 1) / (MQ * warps);
    dim3 grid((unsigned)a.B * q_tiles, a.H);
    attn_core_mma<DK, PROBS, ROPE><<<grid, warps * 32, smem, stream>>>(
        static_cast<const bf16*>(a.qkv), static_cast<bf16*>(a.attn), static_cast<bf16*>(a.probs),
        a.cos, a.sin, a.table_stride, a.S, a.H, a.dh, a.causal, a.diag, a.scale, q_tiles, kt,
        nbuf);
    return cudaGetLastError();
}

// The launcher L<N, PROBS, ROPE> for the run-time flags (probs, rope tables).
template <int N, template <int, bool, bool> class L>
cudaError_t attn_core_flags(const AttnArgs& a, cudaStream_t st) {
    if (a.cos) return a.probs ? L<N, true, true>::run(a, st) : L<N, false, true>::run(a, st);
    return a.probs ? L<N, true, false>::run(a, st) : L<N, false, false>::run(a, st);
}

template <int N, bool PROBS, bool ROPE> struct CoreF32 {
    static cudaError_t run(const AttnArgs& a, cudaStream_t st) {
        return launch_attn_core_f32<N, PROBS, ROPE>(a, st);
    }
};

template <int N, bool PROBS, bool ROPE> struct CoreMma {
    static cudaError_t run(const AttnArgs& a, cudaStream_t st) {
        return launch_attn_core_mma<N, PROBS, ROPE>(a, st);
    }
};

// dtype 1 (bf16): attn_core_mma with dh padded to 32, 64 or 128; dtype 0 (f32):
// attn_core_f32 with 1, 2 or 4 columns of 32 per lane.
cudaError_t attn_core_dispatch(int dtype, const AttnArgs& a, cudaStream_t st) {
    if (dtype == 1) {
        if (a.dh <= 32) return attn_core_flags<2, CoreMma>(a, st);
        if (a.dh <= 64) return attn_core_flags<4, CoreMma>(a, st);
        return attn_core_flags<8, CoreMma>(a, st);
    }
    if (dtype == 0) {
        if (a.dh <= 32) return attn_core_flags<1, CoreF32>(a, st);
        if (a.dh <= 64) return attn_core_flags<2, CoreF32>(a, st);
        return attn_core_flags<4, CoreF32>(a, st);
    }
    return cudaErrorInvalidValue;
}

// attn_bwd_q: shared memory of query rows qs, dattn rows das (QT x dh each), a key and a
// value tile (KT x ks_ld), and one QT x KT tile of probabilities or dlog.
__host__ __device__ inline size_t bwd_q_smem_floats(int dh) {
    return 2 * (size_t)QT * dh + 2 * (size_t)KT * ks_ld(dh) + (size_t)QT * KT;
}

// attn_bwd_kv: key and value rows (KT x dh each), a query and a dattn tile (QT x ks_ld),
// and two KT x QT tiles (p_c and dlog).
__host__ __device__ inline size_t bwd_kv_smem_floats(int dh) {
    return 2 * (size_t)KT * dh + 2 * (size_t)QT * ks_ld(dh) + 2 * (size_t)KT * QT;
}

// Row statistics: stats[(which * R * H + b * H + h) * S + i], which 0 = max, 1 = sum of exp,
// 2 = delta.
__device__ __forceinline__ size_t stat_at(int which, size_t RHS, int b, int H, int h, int S,
                                          int i) {
    return which * RHS + ((size_t)b * H + h) * S + i;
}

template <typename T, int DC, bool ROPE>
__global__ void __launch_bounds__(AC_WARPS * 32)
attn_bwd_q(const T* __restrict__ qkv, const T* __restrict__ dattn, T* __restrict__ attn,
           T* __restrict__ dqkv, float* __restrict__ stats, const float* __restrict__ rope_cos,
           const float* __restrict__ rope_sin, int table_stride, int S, int H, int dh,
           int causal, int diag, float scale, int q_tiles, size_t RHS) {
    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                       // QT x dh
    float* das = qs + QT * dh;              // QT x dh
    float* ks = das + QT * dh;              // KT x ks_ld(dh)
    float* vs = ks + KT * ks_ld(dh);        // KT x ks_ld(dh)
    float* ps = vs + KT * ks_ld(dh);        // QT x KT

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * QT, h = blockIdx.y;
    const int D = H * dh;
    const size_t stride = 3 * (size_t)D;
    const T* base = qkv + (size_t)b * S * stride;
    const int q_end = min(S, q0 + QT);
    // Keys past q_end - 1 + diag are masked for every row of this tile under the causal
    // mask: their pf is exactly 0, so they are not visited at all.
    const int kend = causal ? min(S, q_end + diag) : S;
    // ROPE: this sequence's tables; q and k are rotated as attn_core and attn_bwd_kv rotate
    // them, so pf and dlog stay bit-identical across the two launches.
    const float* tc = ROPE ? rope_cos + (size_t)b * table_stride : nullptr;
    const float* ts = ROPE ? rope_sin + (size_t)b * table_stride : nullptr;

    stage_qk<T, ROPE>(qs, dh, base + h * dh, stride, q0, q_end - q0, QT, dh, tc, ts);
    stage_rows(das, dh, dattn + (size_t)b * S * D + h * dh, (size_t)D, q0, q_end - q0, QT, dh);

    float m[RPW], s[RPW], delta[RPW], acc[RPW], dpa[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) { m[r] = -INFINITY; s[r] = 0.f; delta[r] = 0.f; }

    // Pass 1: row max and sum of exp over all key tiles.
    for (int k0 = 0; k0 < kend; k0 += KT) {
        __syncthreads();
        stage_qk<T, ROPE>(ks, ks_ld(dh), base + D + h * dh, stride, k0, min(KT, kend - k0), KT,
                          dh, tc, ts);
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

    // Pass 2: pf and p_c; attn = p_c . v in f32; delta = rowsum(dp * pf).
    {
        float o[RPW][DC];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int c = 0; c < DC; ++c) o[r][c] = 0.f;
        for (int k0 = 0; k0 < kend; k0 += KT) {
            const int nk = min(KT, kend - k0);
            __syncthreads();
            stage_qk<T, ROPE>(ks, ks_ld(dh), base + D + h * dh, stride, k0, nk, KT, dh, tc, ts);
            stage_rows(vs, ks_ld(dh), base + 2 * D + h * dh, stride, k0, nk, KT, dh);
            __syncthreads();
            tile_dots(qs, ks, warp, lane, dh, acc);
            tile_dots(das, vs, warp, lane, dh, dpa);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float l = masked_logit(acc[r], scale, k0 + lane, kend,
                                             q0 + warp * RPW + r, causal, diag);
                const float pf = expf(l - m[r]) / s[r];
                delta[r] += warp_sum(dpa[r] * pf);
                ps[(warp * RPW + r) * KT + lane] = to_f32(from_f32<T>(pf));
            }
            __syncwarp();
            for (int j = 0; j < nk; ++j) {
                float vv[DC];
#pragma unroll
                for (int c = 0; c < DC; ++c) {
                    const int d = lane + 32 * c;
                    vv[c] = d < dh ? vs[j * ks_ld(dh) + d] : 0.f;
                }
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    const float p = ps[(warp * RPW + r) * KT + j];
#pragma unroll
                    for (int c = 0; c < DC; ++c) o[r][c] = fmaf(p, vv[c], o[r][c]);
                }
            }
            __syncwarp();
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int qi = q0 + warp * RPW + r;
            if (qi >= S) continue;
            T* orow = attn + ((size_t)b * S + qi) * D + h * dh;
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = lane + 32 * c;
                if (d < dh) orow[d] = from_f32<T>(o[r][c]);
            }
        }
    }

    // Pass 3: dlog = (pf * (dp - delta)) * scale rounded; dq = dlog . k in f32.
    float dq[RPW][DC];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += KT) {
        const int nk = min(KT, kend - k0);
        __syncthreads();
        stage_qk<T, ROPE>(ks, ks_ld(dh), base + D + h * dh, stride, k0, nk, KT, dh, tc, ts);
        stage_rows(vs, ks_ld(dh), base + 2 * D + h * dh, stride, k0, nk, KT, dh);
        __syncthreads();
        tile_dots(qs, ks, warp, lane, dh, acc);
        tile_dots(das, vs, warp, lane, dh, dpa);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float l = masked_logit(acc[r], scale, k0 + lane, kend,
                                         q0 + warp * RPW + r, causal, diag);
            const float pf = expf(l - m[r]) / s[r];
            ps[(warp * RPW + r) * KT + lane] = to_f32(from_f32<T>((pf * (dpa[r] - delta[r])) * scale));
        }
        __syncwarp();
        for (int j = 0; j < nk; ++j) {
            float kv[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = lane + 32 * c;
                kv[c] = d < dh ? ks[j * ks_ld(dh) + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float dl = ps[(warp * RPW + r) * KT + j];
#pragma unroll
                for (int c = 0; c < DC; ++c) dq[r][c] = fmaf(dl, kv[c], dq[r][c]);
            }
        }
        __syncwarp();
    }

    // ROPE: dq = dlog . k_rot is rounded, parked in this warp's own rows of qs (no other
    // warp reads them) and un-rotated by the query's position.
    if (ROPE) park_rounded<T, DC>(qs + warp * RPW * dh, dq, dh, lane);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int qi = q0 + warp * RPW + r;
        if (qi >= S) continue;
        T* dqrow = dqkv + ((size_t)b * S + qi) * stride + h * dh;
        if (ROPE) {
            store_unrotated(dqrow, qs + (warp * RPW + r) * dh, dh, tc + (size_t)qi * (dh / 2),
                            ts + (size_t)qi * (dh / 2), lane);
        } else {
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = lane + 32 * c;
                if (d < dh) dqrow[d] = from_f32<T>(dq[r][c]);
            }
        }
        if (lane == 0) {
            stats[stat_at(0, RHS, b, H, h, S, qi)] = m[r];
            stats[stat_at(1, RHS, b, H, h, S, qi)] = s[r];
            stats[stat_at(2, RHS, b, H, h, S, qi)] = delta[r];
        }
    }
}

// attn_bwd_kv: warps own key rows (RPW each), a lane owns one query of the current query
// tile in the logit loops and columns d = lane + 32 c in the accumulations.
template <typename T, int DC, bool ROPE>
__global__ void __launch_bounds__(AC_WARPS * 32)
attn_bwd_kv(const T* __restrict__ qkv, const T* __restrict__ dattn,
            const float* __restrict__ stats, T* __restrict__ dqkv,
            const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
            int table_stride, int S, int H, int dh, int causal, int diag, float scale,
            int k_tiles, size_t RHS) {
    extern __shared__ __align__(16) float smem[];
    float* kr = smem;                       // KT x dh   keys of this block
    float* vr = kr + KT * dh;               // KT x dh   values of this block
    float* qs = vr + KT * dh;               // QT x ks_ld(dh)
    float* das = qs + QT * ks_ld(dh);       // QT x ks_ld(dh)
    float* ps = das + QT * ks_ld(dh);       // KT x QT   p_c
    float* dls = ps + KT * QT;              // KT x QT   dlog

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * KT, h = blockIdx.y;
    const int D = H * dh;
    const size_t stride = 3 * (size_t)D;
    const T* base = qkv + (size_t)b * S * stride;
    const T* dbase = dattn + (size_t)b * S * D + h * dh;
    const int nk = min(KT, S - k0);
    const float* tc = ROPE ? rope_cos + (size_t)b * table_stride : nullptr;
    const float* ts = ROPE ? rope_sin + (size_t)b * table_stride : nullptr;

    stage_qk<T, ROPE>(kr, dh, base + D + h * dh, stride, k0, nk, KT, dh, tc, ts);
    stage_rows(vr, dh, base + 2 * D + h * dh, stride, k0, nk, KT, dh);

    float dk[RPW][DC], dv[RPW][DC], acc[RPW], dpa[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) { dk[r][c] = 0.f; dv[r][c] = 0.f; }

    // Under the causal mask query i sees key j only when j <= i + diag: the query tiles
    // wholly before k0 - diag add exactly 0 and are skipped.
    const int q_start = causal ? (max(0, k0 - diag) / QT) * QT : 0;
    for (int q0 = q_start; q0 < S; q0 += QT) {
        const int nq = min(QT, S - q0);
        __syncthreads();
        stage_qk<T, ROPE>(qs, ks_ld(dh), base + h * dh, stride, q0, nq, QT, dh, tc, ts);
        stage_rows(das, ks_ld(dh), dbase, (size_t)D, q0, nq, QT, dh);
        __syncthreads();
        const int qi = q0 + lane;
        const bool valid = lane < nq;
        const float mi = valid ? stats[stat_at(0, RHS, b, H, h, S, qi)] : 0.f;
        const float si = valid ? stats[stat_at(1, RHS, b, H, h, S, qi)] : 1.f;
        const float di = valid ? stats[stat_at(2, RHS, b, H, h, S, qi)] : 0.f;
        tile_dots(kr, qs, warp, lane, dh, acc);
        tile_dots(vr, das, warp, lane, dh, dpa);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int key = k0 + warp * RPW + r;
            const float l = (causal && key > qi + diag) ? -1e10f : acc[r] * scale;
            const float pf = valid ? expf(l - mi) / si : 0.f;
            ps[(warp * RPW + r) * QT + lane] = to_f32(from_f32<T>(pf));
            dls[(warp * RPW + r) * QT + lane] = to_f32(from_f32<T>((pf * (dpa[r] - di)) * scale));
        }
        __syncwarp();
        for (int i = 0; i < nq; ++i) {
            float qv[DC], dav[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = lane + 32 * c;
                qv[c] = d < dh ? qs[i * ks_ld(dh) + d] : 0.f;
                dav[c] = d < dh ? das[i * ks_ld(dh) + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float p = ps[(warp * RPW + r) * QT + i];
                const float dl = dls[(warp * RPW + r) * QT + i];
#pragma unroll
                for (int c = 0; c < DC; ++c) {
                    dv[r][c] = fmaf(p, dav[c], dv[r][c]);
                    dk[r][c] = fmaf(dl, qv[c], dk[r][c]);
                }
            }
        }
        __syncwarp();
    }

    // ROPE: dk = dlog^T . q_rot is rounded, parked in this warp's own rows of kr and
    // un-rotated by the key's position; dv is never rotated.
    if (ROPE) park_rounded<T, DC>(kr + warp * RPW * dh, dk, dh, lane);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int key = k0 + warp * RPW + r;
        if (key >= S) continue;
        T* row = dqkv + ((size_t)b * S + key) * stride + h * dh;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            const int d = lane + 32 * c;
            if (d < dh) {
                if (!ROPE) row[D + d] = from_f32<T>(dk[r][c]);
                row[2 * D + d] = from_f32<T>(dv[r][c]);
            }
        }
        if (ROPE)
            store_unrotated(row + D, kr + (warp * RPW + r) * dh, dh, tc + (size_t)key * (dh / 2),
                            ts + (size_t)key * (dh / 2), lane);
    }
}

template <typename T, int DC, bool ROPE>
cudaError_t launch_attn_bwd(const AttnArgs& a, cudaStream_t stream) {
    const size_t smem_q = bwd_q_smem_floats(a.dh) * sizeof(float);
    const size_t smem_kv = bwd_kv_smem_floats(a.dh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_q<T, DC, ROPE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_kv<T, DC, ROPE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    const size_t RHS = (size_t)a.B * a.H * a.S;
    const int tiles = (a.S + QT - 1) / QT;   // QT == KT
    dim3 grid((unsigned)a.B * tiles, a.H);
    attn_bwd_q<T, DC, ROPE><<<grid, AC_WARPS * 32, smem_q, stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const T*>(a.dattn), static_cast<T*>(a.attn),
        static_cast<T*>(a.dqkv), static_cast<float*>(a.stats), a.cos, a.sin, a.table_stride,
        a.S, a.H, a.dh, a.causal, a.diag, a.scale, tiles, RHS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_kv<T, DC, ROPE><<<grid, AC_WARPS * 32, smem_kv, stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const T*>(a.dattn),
        static_cast<const float*>(a.stats), static_cast<T*>(a.dqkv), a.cos, a.sin,
        a.table_stride, a.S, a.H, a.dh, a.causal, a.diag, a.scale, tiles, RHS);
    return cudaGetLastError();
}

template <int DC>
cudaError_t attn_bwd_f32(const AttnArgs& a, cudaStream_t st) {
    return a.cos ? launch_attn_bwd<float, DC, true>(a, st)
                 : launch_attn_bwd<float, DC, false>(a, st);
}

// ---------------------------------------------------------------------------------------
// attn_bwd_q_mma, attn_bwd_kv_mma: the bf16 backward core on tensor cores (design in the
// note at the top). Tiles as attn_core_mma's: a warp owns 16 rows, dh is padded to
// DHP = 16 DK, rows of stride DHP + 8 in shared memory.
// ---------------------------------------------------------------------------------------

// A logit of the backward: the scaled dot product rounded on its own (__fmul_rn is never
// contracted into an fma), -1e10 for causal-masked keys, -inf for keys past kend. pf and
// dlog below round every step the same way, so the two launches form the same bits.
__device__ __forceinline__ float bwd_logit(float dot, float scale, int key, int kend, int qi,
                                           int causal, int diag) {
    if (key >= kend) return -INFINITY;
    return (causal && key > qi + diag) ? -1e10f : __fmul_rn(dot, scale);
}

__device__ __forceinline__ float bwd_pf(float l, float m, float s) {
    return __fdiv_rn(expf(__fsub_rn(l, m)), s);
}

__device__ __forceinline__ float bwd_dlog(float pf, float dp, float delta, float scale) {
    return __fmul_rn(__fmul_rn(pf, __fsub_rn(dp, delta)), scale);
}

// Masks the 16 x 16 chunk l (queries q0 + row, keys key0 + column, accumulator layout).
__device__ __forceinline__ void bwd_mask(float (&l)[2][4], float scale, int key0, int q0,
                                         int kend, int causal, int diag, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            l[j][e] = bwd_logit(l[j][e], scale, key0 + 8 * j + 2 * t + (e & 1), kend,
                                q0 + g + 8 * (e >> 1), causal, diag);
}

// chunk_dots with A's rows loaded from as and X's B fragments held in registers (KH ==
// DK) or loaded again from xs (KH == 1): the same mma sequence, so the same bits.
template <int DK, int KH>
__device__ __forceinline__ void chunk_dots_held(float (&c)[2][4], const bf16* as,
                                                const uint32_t (&held)[KH][4], const bf16* xs,
                                                int lane) {
    constexpr int LD = 16 * DK + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK; ++kd) {
        uint32_t a[4], xb[4];
        frag::load_a(a, as + kd * 16, LD, lane);
        if constexpr (KH == DK) {
#pragma unroll
            for (int i = 0; i < 4; ++i) xb[i] = held[kd][i];
        } else {
            frag::load_bt(xb, xs + kd * 16, LD, lane);
        }
        frag::mma(c[0], a, xb[0], xb[1]);
        frag::mma(c[1], a, xb[2], xb[3]);
    }
}

// acc (16 x 16 DK) += a . X, X's 16 rows (the depth of the product) at xs, by ldmatrix.trans.
template <int DK>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * DK][4], const uint32_t (&a)[4],
                                         const bf16* xs, int lane) {
    constexpr int LD = 16 * DK + 8;
#pragma unroll
    for (int dn = 0; dn < DK; ++dn) {
        uint32_t xb[4];
        frag::load_b(xb, xs + dn * 16, LD, lane);
        frag::mma(acc[2 * dn], a, xb[0], xb[1]);
        frag::mma(acc[2 * dn + 1], a, xb[2], xb[3]);
    }
}

// ROPE: dq or dk of a warp's 16 rows, rounded to bf16 and parked as f32 in `park` (16 rows
// of dh, read only by this warp), then each row un-rotated by its position's table row
// and rounded again by store_unrotated. out: row 0's dh values, rows `stride` apart.
template <int DK>
__device__ __forceinline__ void store_rows_unrotated(bf16* out, size_t stride,
                                                     const float (&acc)[2 * DK][4], float* park,
                                                     int row0, int nrows, int dh,
                                                     const float* tc, const float* ts,
                                                     int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 2 * DK; ++n) {
            const int col = 8 * n + 2 * t;
            if (col < dh) {
                park[(g + 8 * r) * dh + col] = __bfloat162float(__float2bfloat16(acc[n][2 * r]));
                park[(g + 8 * r) * dh + col + 1] =
                    __bfloat162float(__float2bfloat16(acc[n][2 * r + 1]));
            }
        }
    __syncwarp();
    const int half = dh / 2;
    for (int r = 0; r < nrows; ++r)
        store_unrotated(out + (size_t)r * stride, park + r * dh, dh,
                        tc + (size_t)(row0 + r) * half, ts + (size_t)(row0 + r) * half, lane);
}

// One block per (sequence, query tile of 16 W rows, head); W warps of 16 query rows. A
// warp keeps its q and dA fragments in registers and walks the key tiles of MK rows three
// times: pass 1 the row max m and sum s, pass 2 attn = p_c . v and delta = rowsum(dp pf),
// pass 3 dq = dlog . k. Shared memory: q and dA tiles (16 W rows each), then nbuf buffers
// of kt key rows followed by kt value rows; after the passes, ROPE parks dq where the key
// buffers were.
template <int DK, bool ROPE>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
attn_bwd_q_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
               bf16* __restrict__ attn, bf16* __restrict__ dqkv, float* __restrict__ stats,
               const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
               int table_stride, int S, int H, int dh, int causal, int diag, float scale,
               int q_tiles, int kt, int nbuf, size_t RHS) {
    constexpr int DHP = 16 * DK, LD = DHP + 8, CHUNKS = MK / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = blockDim.x / 32, QTW = MQ * W;
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* das = qs + QTW * LD;
    bf16* kv = das + QTW * LD;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * QTW, h = blockIdx.y;
    const int D = H * dh;
    const size_t stride = 3 * (size_t)D;
    const bf16* base = qkv + (size_t)b * S * stride + h * dh;
    const bf16* dbase = dattn + (size_t)b * S * D + h * dh;
    const int q_end = min(S, q0 + QTW);
    // Keys past q_end - 1 + diag are masked for every row of the block, and keys past
    // min(S, wq0 + 16) - 1 + diag for every row of the warp: pf is exactly 0 there, so
    // they are not visited.
    const int kend = causal ? min(S, q_end + diag) : S;
    const int nt = (kend + MK - 1) / MK;
    const int wq0 = q0 + warp * MQ;
    const bool active = wq0 < S;
    const int kend_w = causal ? min(S, min(S, wq0 + MQ) + diag) : S;
    const float* tc = ROPE ? rope_cos + (size_t)b * table_stride : nullptr;
    const float* ts = ROPE ? rope_sin + (size_t)b * table_stride : nullptr;

    // Zero columns dh .. DHP - 1 of every tile once; the staging never writes them.
    if (dh < DHP) {
        const int rows = 2 * QTW + 2 * nbuf * kt, pad = DHP - dh;
        for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
            qs[(i / pad) * LD + dh + i % pad] = __float2bfloat16(0.f);
    }

    // Step s is pass s / nt over key tile s % nt; each step's tiles are staged during the
    // step before (two buffers). With one key tile, k and v are staged once, in step 0.
    const int steps = 3 * nt;
    auto keys_of = [&](int s) { return kv + (size_t)(nt == 1 ? 0 : (s & 1)) * 2 * kt * LD; };
    auto stage_step = [&](int s) {
        if (nt == 1 && s > 0) return;
        const int k0 = (s % nt) * MK;
        const int nk = min(MK, kend - k0), rows = (nk + 15) & ~15;
        bf16* ks = keys_of(s);
        if (ROPE)
            stage_rope(ks, LD, base + D, stride, k0, nk, rows, dh, tc, ts);
        else
            stage_async(ks, LD, base + D, stride, k0, nk, rows, dh);
        if (nt == 1 || s >= nt)
            stage_async(ks + kt * LD, LD, base + 2 * D, stride, k0, nk, rows, dh);
    };

    if (ROPE)
        stage_rope(qs, LD, base, stride, q0, q_end - q0, QTW, dh, tc, ts);
    else
        stage_async(qs, LD, base, stride, q0, q_end - q0, QTW, dh);
    stage_async(das, LD, dbase, (size_t)D, q0, q_end - q0, QTW, dh);
    stage_step(0);
    frag::cp_async_commit();

    uint32_t qf[DK][4], daf[DK][4];
    float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float dsum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
    float acc[2 * DK][4];   // attn in pass 2, dq in pass 3
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) {
            stage_step(s + 1);
            frag::cp_async_commit();
            frag::cp_async_wait<1>();
        } else {
            frag::cp_async_wait<0>();
        }
        __syncthreads();
        if (s == 0 && active) {
#pragma unroll
            for (int kd = 0; kd < DK; ++kd) {
                frag::load_a(qf[kd], qs + warp * MQ * LD + kd * 16, LD, lane);
                frag::load_a(daf[kd], das + warp * MQ * LD + kd * 16, LD, lane);
            }
        }
        const int pass = s / nt, k0 = (s - pass * nt) * MK;
        const bf16* ks = keys_of(s);
        const bf16* vs = ks + kt * LD;
        if (active && pass == 2 && k0 == 0) {
            // Pass 2 is over: delta's quad sums, attn written, the accumulator freed for dq.
#pragma unroll
            for (int r = 0; r < 2; ++r) delta[r] = frag::quad_sum(dsum[r]);
            store_rows<DK>(attn + ((size_t)b * S + wq0) * D + h * dh, (size_t)D, acc, S - wq0,
                           dh, lane);
#pragma unroll
            for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        }
        if (active && k0 < kend_w && pass == 0) {
            // Pass 1: the tile's row max, then the sum of exp against the new max.
            float l[CHUNKS][2][4];
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                if (k0 + 16 * c < kend_w) {
                    chunk_dots<DK>(l[c], qf, ks + 16 * c * LD, lane);
                    bwd_mask(l[c], scale, k0 + 16 * c, wq0, kend_w, causal, diag, lane);
                } else {
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) l[c][j][e] = -INFINITY;
                }
            }
            float mx[2] = {-INFINITY, -INFINITY}, add[2] = {0.f, 0.f};
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], l[c][j][e]);
#pragma unroll
            for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], frag::quad_max(mx[r]));
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) add[e >> 1] += expf(l[c][j][e] - mx[e >> 1]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                sum[r] = sum[r] * expf(m[r] - mx[r]) + frag::quad_sum(add[r]);
                m[r] = mx[r];
            }
        } else if (active && k0 < kend_w) {
            // Pass 2: pf, p_c; attn += p_c . v; delta += rowsum(dp pf). Pass 3: dlog from
            // pf, dp and delta; dq += dlog . k. 16 keys at a time.
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                if (k0 + 16 * c >= kend_w) continue;
                float l[2][4], dp[2][4];
                chunk_dots<DK>(l, qf, ks + 16 * c * LD, lane);
                bwd_mask(l, scale, k0 + 16 * c, wq0, kend_w, causal, diag, lane);
                chunk_dots<DK>(dp, daf, vs + 16 * c * LD, lane);
                bf16 x[2][4];
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = e >> 1;
                        const float pf = bwd_pf(l[j][e], m[r], sum[r]);
                        if (pass == 1) {
                            dsum[r] += dp[j][e] * pf;
                            x[j][e] = __float2bfloat16(pf);
                        } else {
                            x[j][e] = __float2bfloat16(bwd_dlog(pf, dp[j][e], delta[r], scale));
                        }
                    }
                uint32_t a[4];
                frag::p_as_a(a, x);
                mma_rows<DK>(acc, a, (pass == 1 ? vs : ks) + 16 * c * LD, lane);
            }
        }
        __syncthreads();
    }
    if (!active) return;

    // dq (un-rotated under ROPE, parked where the key buffers were) and the statistics.
    bf16* dq = dqkv + ((size_t)b * S + wq0) * stride + h * dh;
    if (ROPE)
        store_rows_unrotated<DK>(dq, stride, acc, reinterpret_cast<float*>(kv) + warp * MQ * dh,
                                 wq0, min(MQ, S - wq0), dh, tc, ts, lane);
    else
        store_rows<DK>(dq, stride, acc, S - wq0, dh, lane);
    if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qi = wq0 + g + 8 * r;
            if (qi >= S) continue;
            stats[stat_at(0, RHS, b, H, h, S, qi)] = m[r];
            stats[stat_at(1, RHS, b, H, h, S, qi)] = sum[r];
            stats[stat_at(2, RHS, b, H, h, S, qi)] = delta[r];
        }
    }
}

// One block per (sequence, key tile of 16 W rows, head); W warps of 16 keys. A warp walks
// the query tiles of qt rows that can see its keys and, per chunk of 16 queries, forms
// the logits and dp with the query rows as the A operand (as attn_bwd_q_mma does), pf and
// dlog from the saved (m, s, delta), and accumulates dv += p_c^T . dA and dk += dlog^T . q
// with the transposed A fragments. Shared memory: the block's key and value rows (16 W
// each), then nbuf buffers of qt query rows followed by qt dA rows, then nbuf x 3 x qt f32
// statistics; after the loop, ROPE parks dk where the query buffers were.
template <int DK, bool ROPE>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
attn_bwd_kv_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
                const float* __restrict__ stats, bf16* __restrict__ dqkv,
                const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
                int table_stride, int S, int H, int dh, int causal, int diag, float scale,
                int k_tiles, int qt, int nbuf, size_t RHS) {
    constexpr int DHP = 16 * DK, LD = DHP + 8, CHUNKS = MK / 16;
    // The k and v B fragments stay in registers for dh <= 64; dh 128 loads them per chunk.
    constexpr int KH = DK <= 4 ? DK : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = blockDim.x / 32, KTW = MQ * W;
    bf16* ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* vs = ks + KTW * LD;
    bf16* qbuf = vs + KTW * LD;
    float* st = reinterpret_cast<float*>(qbuf + (size_t)nbuf * 2 * qt * LD);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2;
    const int b = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * KTW, h = blockIdx.y;
    const int D = H * dh;
    const size_t stride = 3 * (size_t)D;
    const bf16* base = qkv + (size_t)b * S * stride + h * dh;
    const bf16* dbase = dattn + (size_t)b * S * D + h * dh;
    const float* srow = stats + ((size_t)b * H + h) * S;
    const int wk0 = k0 + warp * MQ;
    const bool active = wk0 < S;
    const float* tc = ROPE ? rope_cos + (size_t)b * table_stride : nullptr;
    const float* ts = ROPE ? rope_sin + (size_t)b * table_stride : nullptr;

    if (dh < DHP) {
        const int rows = 2 * KTW + 2 * nbuf * qt, pad = DHP - dh;
        for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
            ks[(i / pad) * LD + dh + i % pad] = __float2bfloat16(0.f);
    }

    // Under the causal mask query i sees key j only when j <= i + diag: the queries before
    // k0 - diag add exactly 0 and are skipped. Query tiles start at a multiple of 16, so
    // each query sits at the same row of its 16-row chunk as in attn_bwd_q_mma.
    const int qbase = causal ? (max(0, k0 - diag) & ~15) : 0;
    const int steps = (S - qbase + qt - 1) / qt;
    auto qtile = [&](int s) { return qbuf + (size_t)(nbuf == 1 ? 0 : (s & 1)) * 2 * qt * LD; };
    auto stat_tile = [&](int s) { return st + (nbuf == 1 ? 0 : (s & 1)) * 3 * qt; };
    auto stage_step = [&](int s) {
        const int q0 = qbase + s * qt, nq = min(qt, S - q0), rows = (nq + 15) & ~15;
        bf16* qd = qtile(s);
        if (ROPE)
            stage_rope(qd, LD, base, stride, q0, nq, rows, dh, tc, ts);
        else
            stage_async(qd, LD, base, stride, q0, nq, rows, dh);
        stage_async(qd + qt * LD, LD, dbase, (size_t)D, q0, nq, rows, dh);
        float* sd = stat_tile(s);
        for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x) {
            const int which = i / rows, r = i - which * rows;
            const bool ok = r < nq;
            frag::cp_async<4>(sd + which * qt + r, srow + which * RHS + q0 + (ok ? r : 0), ok);
        }
    };

    const int nk = min(KTW, S - k0);
    if (ROPE)
        stage_rope(ks, LD, base + D, stride, k0, nk, KTW, dh, tc, ts);
    else
        stage_async(ks, LD, base + D, stride, k0, nk, KTW, dh);
    stage_async(vs, LD, base + 2 * D, stride, k0, nk, KTW, dh);
    stage_step(0);
    frag::cp_async_commit();

    uint32_t kf[KH][4], vf[KH][4];
    float dk[2 * DK][4], dv[2 * DK][4];
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    const bf16* kw = ks + warp * MQ * LD;
    const bf16* vw = vs + warp * MQ * LD;

    for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) {
            stage_step(s + 1);
            frag::cp_async_commit();
            frag::cp_async_wait<1>();
        } else {
            frag::cp_async_wait<0>();
        }
        __syncthreads();
        if (s == 0 && active && KH == DK) {
#pragma unroll
            for (int kd = 0; kd < KH; ++kd) {
                frag::load_bt(kf[kd], kw + kd * 16, LD, lane);
                frag::load_bt(vf[kd], vw + kd * 16, LD, lane);
            }
        }
        const int q0 = qbase + s * qt;
        const bf16* qd = qtile(s);
        const bf16* dd = qd + qt * LD;
        const float* sd = stat_tile(s);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
            const int qc = q0 + 16 * c;
            if (!active || 16 * c >= qt || qc >= S) break;
            if (causal && qc + 16 + diag <= wk0) continue;   // no query of the chunk sees a key
            float l[2][4], dp[2][4];
            chunk_dots_held<DK, KH>(l, qd + 16 * c * LD, kf, kw, lane);
            bwd_mask(l, scale, wk0, qc, S, causal, diag, lane);
            chunk_dots_held<DK, KH>(dp, dd + 16 * c * LD, vf, vw, lane);
            float mi[2], si[2], di[2];
            bool valid[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = 16 * c + g + 8 * r;
                valid[r] = qc + g + 8 * r < S;
                mi[r] = sd[i];
                si[r] = sd[qt + i];
                di[r] = sd[2 * qt + i];
            }
            bf16 p[2][4], dl[2][4];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1;
                    const float pf = valid[r] ? bwd_pf(l[j][e], mi[r], si[r]) : 0.f;
                    p[j][e] = __float2bfloat16(pf);
                    dl[j][e] = __float2bfloat16(bwd_dlog(pf, dp[j][e], di[r], scale));
                }
            uint32_t a[4], at[4];
            frag::p_as_a(a, p);
            frag::transpose_a(at, a);
            mma_rows<DK>(dv, at, dd + 16 * c * LD, lane);
            frag::p_as_a(a, dl);
            frag::transpose_a(at, a);
            mma_rows<DK>(dk, at, qd + 16 * c * LD, lane);
        }
        __syncthreads();
    }
    if (!active) return;

    // dv, and dk (un-rotated under ROPE, parked where the query buffers were).
    bf16* row = dqkv + ((size_t)b * S + wk0) * stride + h * dh;
    store_rows<DK>(row + 2 * D, stride, dv, S - wk0, dh, lane);
    if (ROPE)
        store_rows_unrotated<DK>(row + D, stride, dk,
                                 reinterpret_cast<float*>(qbuf) + warp * MQ * dh, wk0,
                                 min(MQ, S - wk0), dh, tc, ts, lane);
    else
        store_rows<DK>(row + D, stride, dk, S - wk0, dh, lane);
}

template <int DK, bool ROPE>
cudaError_t launch_attn_bwd_mma(const AttnArgs& a, cudaStream_t stream) {
    // Tiles from S as launch_attn_core_mma's: one warp per 16 rows up to 4; key (query)
    // buffers of round_up(S, 16) rows up to MK, two of them when S > MK. The rope park
    // (16 rows of dh f32 per warp) reuses the buffers.
    const int warps = min(MMA_MAX_WARPS, (a.S + MQ - 1) / MQ), rows = MQ * warps;
    const int kt = min(MK, (a.S + 15) & ~15), nbuf = a.S > MK ? 2 : 1;
    const size_t row_bytes = (size_t)(16 * DK + 8) * sizeof(bf16);
    const size_t park = (size_t)rows * a.dh * sizeof(float);
    const size_t bufs = 2 * (size_t)nbuf * kt * row_bytes;
    const size_t smem_q = 2 * rows * row_bytes + (bufs > park ? bufs : park);
    const size_t bufs_kv = bufs + 3 * (size_t)nbuf * kt * sizeof(float);
    const size_t smem_kv = 2 * rows * row_bytes + (bufs_kv > park ? bufs_kv : park);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_mma<DK, ROPE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_kv_mma<DK, ROPE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    const size_t RHS = (size_t)a.B * a.H * a.S;
    const int tiles = (a.S + rows - 1) / rows;
    dim3 grid((unsigned)a.B * tiles, a.H);
    attn_bwd_q_mma<DK, ROPE><<<grid, warps * 32, smem_q, stream>>>(
        static_cast<const bf16*>(a.qkv), static_cast<const bf16*>(a.dattn),
        static_cast<bf16*>(a.attn), static_cast<bf16*>(a.dqkv), static_cast<float*>(a.stats),
        a.cos, a.sin, a.table_stride, a.S, a.H, a.dh, a.causal, a.diag, a.scale, tiles, kt,
        nbuf, RHS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_kv_mma<DK, ROPE><<<grid, warps * 32, smem_kv, stream>>>(
        static_cast<const bf16*>(a.qkv), static_cast<const bf16*>(a.dattn),
        static_cast<const float*>(a.stats), static_cast<bf16*>(a.dqkv), a.cos, a.sin,
        a.table_stride, a.S, a.H, a.dh, a.causal, a.diag, a.scale, tiles, kt, nbuf, RHS);
    return cudaGetLastError();
}

template <int DK>
cudaError_t attn_bwd_mma(const AttnArgs& a, cudaStream_t st) {
    return a.cos ? launch_attn_bwd_mma<DK, true>(a, st) : launch_attn_bwd_mma<DK, false>(a, st);
}

// dtype 1 (bf16): attn_bwd_{q,kv}_mma with dh padded to 32, 64 or 128; dtype 0 (f32):
// attn_bwd_{q,kv} on the CUDA cores with 1, 2 or 4 columns of 32 per lane.
cudaError_t attn_bwd_dispatch(int dtype, const AttnArgs& a, cudaStream_t st) {
    if (dtype == 1) {
        if (a.dh <= 32) return attn_bwd_mma<2>(a, st);
        if (a.dh <= 64) return attn_bwd_mma<4>(a, st);
        return attn_bwd_mma<8>(a, st);
    }
    if (dtype == 0) {
        if (a.dh <= 32) return attn_bwd_f32<1>(a, st);
        if (a.dh <= 64) return attn_bwd_f32<2>(a, st);
        return attn_bwd_f32<4>(a, st);
    }
    return cudaErrorInvalidValue;
}


// Rejects what the attention launches do not take: rope tables come as a pair, and a
// table stride is 0 (one table) or S dh/2 (one table per sequence).
bool bad_attn(int B, int S, int H, int dh, const void* cos, const void* sin, int table_stride) {
    if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh > 128 || dh % 4) return true;
    if ((cos == nullptr) != (sin == nullptr)) return true;
    return cos != nullptr && table_stride != 0 && table_stride != S * (dh / 2);
}


}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns cudaGetLastError() after
// its launches (0 on success); the caller checks shapes, dtypes and alignment.

// qkv (B, S, 3D) -> attn (B, S, D); probs, when not null, (B, H, S, S) receives the
// probabilities in the compute dtype (K3), zero where the causal mask drops a key. With
// cos and sin (f32 rope tables, (S, dh/2) with table_stride 0 or (B, S, dh/2) with
// table_stride S dh/2) q and k are rotated (K1r, K2r, K3r); both null without rope.
extern "C" int tcow_attn_core(int dtype, const void* qkv, void* out, void* probs,
                              const float* cos, const float* sin, int table_stride, int B,
                              int S, int H, int dh, int causal, int diag, float scale,
                              void* stream) {
    if (bad_attn(B, S, H, dh, cos, sin, table_stride)) return (int)cudaErrorInvalidValue;
    const AttnArgs a{qkv, nullptr, out, probs, nullptr, nullptr, cos, sin, table_stride,
                     B, S, H, dh, causal, diag, scale};
    return (int)attn_core_dispatch(dtype, a, static_cast<cudaStream_t>(stream));
}

// qkv (B, S, 3D) and dattn (B, S, D) -> attn (B, S, D), dqkv (B, S, 3D); stats is f32
// scratch of 3 * B * H * S values. cos, sin and table_stride as for tcow_attn_core (K4r,
// K5r, K6r): dq and dk are un-rotated before they are written.
extern "C" int tcow_attn_bwd(int dtype, const void* qkv, const void* dattn, void* attn,
                             void* dqkv, void* stats, const float* cos, const float* sin,
                             int table_stride, int B, int S, int H, int dh, int causal,
                             int diag, float scale, void* stream) {
    if (bad_attn(B, S, H, dh, cos, sin, table_stride)) return (int)cudaErrorInvalidValue;
    const AttnArgs a{qkv, dattn, attn, nullptr, dqkv, stats, cos, sin, table_stride,
                     B, S, H, dh, causal, diag, scale};
    return (int)attn_bwd_dispatch(dtype, a, static_cast<cudaStream_t>(stream));
}
