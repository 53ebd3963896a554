// The GEMMs of the attention chains K1-K6 for Hopper (sm_90a), bound through ctypes as a
// library of its own, built beside fused_attention.cu:
//   gemm_bias  C (M, N) = round(A (M, K) . round(W) + bias): the sum and the bias in f32,
//              rounded once to the compute dtype; W (K, N), or (N, K) for C = A . W^T; the
//              bias may be null.
//   wgrad      f32 (K, N) = A^T . B summed over the M rows of A (M, K) and B (M, N).
//   colsum     f32 (N) = the sum of the M rows of A (M, N).
// wgrad and colsum are deterministic: the rows are cut into runs fixed by the shape, one
// block sums a run into part[run] in an order fixed by the shape, and sum_splits adds the
// runs in order. No atomics: the same inputs give the same bits on every run.
//
// Replace: the products inside the Pallas kernels of tcow_tpu/ops/pallas_attention.py.
// gemm_bias: qkv = x . qkv_w + qkv_b (:101-104), out = attn . proj_w + proj_b (:147-150),
// the backward's qkv recompute (:573-575), dattn = g . proj_w^T (:587-590) and K6's dx =
// dqkv . qkv_w^T (:643-645). wgrad: K6's weight gradients x^T . dqkv and attn^T . g
// (:655-660; the same dots K4 and K5 leave to XLA at :771-777), colsum its bias gradients.
// The chains in fused_attention.py launch them around the attention cores.
//
// ---- bf16: wgmma fed by TMA through an mbarrier ring (gemm_bias_sm90, wgrad_sm90) ----
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s) at the training step of record
// (54,000 rows, D = 768): a qkv, dx or x^T . dqkv launch is 191 GFLOP (0.193 ms) against
// ~0.1-0.33 GB of operands and result (<= 0.1 ms), a proj, dattn or attn^T . g launch
// 64 GFLOP (0.064 ms): operations-bound, ~600 operations per byte. The wmma kernels they
// replace ran at ~11 % of it: synchronous loads without a copy pipeline, 16x16x16 warp
// products, and W converted from f32 in every tile of every block.
//
// What the design does about it:
//   - Operands in bf16 only, in the layout TMA copies as it is: A (M, K) row-major is
//     K-major; the wrapper hands gemm_bias its weight as a (N, K) bf16 tensor, K-major
//     too (fused_attention.py:gemm_weight, one rounding of W to nearest even, the bits the
//     wmma kernel's per-tile __floats2bfloat162_rn gave and the JAX kernel's .astype).
//   - A block of 3 warpgroups: warpgroup 0 is the producer, one thread of it issuing
//     cp.async.bulk.tensor loads into a ring of stages (A tile 128 x 64 and B tile
//     256 x 64 per stage, 48 KB, 128-byte swizzled; 3 stages for gemm_bias beside its
//     64 KB output staging, 4 for wgrad) with a full and an empty mbarrier per stage;
//     warpgroups 1 and 2 are consumers, each running wgmma.mma_async m64n256k16 (bf16
//     in, f32 accumulate in 128 registers a thread) on its 64 rows of the 128 x 256 tile
//     as the stages arrive, one group of 4 k16 products in flight while the next stage is
//     waited for. setmaxnreg moves registers from the producer (40) to the consumers
//     (232). The 256-wide tile reads 48 KB of shared memory per 4.2 MFLOP, within the
//     SM's shared-memory and L2 rates, where 128 x 128 would need a third more bytes per
//     operation (it measured no faster on the card).
//   - Persistent: one block per SM walks the work units (output tiles, for wgrad times
//     the runs of rows), so the producer already loads the next unit while the consumers
//     store the last one.
//   - gemm_bias: both operands K-major (no transpose flag). K = 768 is only 12 stages a
//     tile, so the epilogue must not hold the consumers: each warpgroup adds the bias in
//     f32, rounds once to bf16, writes its 64 rows into shared memory in the 128-byte
//     swizzle (conflict-free 4-byte stores) and one thread stores them by TMA
//     (cp.async.bulk.tensor, a bulk group waited for only before the staging is written
//     again), while the warpgroup goes on to the next tile. Rows and columns past M and N
//     are zero-filled by TMA on load and not written on store. No split over K: the same
//     inputs give the same bits on every run.
//   - wgrad: the sum runs over the rows, the leading dimension of A and B in memory, so
//     both reach the wgmma as MN-major (transposed) operands: each stage holds 64 rows as
//     boxes of 64 columns x 64 rows, and the descriptors' leading offset steps from box
//     to box (64 columns) and their stride offset from 8 rows to the next 8; the
//     instruction's transpose flags are set for A and B. Runs are multiples of 64 rows
//     (one stage), so a stage never mixes two runs; the last run ends at M, past which TMA
//     fills zeros.
//   - Tried on the card beside the kept kernel and not kept, one call each:
//     128 x 128 tiles (no faster); 2-block clusters multicasting the B tile to halve its
//     L2 reads (half the speed, the persistent grid sized by
//     cudaOccupancyMaxActiveClusters); the bias staged in shared memory per tile (slower
//     than one 8-byte __ldg per column pair in the epilogue).
//   - TMA descriptors are encoded per call on the host (cuTensorMapEncodeTiled, looked
//     up at run time through the CUDA runtime's entry-point query, so the library needs
//     no -lcuda) and passed as __grid_constant__ kernel parameters.
// Rounding points: bf16 operands as given (W rounded once by the wrapper), products and
// sums in f32 in the tensor cores' order, the bias added in f32, one rounding to bf16
// (gemm_bias) or none (wgrad, f32 out; the runs added in f32 in run order). The order of
// the f32 sums differs from the wmma kernels', so the results are not the same bits as
// theirs; they are the same bits on every run.
//
// ---- f32: the CUDA cores ----
//
// gemm_bias_f32 and wgrad_f32 multiply with fmaf on the CUDA cores: the tensor cores take
// f32 only as TF32, whose ~10 mantissa bits would miss the 1e-4 limit of the f32 runs.
// colsum_part is bytes-bound (one add per element read) and reads 8 columns a thread
// with 16-byte loads in both dtypes.
//
#include <cuda.h>            // CUtensorMap and its enums (types only, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

// ---------------------------------------------------------------------------------------
// bf16: the TMA + wgmma pieces
// ---------------------------------------------------------------------------------------
constexpr int BM = 128;            // output rows of a tile: two consumer warpgroups of 64
constexpr int BN = 256;            // output columns of a tile: one m64n256k16 per k16 step
constexpr int BK = 64;             // depth of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int BOX = 64 * 64 * 2;   // one 64 x 64 bf16 box: 8 KB
constexpr int THREADS = 384;       // warpgroup 0 producer, 1 and 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_BUDGET = 208 * 1024;

// Shared memory of a block: the ring of STAGES stages (A tile BM x BK, then B tile
// BN x BK), for gemm_bias the output staging (per consumer warpgroup BN / 64 boxes of
// 64 rows x 64 columns, then BN f32 of bias), the 2 STAGES barriers, and slack to align
// the ring to 1024 bytes (the 128-byte swizzle repeats every 8 rows of 128 bytes).
template <bool WGRAD> struct Smem {
    static constexpr int A_BYTES = BM * BK * 2;
    static constexpr int STAGE = A_BYTES + BN * BK * 2;
    static constexpr int C_BYTES = WGRAD ? 0 : BM * BN * 2;
    static constexpr int STAGES = (SMEM_BUDGET - C_BYTES) / STAGE;
    static constexpr int BYTES = STAGES * STAGE + C_BYTES + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

// Synchronises the `threads` threads of named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A 2-D box of the tensor map at element coordinates (c0 inner, c1 outer) into shared
// memory at dst; completion counts its bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// A 2-D box from shared memory at src into the tensor map at (c0, c1); the parts outside
// the tensor are not written. Tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
                 ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
                 : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at byte address addr:
// leading and stride byte offsets (see the kernel), swizzle mode 1 (128 B) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
           (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Ties the accumulators to this point of the program, so that the compiler moves no
// access to them across the asynchronous wgmma (its fence, commit or wait).
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256, f32 registers) (+)= A (64 x 16) . B (16 x 256), both bf16 in shared memory
// by descriptor; scale_d 0 overwrites D. TA / TB: 0 K-major, 1 MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// One launch of gemm_bias (WGRAD false) or wgrad (WGRAD true). Work unit u covers an
// output tile of BM x BN and a range of k-blocks of BK:
//   gemm_bias  tile u of the (M / BM) x (N / BN) tiles, N fastest, all of K:
//              ta is A (M, K) in boxes of 64 (k) x BM (rows), tb B (N, K) in boxes of
//              64 (k) x BN (rows), tc C (M, N) bf16 in boxes of 64 x 64 (the stores).
//   wgrad      run u / tiles of kb_per_unit k-blocks of rows, tile u % tiles of the
//              (K / BM) x (N / BN) tiles: ta is A (rows, K) and tb B (rows, N), both in
//              boxes of 64 (columns) x 64 (rows); f32 (K, N) into part[run] of `part`.
// out_m x out_n is the output (M x N for gemm_bias, K x N for wgrad). The maps point at
// the launch's __grid_constant__ parameters.
template <bool WGRAD>
__device__ __forceinline__ void
gemm_sm90(const CUtensorMap* ta, const CUtensorMap* tb, const CUtensorMap* tc,
          const float* __restrict__ bias, float* __restrict__ part, int out_m, int out_n,
          int tiles_n, int tiles, int units, int kb_per_unit, int kb_total) {
    using S = Smem<WGRAD>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t cbuf = ring + S::STAGES * S::STAGE;
    const uint32_t full = cbuf + S::C_BYTES, empty = full + S::STAGES * 8;
    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S::STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    auto decode = [&](int u, int& m0, int& n0, int& kb0, int& kb1) {
        const int t = WGRAD ? u % tiles : u;
        m0 = (t / tiles_n) * BM;
        n0 = (t % tiles_n) * BN;
        kb0 = WGRAD ? (u / tiles) * kb_per_unit : 0;
        kb1 = min(kb_total, kb0 + kb_per_unit);
    };

    if (wg == 0) {
        // Producer: one thread keeps the ring full, unit after unit.
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x != 0) return;
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(ta)) : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tb)) : "memory");
        int s = 0;
        uint32_t phase = 0;
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            int m0, n0, kb0, kb1;
            decode(u, m0, n0, kb0, kb1);
            for (int kb = kb0; kb < kb1; ++kb) {
                mbar_wait(empty + 8 * s, phase ^ 1);
                const uint32_t bar = full + 8 * s, a = ring + s * S::STAGE, b = a + S::A_BYTES;
                mbar_expect_tx(bar, S::STAGE);
                if (WGRAD) {
#pragma unroll
                    for (int c = 0; c < BM / 64; ++c)
                        tma_load(a + c * BOX, ta, bar, m0 + 64 * c, kb * BK);
#pragma unroll
                    for (int c = 0; c < BN / 64; ++c)
                        tma_load(b + c * BOX, tb, bar, n0 + 64 * c, kb * BK);
                } else {
                    tma_load(a, ta, bar, kb * BK, m0);
                    tma_load(b, tb, bar, kb * BK, n0);
                }
                if (++s == S::STAGES) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // Consumers: warpgroup c = wg - 1 owns rows 64 c .. 64 c + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    // Descriptors (byte offsets; see the source note):
    //   K-major (gemm_bias): rows of 128 bytes, 8-row groups 1024 bytes apart (stride
    //     offset); the leading offset is unused with the 128-byte swizzle. k16 step j
    //     starts 32 j bytes into the rows; warpgroup c's A rows start at 64 c rows.
    //   MN-major (wgrad): boxes of 64 columns x 64 rows (8 KB) side by side along M or N
    //     (leading offset 8 KB), 8-row groups 1024 bytes apart (stride offset). k16 step j
    //     starts 16 j rows (2048 j bytes) in; warpgroup c's A columns are box c.
    constexpr uint32_t LBO = WGRAD ? BOX : 16, SBO = 1024, STEP = WGRAD ? 2048 : 32;
    constexpr uint32_t A_OFF = WGRAD ? BOX : 64 * 128;
    constexpr int TR = WGRAD ? 1 : 0;
    float acc[BN / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0, kb0, kb1;
        decode(u, m0, n0, kb0, kb1);
        int prev = -1;
        for (int kb = kb0; kb < kb1; ++kb) {
            mbar_wait(full + 8 * s, phase);
            const uint32_t a = ring + s * S::STAGE + c * A_OFF, b = ring + s * S::STAGE + S::A_BYTES;
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < BK / 16; ++j)
                wgmma_n256<TR, TR>(acc, smem_desc(a + j * STEP, LBO, SBO),
                                   smem_desc(b + j * STEP, LBO, SBO), kb > kb0 || j > 0);
            wgmma_commit();
            fence_acc(acc);
            if (prev >= 0) {
                // The products of the previous stage are done: hand its slot back.
                wgmma_wait<1>();
                fence_acc(acc);
                if (lane == 0) mbar_arrive(empty + 8 * prev);
            }
            prev = s;
            if (++s == S::STAGES) {
                s = 0;
                phase ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty + 8 * prev);

        // Epilogue: thread (warp, lane) holds rows 16 warp + lane / 4 and 8 more of its
        // warpgroup's 64, at columns 8 j + 2 (lane % 4) and the next, j = 0 .. BN / 8 - 1,
        // in acc[4 j .. 4 j + 3].
        const int row = 16 * warp + lane / 4;
        if (WGRAD) {
            // f32 partial sums straight to part[run]: a unit sums kb_per_unit stages, so
            // its stores are a small share of its time.
            float* out = part + (size_t)(kb0 / kb_per_unit) * out_m * out_n;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = m0 + 64 * c + row + 8 * h;
                    if (col < out_n && r < out_m)
                        *reinterpret_cast<float2*>(out + (size_t)r * out_n + col) =
                            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
                }
            }
        } else {
            // Add the bias, round once to bf16 and stage the warpgroup's 64 rows as BN / 64
            // boxes of 64 x 64, 128-byte swizzled as TMA stores them; its leader stores the
            // boxes while the warpgroup goes on to the next unit. Columns and rows past the
            // output are staged but not stored.
            const uint32_t stage_c = cbuf + c * (BN / 64) * BOX;
            if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
            bar_sync(1 + c, 128);
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int col = n0 + 8 * j + 2 * (lane % 4);
                const float2 b2 = bias != nullptr && col < out_n
                                      ? __ldg(reinterpret_cast<const float2*>(bias + col))
                                      : make_float2(0.f, 0.f);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = row + 8 * h;
                    const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h] + b2.x,
                                                                   acc[4 * j + 2 * h + 1] + b2.y);
                    const uint32_t addr = stage_c + (j / 8) * BOX + r * 128 +
                                          (((j % 8) ^ (r % 8)) << 4) + 4 * (lane % 4);
                    asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                                 "r"(*reinterpret_cast<const uint32_t*>(&v))
                                 : "memory");
                }
            }
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            bar_sync(1 + c, 128);
            if (leader && m0 + 64 * c < out_m) {
#pragma unroll
                for (int b = 0; b < BN / 64; ++b)
                    if (n0 + 64 * b < out_n) tma_store(tc, stage_c + b * BOX, n0 + 64 * b, m0 + 64 * c);
                asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            }
        }
    }
    if (!WGRAD && leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The two kernels of the mainloop, named for the profile's groups.
__global__ void __launch_bounds__(THREADS, 1)
gemm_bias_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const float* __restrict__ bias, int m,
               int n, int tiles_n, int units, int kb) {
    gemm_sm90<false>(&ta, &tb, &tc, bias, nullptr, m, n, tiles_n, units, units, kb, kb);
}

__global__ void __launch_bounds__(THREADS, 1)
wgrad_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
           float* __restrict__ part, int k, int n, int tiles_n, int tiles, int units,
           int kb_per_unit, int kb_total) {
    gemm_sm90<true>(&ta, &tb, nullptr, nullptr, part, k, n, tiles_n, tiles, units, kb_per_unit,
                    kb_total);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D map of a row-major bf16 (outer, inner) tensor, in 128-byte-swizzled boxes of
// 64 (inner) x box_outer; TMA fills zeros outside the tensor on loads and skips it on
// stores.
bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                uint32_t box_outer) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
                cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            return false;
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[2] = {inner, outer}, strides[1] = {inner * 2};
    const cuuint32_t box[2] = {64, box_outer}, elem[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Blocks for a launch of `units` work units of `kernel`: one per SM, at most one per
// unit. Sets the kernel's dynamic shared memory on first use.
template <auto kernel, int smem>
cudaError_t persistent_grid(int units, int* grid) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0, n = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        sms = n;
    }
    *grid = min(units, sms);
    return cudaSuccess;
}

cudaError_t gemm_bias_bf16(const void* A, const void* W, const float* bias, void* C, int M,
                           int N, int K, cudaStream_t st) {
    if (K % 8 || N % 8) return cudaErrorInvalidValue;
    CUtensorMap ta, tb, tc;
    if (!tensor_map(&ta, A, K, M, BM) || !tensor_map(&tb, W, K, N, BN) ||
        !tensor_map(&tc, C, N, M, 64))
        return cudaErrorInvalidValue;
    const int tiles_n = (N + BN - 1) / BN, units = ((M + BM - 1) / BM) * tiles_n;
    constexpr int smem = Smem<false>::BYTES;
    int grid = 0;
    cudaError_t err = persistent_grid<gemm_bias_sm90, smem>(units, &grid);
    if (err != cudaSuccess) return err;
    gemm_bias_sm90<<<grid, THREADS, smem, st>>>(ta, tb, tc, bias, M, N, tiles_n, units,
                                                (K + BK - 1) / BK);
    return cudaGetLastError();
}

cudaError_t wgrad_bf16(const void* A, const void* B, float* part, int M, int K, int N,
                       int splits, int rows, cudaStream_t st) {
    if (K % 8 || N % 8 || rows % BK) return cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    if (!tensor_map(&ta, A, K, M, 64) || !tensor_map(&tb, B, N, M, 64))
        return cudaErrorInvalidValue;
    const int tiles_n = (N + BN - 1) / BN, tiles = ((K + BM - 1) / BM) * tiles_n;
    constexpr int smem = Smem<true>::BYTES;
    int grid = 0;
    cudaError_t err = persistent_grid<wgrad_sm90, smem>(tiles * splits, &grid);
    if (err != cudaSuccess) return err;
    wgrad_sm90<<<grid, THREADS, smem, st>>>(ta, tb, part, K, N, tiles_n, tiles, tiles * splits,
                                            rows / BK, (M + BK - 1) / BK);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// f32 (CUDA cores) and the row reductions
// ---------------------------------------------------------------------------------------

// f32: CUDA-core FMA, for parity runs on the card. Block tile 64x64x16, 256 threads,
// 4x4 outputs each.
constexpr int GF_T = 64, GF_K = 16;

template <bool WT>
__global__ void __launch_bounds__(256)
gemm_bias_f32(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
    __shared__ float As[GF_K][GF_T + 4];   // transposed: As[k][m]
    __shared__ float Ws[GF_K][GF_T + 4];   // Ws[k][n]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * GF_T, n0 = blockIdx.x * GF_T;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += GF_K) {
        for (int i = tid; i < GF_T * GF_K; i += 256) {
            const int r = i / GF_K, c = i % GF_K;
            As[c][r] = (m0 + r < M && k0 + c < K) ? A[(size_t)(m0 + r) * K + k0 + c] : 0.f;
            if (WT) {
                Ws[c][r] = (k0 + c < K && n0 + r < N) ? W[(size_t)(n0 + r) * K + k0 + c] : 0.f;
            } else {
                const int wr = i / GF_T, wc = i % GF_T;
                Ws[wr][wc] = (k0 + wr < K && n0 + wc < N) ? W[(size_t)(k0 + wr) * N + n0 + wc]
                                                          : 0.f;
            }
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
            if (gr < M && gc < N) C[(size_t)gr * N + gc] = acc[i][j] + (bias ? bias[gc] : 0.f);
        }
    }
}

// f32: CUDA-core FMA, 64x64 output tile, GF_K rows per stage, 4x4 outputs per thread.
__global__ void __launch_bounds__(256)
wgrad_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ part,
          int M, int K, int N, int rows) {
    __shared__ float As[GF_K][GF_T + 4];   // As[row][k]
    __shared__ float Bs[GF_K][GF_T + 4];   // Bs[row][n]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int k0 = blockIdx.y * GF_T, n0 = blockIdx.x * GF_T;
    const int r_begin = blockIdx.z * rows, r_end = min(M, r_begin + rows);
    float acc[4][4] = {};
    for (int r0 = r_begin; r0 < r_end; r0 += GF_K) {
        for (int i = tid; i < GF_K * GF_T; i += 256) {
            const int r = i / GF_T, c = i % GF_T, gr = r0 + r;
            As[r][c] = (gr < r_end && k0 + c < K) ? A[(size_t)gr * K + k0 + c] : 0.f;
            Bs[r][c] = (gr < r_end && n0 + c < N) ? B[(size_t)gr * N + n0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GF_K; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    float* out = part + (size_t)blockIdx.z * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gk = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gn = n0 + tx * 4 + j;
            if (gk < K && gn < N) out[(size_t)gk * N + gn] = acc[i][j];
        }
    }
}

// colsum: one block sums a run of rows (blockIdx.y) over 256 columns (blockIdx.x). Each
// thread owns 8 adjacent columns and reads them with 16-byte loads (one uint4 of bf16 or
// two float4 of f32 per row), so a warp moves 512 contiguous bytes of a row; the block's
// 8 warps take the run's rows in turn (warp w: rows w, w + 8, ...), each thread with
// CS_BYTES bytes of loads in flight before it adds them. The warps' f32 partials are then
// added in warp order through shared memory, one thread per column. The order of every
// sum is fixed by (M, N, rows): in a thread by row, in a block by warp, over the runs by
// sum_splits.
constexpr int CS_WARPS = 8;
constexpr int CS_COLS = CS_WARPS * 32;   // columns of a block: 32 lanes x 8
constexpr int CS_BYTES = 128;           // bytes of loads in flight per thread

template <typename T> struct Cols8;

template <> struct Cols8<bf16> {
    uint4 v;
    __device__ __forceinline__ void load(const bf16* p) {
        v = __ldcs(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ void add_to(float (&acc)[8]) const {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            acc[2 * i] += f.x;
            acc[2 * i + 1] += f.y;
        }
    }
};

template <> struct Cols8<float> {
    float4 a, b;
    __device__ __forceinline__ void load(const float* p) {
        a = __ldcs(reinterpret_cast<const float4*>(p));
        b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    }
    __device__ __forceinline__ void add_to(float (&acc)[8]) const {
        acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
        acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
    }
};

template <typename T>
__global__ void __launch_bounds__(CS_COLS)
colsum_part(const T* __restrict__ A, float* __restrict__ part, int M, int N, int rows) {
    constexpr int UNROLL = CS_BYTES / (8 * sizeof(T));   // rows in flight per thread
    __shared__ float red[CS_WARPS][CS_COLS];
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int n = blockIdx.x * CS_COLS + lane * 8;
    const int r_begin = blockIdx.y * rows, r_end = min(M, r_begin + rows);
    float acc[8] = {};
    if (n < N) {
        int r = r_begin + w;
        for (; r + (UNROLL - 1) * CS_WARPS < r_end; r += UNROLL * CS_WARPS) {
            Cols8<T> v[UNROLL];
#pragma unroll
            for (int i = 0; i < UNROLL; ++i) v[i].load(A + (size_t)(r + i * CS_WARPS) * N + n);
#pragma unroll
            for (int i = 0; i < UNROLL; ++i) v[i].add_to(acc);
        }
        for (; r < r_end; r += CS_WARPS) {
            Cols8<T> v;
            v.load(A + (size_t)r * N + n);
            v.add_to(acc);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[w][lane * 8 + j] = acc[j];
    __syncthreads();
    const int c = threadIdx.x, gn = blockIdx.x * CS_COLS + c;
    if (gn < N) {
        float s = red[0][c];
#pragma unroll
        for (int k = 1; k < CS_WARPS; ++k) s += red[k][c];
        part[(size_t)blockIdx.y * N + gn] = s;
    }
}

__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ part, float* __restrict__ out, int splits, size_t count) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
         e += (size_t)gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int z = 0; z < splits; ++z) acc += part[z * count + e];
        out[e] = acc;
    }
}

cudaError_t launch_sum_splits(const float* part, float* out, int splits, size_t count,
                              cudaStream_t st) {
    size_t blocks = (count + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    sum_splits<<<(unsigned)blocks, 256, 0, st>>>(part, out, splits, count);
    return cudaGetLastError();
}


bool bad_split(int M, int splits, int rows) {
    return M <= 0 || splits <= 0 || rows <= 0 || rows % 32 || (long long)splits * rows < M ||
           (long long)(splits - 1) * rows >= M;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns cudaGetLastError() after
// its launches (0 on success; cudaErrorInvalidValue for what it does not take); the
// caller checks dtypes and alignment.

// C = A . W + bias (w_transposed 0, W (K, N)) or C = A . W^T + bias (w_transposed 1,
// W (N, K)); W in the compute dtype, bias f32 or null. bf16 takes W^T only (the wrapper's
// gemm_weight) and needs K % 8 == 0 and N % 8 == 0 (16-byte rows for TMA).
extern "C" int tcow_gemm_bias(int dtype, const void* A, const void* W, const void* bias,
                              void* C, int M, int N, int K, int w_transposed, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* b = static_cast<const float*>(bias);
    if (dtype == 1)
        return w_transposed ? (int)gemm_bias_bf16(A, W, b, C, M, N, K, st)
                            : (int)cudaErrorInvalidValue;
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    const float* a = static_cast<const float*>(A);
    const float* w = static_cast<const float*>(W);
    dim3 grid((N + GF_T - 1) / GF_T, (M + GF_T - 1) / GF_T);
    if (w_transposed)
        gemm_bias_f32<true><<<grid, 256, 0, st>>>(a, w, b, static_cast<float*>(C), M, N, K);
    else
        gemm_bias_f32<false><<<grid, 256, 0, st>>>(a, w, b, static_cast<float*>(C), M, N, K);
    return (int)cudaGetLastError();
}

// K6's weight gradient: out (K, N) f32 = A^T . B over the M rows of A (M, K) and B (M, N);
// work holds splits * K * N f32 partial sums. The runs of `rows` rows cover M exactly
// (splits = ceil(M / rows)); rows is a multiple of 32, of 64 in bf16. bf16 needs K % 8 == 0
// and N % 8 == 0.
extern "C" int tcow_wgrad(int dtype, const void* A, const void* B, void* out, void* work, int M,
                          int K, int N, int splits, int rows, void* stream) {
    if (bad_split(M, splits, rows) || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(work);
    cudaError_t err;
    if (dtype == 1) {
        err = wgrad_bf16(A, B, part, M, K, N, splits, rows, st);
    } else if (dtype == 0) {
        dim3 grid((N + GF_T - 1) / GF_T, (K + GF_T - 1) / GF_T, splits);
        wgrad_f32<<<grid, 256, 0, st>>>(static_cast<const float*>(A),
                                        static_cast<const float*>(B), part, M, K, N, rows);
        err = cudaGetLastError();
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)launch_sum_splits(part, static_cast<float*>(out), splits, (size_t)K * N, st);
}

// K6's bias gradient: out (N) f32 = the sum of the M rows of A (M, N); work holds
// splits * N f32 partial sums, runs as for tcow_wgrad. Needs N % 8 == 0 and A 16-byte
// aligned (16-byte loads of 8 columns).
extern "C" int tcow_colsum(int dtype, const void* A, void* out, void* work, int M, int N,
                           int splits, int rows, void* stream) {
    if (bad_split(M, splits, rows) || N <= 0 || N % 8 || reinterpret_cast<uintptr_t>(A) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(work);
    dim3 grid((N + CS_COLS - 1) / CS_COLS, splits);
    if (dtype == 1)
        colsum_part<bf16><<<grid, CS_COLS, 0, st>>>(static_cast<const bf16*>(A), part, M, N,
                                                    rows);
    else if (dtype == 0)
        colsum_part<float><<<grid, CS_COLS, 0, st>>>(static_cast<const float*>(A), part, M, N,
                                                     rows);
    else
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_sum_splits(part, static_cast<float*>(out), splits, (size_t)N, st);
}
