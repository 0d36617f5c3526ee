// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py:_fwd_kernel, launched by
// _flash_fwd. It computes the same function: causal or full GQA attention
// with an online softmax, running max / sum / accumulator in fp32, masked
// scores filled with -1e30, o = acc / max(l, 1e-30) in the input type, and
// the per-row logsumexp lse = m + log(max(l, 1e-30)) in fp32. lse is
// [B, H, Sq] here: the TPU kernel broadcast it over 128 lanes only for its
// (8, 128) tiling.
//
// Design. One block of 256 threads per (b, h, 64-row q tile). The TPU kept
// the kv axis as a sequential grid dimension carrying state in VMEM; here it
// is a loop inside the block, and for causal attention the loop stops at the
// diagonal tile, so the skipped tiles cost neither compute nor loads (the TPU
// kernel still paid their DMA). Each 64-row kv tile is staged in shared
// memory as fp32 (K, then V into the same buffer), the q tile once. Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4) and, of the
// scores, columns tx + 16 j (j < 4), of the output columns tx + 16 j
// (j < D / 16). A row's 16 owners are 16 neighbouring lanes of one warp, so
// its max and sum reduce with four xor shuffles, and its running m and l
// live in registers of those lanes. Products run on CUDA cores in fp32 for
// both input types; shared-memory rows are padded (D + 1, 64 + 16) so the
// inner loops read without bank conflicts.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the serving
// path's shapes (B=4, H=32, S=128, D=128, bf16, causal) the function moves
// about 16.8 MB (q, k, v, o once each), about 5 us, against about 0.54 GFLOP
// of causal work, about 0.5 us on the tensor cores: it is memory-bound.
// What this simple design leaves on the table: the products run on CUDA
// cores (67 TFLOP/s fp32) and not on the tensor cores (mma.sync / wgmma);
// loads are synchronous (no cp.async or TMA pipeline, so staging and compute
// do not overlap inside a block); the 86.5 KB of shared memory per block at
// D=128 lets only two blocks share an SM; and at S=128 there are only
// B * H * 2 blocks, about two per SM, with the diagonal tiles doing half
// the work of the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 256;
constexpr int PS = BK + 16;     // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// Copy a 64 x D tile, contiguous along D with rows row_stride apart, into
// shared memory as fp32 with row stride D + 1.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int64_t row_stride) {
    constexpr int CPR = D / 4;  // 4-element chunks per row
    for (int c = threadIdx.x; c < BQ * CPR; c += THREADS) {
        const int r = c / CPR;
        const int col = (c % CPR) * 4;
        float v[4];
        load4(src + r * row_stride + col, v);
        float* d = dst + r * (D + 1) + col;
        d[0] = v[0]; d[1] = v[1]; d[2] = v[2]; d[3] = v[3];
    }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int H, int n_rep, int Sq, int Skv, int causal, float scale,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss) {
    constexpr int NJ = D / 16;  // output columns per thread
    extern __shared__ float smem[];
    float* qs = smem;                    // [BQ][D + 1]
    float* kvs = qs + BQ * (D + 1);      // [BK][D + 1]: K, then V
    float* ps = kvs + BK * (D + 1);      // [BQ][PS]

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / n_rep;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;

    const T* kb = k + b * k_sb + hk * k_sh;
    const T* vb = v + b * v_sb + hk * v_sh;
    stage_tile<T, D>(qs, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss);

    float m[4], l[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }

    int nk = Skv / BK;
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal

    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile's P and V are no longer read
        stage_tile<T, D>(kvs, kb + k0 * k_ss, k_ss);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q_pos = q0 + ty + 16 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] *= scale;
                if (causal && q_pos < k0 + tx + 16 * j) s[i][j] = NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            const float alpha = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                rs += p;
                ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
            }
            l[i] = alpha * l[i] + half_warp_sum(rs);
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
        }

        __syncthreads();  // every thread is done reading K
        stage_tile<T, D>(kvs, vb + k0 * v_ss, v_ss);
        __syncthreads();  // V and P are visible

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float pv[4], vv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
            for (int j = 0; j < NJ; ++j) vv[j] = kvs[kk * (D + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        const float lc = fmaxf(l[i], 1e-30f);
        T* orow = o + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
        for (int j = 0; j < NJ; ++j) store1(orow + tx + 16 * j, acc[i][j] / lc);
        if (tx == 0) lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[i] + logf(lc);
    }
}

struct Strides {  // elements, (batch, head, seq) for each of q, k, v, o
    int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
    int64_t v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int KVH, int Sq, int Skv,
                   int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
    constexpr int smem = (BQ * (D + 1) + BK * (D + 1) + BQ * PS) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Sq / BQ, H, B);
    flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), H, H / KVH, Sq, Skv, causal, scale,
        st.q_sb, st.q_sh, st.q_ss, st.k_sb, st.k_sh, st.k_ss,
        st.v_sb, st.v_sh, st.v_ss, st.o_sb, st.o_sh, st.o_ss);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, head, seq) for q, k, v, o; the last dimension must be contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
int rtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int B, int H,
                            int KVH, int Sq, int Skv, int D, int causal,
                            float scale,
                            int64_t q_sb, int64_t q_sh, int64_t q_ss,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t o_sb, int64_t o_sh, int64_t o_ss,
                            void* stream) {
    const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                     v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 64)
        return launch<float, 64>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 0 && D == 128)
        return launch<float, 128>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
