// Flash-attention backward, dq, for Hopper (sm_90a), CUDA C++ with a plain C
// entry.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py:_dq_kernel, launched by
// _flash_bwd. It computes the same function: for each q row,
//   s = q k^T * scale (fp32, causal entries above the diagonal -1e30),
//   p = exp(s - lse), dp = dO v^T, ds = p * (dp - delta) * scale,
//   dq = sum over kv of ds k,
// with delta = rowsum(dO * o) computed by the caller, as the JAX package
// computes it outside the kernel. lse and delta are fp32 [B, H, Sq]; dq comes
// out in q's type. GQA reads kv head h / n_rep.
//
// Design. One block of 256 threads per (b, h, 64-row q tile); the TPU's
// sequential kv grid axis is a loop inside the block that stops at the
// causal diagonal, as in the forward kernel. The q and dO tiles are staged
// in shared memory once, as fp32; each kv tile is staged into one buffer,
// V first (for dp = dO V^T, kept in registers), then K over it (for s and
// then for dq += ds K), so K and V never take two buffers. dq accumulates in
// fp32 registers, rows ty + 16 i and columns tx + 16 j of thread (ty, tx);
// lse and delta are read once per row into registers. 117 KB of shared
// memory at D=128 leaves one block per SM, so __launch_bounds__(256, 1)
// lets ptxas use up to 255 registers and nothing spills.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the training
// path's shape (B=1, H=32, S=2048, D=128, bf16, causal) the function does
// three products over the ~2.1 M (q, k) pairs the mask keeps per head,
// about 51.6 GFLOP, about 52 us on the tensor cores, against about 84 MB
// moved (q, k, v, dO, dq, lse, delta once each), about 25 us: it is bound
// by operations. This simple design runs the products on CUDA cores in
// fp32 (67 TFLOP/s peak) and stages synchronously; tensor cores
// (mma.sync, then wgmma) and a cp.async / TMA pipeline are the next steps.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = TILE;        // q rows per block
constexpr int BK = TILE;        // kv rows per tile

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int n_rep, int Sq, int Skv, int causal,
    float scale,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss,
    int64_t dq_sb, int64_t dq_sh, int64_t dq_ss) {
    constexpr int NJ = D / 16;  // dq columns per thread
    extern __shared__ float smem[];
    float* qs = smem;                    // [BQ][D + 1]
    float* dos = qs + BQ * (D + 1);      // [BQ][D + 1]
    float* kvs = dos + BQ * (D + 1);     // [BK][D + 1]: V, then K
    float* dss = kvs + BK * (D + 1);     // [BQ][PS]

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / n_rep;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;

    const T* kb = k + b * k_sb + hk * k_sh;
    const T* vb = v + b * v_sb + hk * v_sh;
    stage_tile<T, D>(qs, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss);
    stage_tile<T, D>(dos, dout + b * do_sb + h * do_sh + q0 * do_ss, do_ss);

    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq + q0;
    float lse_r[4], dl_r[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        lse_r[i] = lse[row0 + ty + 16 * i];
        dl_r[i] = delta[row0 + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }

    int nk = Skv / BK;
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal

    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile's K and dS are no longer read
        stage_tile<T, D>(kvs, vb + k0 * v_ss, v_ss);
        __syncthreads();
        float dp[4][4];
        tile_dot<D>(dp, dos, kvs, ty, tx);
        __syncthreads();  // every thread is done reading V
        stage_tile<T, D>(kvs, kb + k0 * k_ss, k_ss);
        __syncthreads();
        float s[4][4];
        tile_dot<D>(s, qs, kvs, ty, tx);

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q_pos = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float sv = s[i][j] * scale;
                if (causal && q_pos < k0 + tx + 16 * j) sv = NEG_INF;
                const float p = expf(sv - lse_r[i]);
                dss[(ty + 16 * i) * PS + tx + 16 * j] =
                    p * (dp[i][j] - dl_r[i]) * scale;
            }
        }
        __syncthreads();  // dS is visible
        tile_accumulate<D>(acc, dss, kvs, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        T* row = dq + b * dq_sb + h * dq_sh + (q0 + ty + 16 * i) * dq_ss;
#pragma unroll
        for (int j = 0; j < NJ; ++j) store1(row + tx + 16 * j, acc[i][j]);
    }
}

struct Strides {  // elements, (batch, head, seq) for each of q, k, v, dO, dq
    int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
    int64_t do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int KVH, int Sq, int Skv,
                   int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
    constexpr int smem = (2 * BQ * (D + 1) + BK * (D + 1) + BQ * PS)
        * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Sq / BQ, H, B);
    flash_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), H, H / KVH, Sq, Skv, causal, scale,
        st.q_sb, st.q_sh, st.q_ss, st.k_sb, st.k_sh, st.k_ss,
        st.v_sb, st.v_sh, st.v_ss, st.do_sb, st.do_sh, st.do_ss,
        st.dq_sb, st.dq_sh, st.dq_ss);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, head, seq) for q, k, v, dO, dq; the last dimension must be
// contiguous. lse and delta are contiguous fp32 [B, H, Sq]. Returns
// cudaGetLastError() after the launch (0 on success).
int rtt_flash_attention_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int dtype, int B,
                           int H, int KVH, int Sq, int Skv, int D,
                           int causal, float scale,
                           int64_t q_sb, int64_t q_sh, int64_t q_ss,
                           int64_t k_sb, int64_t k_sh, int64_t k_ss,
                           int64_t v_sb, int64_t v_sh, int64_t v_ss,
                           int64_t do_sb, int64_t do_sh, int64_t do_ss,
                           int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                           void* stream) {
    const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                     do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 64)
        return launch<float, 64>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 0 && D == 128)
        return launch<float, 128>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Skv, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
