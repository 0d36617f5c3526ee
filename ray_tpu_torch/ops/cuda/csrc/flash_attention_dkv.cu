// Flash-attention backward, dk and dv, for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py:_dkv_kernel, launched by
// _flash_bwd. It computes the same function: for each kv row,
//   dv = sum over q of p^T dO,   dk = sum over q of ds^T q,
// with s = q k^T * scale (fp32, causal entries above the diagonal -1e30),
// p = exp(s - lse), dp = dO v^T and ds = p * (dp - delta) * scale, where
// delta = rowsum(dO * o) comes from the caller. Both sums run over every q
// tile and over the n_rep query heads of the kv head's group: that is the
// GQA backward. dk and dv come out in k's and v's types.
//
// Design. One block of 256 threads per (b, kv head, 64-row kv tile). The
// TPU walked the group's query heads and the q tiles as two sequential grid
// axes, carrying dk and dv in VMEM; here they are two loops inside the block
// (query head outer, q tile inner), so each output tile is owned by one block:
// no atomics, and the same result on every run. With causal masking the q
// loop starts at the first tile with a row at or below this kv tile's first
// row (iq * 64 + 63 >= k0, the TPU kernel's own skip condition), so the
// skipped tiles cost nothing. K and V are staged once as fp32; each step
// stages the q and dO tiles and the rows' lse and delta. The scores are
// computed transposed, kv rows ty + 16 i by q columns tx + 16 j of thread
// (ty, tx), so that p^T and ds^T land in shared memory in the layout the two
// accumulating products read, and dk and dv (rows ty + 16 i, columns
// tx + 16 j) accumulate in fp32 registers: 64 a thread at D=128. The 170 KB
// of shared memory at D=128 allows one block per SM anyway, so
// __launch_bounds__(256, 1) lets ptxas use up to 255 registers and keeps
// both accumulators out of local memory.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the training
// path's shape (B=1, H=32, S=2048, D=128, bf16, causal) the function does
// four products over the ~2.1 M (q, k) pairs the mask keeps per head,
// about 68.8 GFLOP, about 70 us on the tensor cores, against about 101 MB
// moved (q, k, v, dO, dk, dv, lse, delta once each), about 30 us: it is
// bound by operations. This simple design runs the products on CUDA cores
// in fp32 (67 TFLOP/s peak) and stages synchronously; tensor cores
// (mma.sync, then wgmma) and a cp.async / TMA pipeline are the next steps.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = TILE;        // q rows per step
constexpr int BK = TILE;        // kv rows per block

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int n_rep, int Sq,
    int causal, float scale,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss,
    int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
    int64_t dv_sb, int64_t dv_sh, int64_t dv_ss) {
    constexpr int NJ = D / 16;  // dk / dv columns per thread
    extern __shared__ float smem[];
    float* ks = smem;                    // [BK][D + 1]
    float* vs = ks + BK * (D + 1);       // [BK][D + 1]
    float* qs = vs + BK * (D + 1);       // [BQ][D + 1]
    float* dos = qs + BQ * (D + 1);      // [BQ][D + 1]
    float* pts = dos + BQ * (D + 1);     // [BK][PS]: p^T
    float* dsts = pts + BK * PS;         // [BK][PS]: ds^T
    float* lse_s = dsts + BK * PS;       // [BQ]
    float* dl_s = lse_s + BQ;            // [BQ]

    const int k0 = blockIdx.x * BK;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;

    stage_tile<T, D>(ks, k + b * k_sb + hk * k_sh + k0 * k_ss, k_ss);
    stage_tile<T, D>(vs, v + b * v_sb + hk * v_sh + k0 * v_ss, v_ss);

    float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

    const int nq = Sq / BQ;
    // the first q tile with a row at or below k0: iq * BQ + BQ - 1 >= k0
    const int iq0 = causal ? k0 / BQ : 0;

    for (int r = 0; r < n_rep; ++r) {
        const int h = hk * n_rep + r;
        const T* qb = q + b * q_sb + h * q_sh;
        const T* dob = dout + b * do_sb + h * do_sh;
        const int64_t rows = (static_cast<int64_t>(b) * H + h) * Sq;
        for (int iq = iq0; iq < nq; ++iq) {
            const int q0 = iq * BQ;
            __syncthreads();  // the previous step's q, dO, p^T, ds^T are read
            stage_tile<T, D>(qs, qb + q0 * q_ss, q_ss);
            stage_tile<T, D>(dos, dob + q0 * do_ss, do_ss);
            if (threadIdx.x < BQ) {
                lse_s[threadIdx.x] = lse[rows + q0 + threadIdx.x];
                dl_s[threadIdx.x] = delta[rows + q0 + threadIdx.x];
            }
            __syncthreads();

            float st[4][4], dpt[4][4];  // [kv row][q column]
            tile_dot<D>(st, ks, qs, ty, tx);
            tile_dot<D>(dpt, vs, dos, ty, tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int k_pos = k0 + ty + 16 * i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int qc = tx + 16 * j;
                    float sv = st[i][j] * scale;
                    if (causal && q0 + qc < k_pos) sv = NEG_INF;
                    const float p = expf(sv - lse_s[qc]);
                    pts[(ty + 16 * i) * PS + qc] = p;
                    dsts[(ty + 16 * i) * PS + qc] =
                        p * (dpt[i][j] - dl_s[qc]) * scale;
                }
            }
            __syncthreads();  // p^T and ds^T are visible
            tile_accumulate<D>(dv_acc, pts, dos, ty, tx);
            tile_accumulate<D>(dk_acc, dsts, qs, ty, tx);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = k0 + ty + 16 * i;
        T* dkr = dk + b * dk_sb + hk * dk_sh + row * dk_ss;
        T* dvr = dv + b * dv_sb + hk * dv_sh + row * dv_ss;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            store1(dkr + tx + 16 * j, dk_acc[i][j]);
            store1(dvr + tx + 16 * j, dv_acc[i][j]);
        }
    }
}

struct Strides {  // elements, (batch, head, seq): q, k, v, dO, dk, dv
    int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
    int64_t do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KVH, int Sq,
                   int Skv, int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
    constexpr int smem = (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * PS
                          + 2 * BQ) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Skv / BK, KVH, B);
    flash_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, H / KVH, Sq, causal,
        scale, st.q_sb, st.q_sh, st.q_ss, st.k_sb, st.k_sh, st.k_ss,
        st.v_sb, st.v_sh, st.v_ss, st.do_sb, st.do_sh, st.do_ss,
        st.dk_sb, st.dk_sh, st.dk_ss, st.dv_sb, st.dv_sh, st.dv_ss);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, head, seq) for q, k, v, dO, dk, dv; the last dimension must be
// contiguous. lse and delta are contiguous fp32 [B, H, Sq]. Returns
// cudaGetLastError() after the launch (0 on success).
int rtt_flash_attention_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            int dtype, int B, int H, int KVH, int Sq,
                            int Skv, int D, int causal, float scale,
                            int64_t q_sb, int64_t q_sh, int64_t q_ss,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t do_sb, int64_t do_sh, int64_t do_ss,
                            int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                            int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                            void* stream) {
    const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                     do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss,
                     dv_sb, dv_sh, dv_ss};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 64)
        return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 0 && D == 128)
        return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Skv, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
