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
// Both routes share one schedule, for one reason. One block per (b, kv
// head, 64-row kv tile). The TPU walked the group's query heads and the q
// tiles as two sequential grid axes, carrying dk and dv in VMEM; here they
// are loops inside the block (query head outer, q tile inner), so each
// output tile is owned by one block: no atomics, and the same result on
// every run. With causal masking the q loop starts at the first tile with
// a row at or below this kv tile's first row (iq * 64 + 63 >= k0, the TPU
// kernel's own skip condition), so the skipped tiles cost nothing. The
// scores are computed transposed (kv rows by q columns), so that p^T and
// ds^T come out in the layout of the two accumulating products' A operand.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the training
// path's shape (B=1, H=32, S=2048, D=128, bf16, causal) the function does
// four products over the ~2.1 M (q, k) pairs the mask keeps per head,
// about 68.8 GFLOP, about 70 us on the tensor cores, against about 101 MB
// moved (q, k, v, dO, dk, dv, lse, delta once each), about 30 us: it is
// bound by operations.
//
// Two routes, chosen by the input type (a declared route, not a fallback):
//
// bf16: flash_dkv_kernel_tc, on the tensor cores. One warpgroup (128
// threads) per block, which owns the kv tile's 64 rows. What each part does
// about the faults of the CUDA-core design:
// - K and V are staged once, as bf16, in the 128-byte-swizzled layout
//   wgmma reads (sm90.cuh). Each step's q and dO tiles and its rows' lse
//   and delta load asynchronously (cp.async) into a ring of 2 stages:
//   step i + 1's loads are in flight while step i computes, with one block
//   barrier a step (the fp32 route stages synchronously behind three).
// - S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16, A and B both from
//   shared memory, both K-major; fp32 accumulators.
// - P^T = exp(S^T scale - lse) (in base 2: one fmaf and one ex2) and
//   dS^T = P^T (dP^T - delta) scale in registers, on the accumulator
//   fragments, which rounded to bf16 are already the register A fragments
//   of the next products: P^T and dS^T never touch shared memory.
// - dV += P^T dO and dK += dS^T Q by wgmma m64nDk16, A from registers, B =
//   dO or Q from shared memory, MN-major (the transpose-B flag).
// - dk and dv accumulate in fp32 registers: 64 each per thread at D=128.
//   Shared memory is 99 KB a block at D=128 (K, V, and 2 stages of q, dO,
//   lse, delta), so two blocks share an SM under __launch_bounds__(128, 2),
//   which caps a thread at 255 registers. ptxas (CUDA 12.8) takes all 255
//   at D=128 (186 at D=64), with no spills, and adds warpgroup waits where
//   the four accumulators crowd the register file.
// Rounding P^T and dS^T to bf16 before the products is the route's one
// numerical change (the JAX package's reference attention rounds P the
// same way), so it does not match its fp32 twin bit for bit.
// What it still leaves: warp specialisation (a TMA producer warp with
// mbarriers), ping-pong of one warpgroup's elementwise work against
// another's products, persistent blocks, and the GQA grid: it is only
// B * KVH * Skv / 64 blocks (128 at KVH=8, S=1024, below the 264 that two
// per SM on 132 SMs hold).
//
// fp32: flash_dkv_kernel, on CUDA cores in fp32 (fp32 means fp32 here: the
// 1e-4 tolerances would not survive TF32). 256 threads a block; K and V are
// staged once as fp32, each step stages the q and dO tiles and the rows'
// lse and delta synchronously. Thread (ty, tx) computes kv rows ty + 16 i by
// q columns tx + 16 j of the transposed scores, writes p^T and ds^T to shared
// memory in the layout the two accumulating products read, and accumulates
// dk and dv (rows ty + 16 i, columns tx + 16 j) in fp32 registers. Its 170 KB
// of shared memory at D=128 allows one block per SM anyway, so
// __launch_bounds__(256, 1) lets ptxas use up to 255 registers and keeps both
// accumulators out of local memory.

#include "flash_common.cuh"
#include "sm90.cuh"

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

// ------------------------------------------------ bf16: the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;      // kv rows per block
constexpr int BQ = 64;      // q rows per step
constexpr int NT = 128;     // one warpgroup
constexpr int STAGES = 2;   // ring of q / dO / lse / delta

template <int D>
__host__ __device__ constexpr int tile_bytes() { return BQ * D * 2; }

// q, dO, then lse and delta, padded to 1 KB
template <int D>
__host__ __device__ constexpr int stage_bytes() {
    return 2 * tile_bytes<D>() + 1024;
}

// + 1024 to align the tiles by hand
template <int D>
__host__ __device__ constexpr int smem_bytes() {
    return 1024 + 2 * BK * D * 2 + STAGES * stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_dkv_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int n_rep, int Sq,
    int causal, float scale, float scale_log2, const Strides st) {
    constexpr int T_BYTES = tile_bytes<D>();
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw
                    + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
    const uint32_t ks = sm90::smem_addr(smem);
    const uint32_t vs = ks + BK * D * 2;
    const int ring = 2 * BK * D * 2;  // byte offset of stage 0

    const int k0 = blockIdx.x * BK;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int r_lo = (tid / 32) * 16 + (tid % 32) / 4;  // kv rows, and + 8
    const int c_lo = 2 * (tid % 4);  // first of this thread's q columns

    const int nq = Sq / BQ;
    // the first q tile with a row at or below k0: iq * BQ + BQ - 1 >= k0
    const int iq0 = causal ? k0 / BQ : 0;
    const int per_head = nq - iq0;
    const int steps = per_head > 0 ? n_rep * per_head : 0;

    // start the loads of step i (query head i / per_head, q tile iq0 +
    // i % per_head) into stage i % STAGES
    auto load_step = [&](int i) {
        const int h = hk * n_rep + i / per_head;
        const int q0 = (iq0 + i % per_head) * BQ;
        const uint32_t sb = ks + ring + (i % STAGES) * stage_bytes<D>();
        sm90::load_tile<BQ, D, NT>(
            sb, q + b * st.q_sb + h * st.q_sh + q0 * st.q_ss, st.q_ss, tid);
        sm90::load_tile<BQ, D, NT>(
            sb + T_BYTES, dout + b * st.do_sb + h * st.do_sh + q0 * st.do_ss,
            st.do_ss, tid);
        const int64_t rows = (static_cast<int64_t>(b) * H + h) * Sq + q0;
        sm90::load_row<BQ>(sb + 2 * T_BYTES, lse + rows, tid);
        sm90::load_row<BQ>(sb + 2 * T_BYTES + BQ * 4, delta + rows, tid);
    };

    sm90::load_tile<BK, D, NT>(
        ks, k + b * st.k_sb + hk * st.k_sh + k0 * st.k_ss, st.k_ss, tid);
    sm90::load_tile<BK, D, NT>(
        vs, v + b * st.v_sb + hk * st.v_sh + k0 * st.v_ss, st.v_ss, tid);
    if (steps > 0) load_step(0);
    sm90::cp_async_commit();

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int i = 0; i < steps; ++i) {
        const int so = ring + (i % STAGES) * stage_bytes<D>();
        const uint32_t qs = ks + so;
        const uint32_t dos = qs + T_BYTES;
        const float* lse_s =
            reinterpret_cast<const float*>(smem + so + 2 * T_BYTES);
        const float* dl_s = lse_s + BQ;
        sm90::cp_async_wait<0>();
        sm90::fence_proxy_async();
        __syncthreads();  // step i is in; step i - 1's stage is free
        if (i + 1 < steps) {
            load_step(i + 1);
            sm90::cp_async_commit();
        }

        float s[32], dp[32];  // S^T and dP^T: [kv row][q column]
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            sm90::wgmma_m64n64k16_ss(s, sm90::desc_k(ks, BK, 0, kk),
                                     sm90::desc_k(qs, BQ, 0, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            sm90::wgmma_m64n64k16_ss(dp, sm90::desc_k(vs, BK, 0, kk),
                                     sm90::desc_k(dos, BQ, 0, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);

        const int q0 = (iq0 + i % per_head) * BQ;
        const bool diag = causal && q0 < k0 + BK - 1;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int qc = 8 * (j / 4) + c_lo + j % 2;
            const float x = diag && q0 + qc < k0 + r_lo + 8 * ((j % 4) / 2)
                                ? NEG_INF : s[j];
            const float p =
                sm90::ex2(fmaf(x, scale_log2, -lse_s[qc] * sm90::LOG2E));
            s[j] = p;
            dp[j] = p * (dp[j] - dl_s[qc]) * scale;
        }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T, dS^T in bf16
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            sm90::frag_a(pa[kk], s, kk);
            sm90::frag_a(da[kk], dp, kk);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            sm90::wgmma_rs_tb(dv_acc, pa[kk], sm90::desc_mn(dos, BQ, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            sm90::wgmma_rs_tb(dk_acc, da[kk], sm90::desc_mn(qs, BQ, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
    }

    sm90::store_acc(dk + b * st.dk_sb + hk * st.dk_sh + k0 * st.dk_ss,
                    st.dk_ss, dk_acc, 1.f, 1.f, tid);
    sm90::store_acc(dv + b * st.dv_sb + hk * st.dv_sh + k0 * st.dv_ss,
                    st.dv_ss, dv_acc, 1.f, 1.f, tid);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KVH, int Sq,
                   int Skv, int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
    constexpr int smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Skv / BK, KVH, B);
    flash_dkv_kernel_tc<D><<<grid, NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, H / KVH, Sq,
        causal, scale, scale * sm90::LOG2E, st);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_dkv_kernel), 1 = bfloat16 (flash_dkv_kernel_tc).
// Strides are in elements, in the order (batch, head, seq) for q, k, v, dO,
// dk, dv; the last dimension must be contiguous. lse and delta are
// contiguous fp32 [B, H, Sq]. bf16 needs strides divisible by 8 and
// 16-byte-aligned pointers, lse and delta included. Returns
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
        return tc::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return tc::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Skv, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
