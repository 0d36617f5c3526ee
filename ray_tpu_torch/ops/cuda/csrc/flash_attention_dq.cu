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
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the training
// path's shape (B=1, H=32, S=2048, D=128, bf16, causal) the function does
// three products over the ~2.1 M (q, k) pairs the mask keeps per head,
// about 51.6 GFLOP, about 52 us on the tensor cores, against about 84 MB
// moved (q, k, v, dO, dq, lse, delta once each), about 25 us: it is bound
// by operations.
//
// Two routes, chosen by the input type (a declared route, not a fallback):
//
// bf16: flash_dq_kernel_tc, on the tensor cores. It is the forward's
// flash_fwd_kernel_tc with V in P V replaced by K in dS K and one product
// added. One block of two warpgroups (256 threads) per (b, h, 128-row q
// tile); each warpgroup owns 64 q rows. What each part does about the
// faults of the CUDA-core design (fp32 products on CUDA cores, five
// barriers and no load in flight per kv tile, dS through shared memory,
// fp32 staging that left room for one block of 8 warps an SM):
// - The products run on the tensor cores: S = Q K^T and dP = dO V^T by
//   wgmma m64n64k16, A and B both from shared memory, both K-major, issued
//   in one commit group; dq += dS K by wgmma m64nDk16 with A = dS from
//   registers and B = the same K tile read MN-major (the transpose-B flag).
// - dS never touches shared memory: P = exp(S scale - lse) (in base 2: one
//   fmaf and one ex2) and dS = P (dP - delta) are computed in registers on
//   the accumulator fragments, with each thread's two rows' lse and delta
//   loaded once; rounded to bf16, dS is already the register A fragment of
//   dS K (sm90.cuh frag_a). That rounding is the route's one numerical
//   change. dS is left unscaled before it; scale multiplies the fp32 sum
//   once, as dq goes out.
// - Shared memory holds bf16 in the 128-byte-swizzled layout wgmma reads:
//   the Q and dO tiles once (32 KB each at D=128), and K and V tiles of 64
//   kv rows in a ring of 2 stages (2 x 32 KB), 129 KB a block.
// - Loads are asynchronous (cp.async): the next kv tile's K and V are in
//   flight while the current one computes; one barrier per kv tile.
// - The kv loop stops at the causal diagonal, per warpgroup, and only the
//   diagonal tile is masked. Under causal masking the q tiles run in
//   reverse order, and the grid is (H, q tiles, B): blocks start in the
//   order of their linear index, so they start longest first across all
//   heads (the training shape's 32 longest blocks, one per head, then the
//   next 32). The forward's grid, (q tiles, H, B), is longest first only
//   within a head: the last heads' longest blocks start near the end and
//   finish while most SMs idle. A greedy schedule of the training shape's
//   512 blocks on 132 SMs ends after 86 kv tiles on the busiest SM in the
//   forward's order and after 68 in this one.
// - dq accumulates in fp32 registers (D / 2 a thread) and goes out in bf16
//   straight from them to the strided output.
// It takes bf16 strides divisible by 8 elements and 16-byte-aligned
// pointers (the wrapper checks). ptxas (CUDA 12.8) gives it 188 registers
// at D=128 and 138 at D=64, no spills: with 256 threads and 129 KB of
// shared memory, one block per SM (__launch_bounds__(256, 1)).
// What it still leaves: the two warpgroups meet at every tile's barrier,
// so their elementwise work runs while the tensor cores idle. The levers
// are warp specialisation (a producer warp with TMA and mbarriers),
// ping-pong of one warpgroup's elementwise work against the other's
// products, persistent blocks, and a staged, coalesced epilogue.
//
// fp32: flash_dq_kernel, on CUDA cores in fp32 (fp32 means fp32 here: the
// 1e-4 tolerances would not survive TF32). One block of 256 threads per
// (b, h, 64-row q tile); the TPU's sequential kv grid axis is a loop
// inside the block that stops at the causal diagonal. The q and dO tiles
// are staged in shared memory once, as fp32; each kv tile is staged into
// one buffer, V first (for dp = dO V^T, kept in registers), then K over it
// (for s and then for dq += ds K). dq accumulates in fp32 registers, rows ty + 16 i and columns
// tx + 16 j of thread (ty, tx); lse and delta are read once per row. 117 KB
// of shared memory at D=128 leaves one block per SM, so
// __launch_bounds__(256, 1) lets ptxas use up to 255 registers and nothing
// spills. Staging is synchronous.

#include "flash_common.cuh"
#include "sm90.cuh"

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

// ------------------------------------------------ bf16: the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;     // q rows per block, 64 per warpgroup
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // two warpgroups
constexpr int STAGES = 2;   // ring of K / V tiles

// Q and dO, then the ring; + 1024 to align the tiles by hand
template <int D>
__host__ __device__ constexpr int smem_bytes() {
    return 1024 + 2 * BQ * D * 2 + STAGES * 2 * BK * D * 2;
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_dq_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int n_rep, int Sq, int Skv, int causal,
    float scale, float scale_log2, const Strides st) {
    constexpr uint32_t Q_BYTES = BQ * D * 2;
    constexpr uint32_t KV_BYTES = BK * D * 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t qs = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t dos = qs + Q_BYTES;
    // stage s of the ring: K at kv0 + 2 s KV_BYTES, V right after it
    const uint32_t kv0 = dos + Q_BYTES;

    const int nq = Sq / BQ;
    const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * BQ;
    const int h = blockIdx.x;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int wg = tid / 128;           // warpgroup
    const int wt = tid % 128;           // thread in the warpgroup
    const int row0 = q0 + wg * 64;      // the warpgroup's first q row
    const int r_lo = row0 + (wt / 32) * 16 + (wt % 32) / 4;  // and r_lo + 8
    const int c_lo = 2 * (wt % 4);      // first of this thread's columns

    const bf16* kb = k + b * st.k_sb + (h / n_rep) * st.k_sh;
    const bf16* vb = v + b * st.v_sb + (h / n_rep) * st.v_sh;
    int nk = Skv / BK;     // kv tiles the block loads
    int nk_wg = nk;        // ... and this warpgroup computes
    if (causal) {          // stop at the diagonal
        nk = min(nk, (q0 + BQ - 1) / BK + 1);
        nk_wg = min(nk_wg, (row0 + 63) / BK + 1);
    }

    sm90::load_tile<BQ, D, NT>(qs, q + b * st.q_sb + h * st.q_sh + q0 * st.q_ss,
                               st.q_ss, tid);
    sm90::load_tile<BQ, D, NT>(
        dos, dout + b * st.do_sb + h * st.do_sh + q0 * st.do_ss, st.do_ss,
        tid);
    sm90::load_tile<BK, D, NT>(kv0, kb, st.k_ss, tid);
    sm90::load_tile<BK, D, NT>(kv0 + KV_BYTES, vb, st.v_ss, tid);
    sm90::cp_async_commit();

    // rows r_lo and r_lo + 8: lse in base 2, delta
    const float* lse_r = lse + (static_cast<int64_t>(b) * H + h) * Sq + r_lo;
    const float* dl_r = delta + (static_cast<int64_t>(b) * H + h) * Sq + r_lo;
    const float lse2[2] = {lse_r[0] * sm90::LOG2E, lse_r[8] * sm90::LOG2E};
    const float dl[2] = {dl_r[0], dl_r[8]};

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < nk; ++j) {
        const uint32_t ks = kv0 + (j % STAGES) * 2 * KV_BYTES;
        const uint32_t vs = ks + KV_BYTES;
        sm90::cp_async_wait<0>();
        sm90::fence_proxy_async();
        __syncthreads();  // tile j is in; tile j - 1's stage is free
        if (j + 1 < nk) {
            const int64_t k1 = static_cast<int64_t>(j + 1) * BK;
            const uint32_t kn = kv0 + ((j + 1) % STAGES) * 2 * KV_BYTES;
            sm90::load_tile<BK, D, NT>(kn, kb + k1 * st.k_ss, st.k_ss, tid);
            sm90::load_tile<BK, D, NT>(kn + KV_BYTES, vb + k1 * st.v_ss,
                                       st.v_ss, tid);
            sm90::cp_async_commit();
        }
        if (j >= nk_wg) continue;  // past this warpgroup's diagonal

        float s[32], dp[32];  // S and dP: [q row][kv column]
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            sm90::wgmma_m64n64k16_ss(s, sm90::desc_k(qs, BQ, wg * 64, kk),
                                     sm90::desc_k(ks, BK, 0, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            sm90::wgmma_m64n64k16_ss(dp, sm90::desc_k(dos, BQ, wg * 64, kk),
                                     sm90::desc_k(vs, BK, 0, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);

        const int k0 = j * BK;
        const bool diag = causal && k0 + BK - 1 > row0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int hi = (i % 4) / 2;
            const float x =
                diag && r_lo + 8 * hi < k0 + 8 * (i / 4) + c_lo + i % 2
                    ? NEG_INF : s[i];
            const float p = sm90::ex2(fmaf(x, scale_log2, -lse2[hi]));
            dp[i] = p * (dp[i] - dl[hi]);  // dS, unscaled
        }

        uint32_t da[BK / 16][4];  // dS in bf16, the A fragments of dS K
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) sm90::frag_a(da[kk], dp, kk);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            sm90::wgmma_rs_tb(acc, da[kk], sm90::desc_mn(ks, BK, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
    }

    sm90::store_acc(dq + b * st.dq_sb + h * st.dq_sh + row0 * st.dq_ss,
                    st.dq_ss, acc, scale, scale, wt);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int KVH, int Sq, int Skv,
                   int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
    constexpr int smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(H, Sq / BQ, B);  // heads vary fastest: see the note
    flash_dq_kernel_tc<D><<<grid, NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), H, H / KVH, Sq, Skv, causal, scale,
        scale * sm90::LOG2E, st);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_dq_kernel), 1 = bfloat16 (flash_dq_kernel_tc).
// Strides are in elements, in the order (batch, head, seq) for q, k, v, dO,
// dq; the last dimension must be contiguous. lse and delta are contiguous
// fp32 [B, H, Sq]. bf16 needs strides divisible by 8 and 16-byte-aligned
// pointers. Returns cudaGetLastError() after the launch (0 on success).
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
        return tc::launch<64>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return tc::launch<128>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Skv, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
