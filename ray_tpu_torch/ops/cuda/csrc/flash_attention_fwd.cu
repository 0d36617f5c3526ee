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
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the training
// path's shape (B=1, H=32, S=2048, D=128, bf16, causal) the function does two
// products over the ~2.1 M (q, k) pairs the mask keeps per head, 34.4 GFLOP,
// 34.8 us on the tensor cores, against 67 MB moved, 20 us: it is bound by
// operations. At the serving path's (B=4, S=128) it moves 16.8 MB (q, k, v,
// o once each), 5.0 us, against 0.54 GFLOP, 0.5 us: it is bound by bytes.
//
// Two routes, chosen by the input type (a declared route, not a fallback):
//
// bf16: flash_fwd_kernel_tc, on the tensor cores. One block of two
// warpgroups (256 threads) per (b, h, 128-row q tile); each warpgroup owns
// 64 q rows. What each part does about the faults of the CUDA-core design:
// - The products run on the tensor cores: S = Q K^T by wgmma m64n64k16 with
//   Q and K both from shared memory, both K-major (D is contiguous in each);
//   O += P V by wgmma m64nDk16 with A = P from registers and B = V from
//   shared memory, MN-major (the transpose-B flag), fp32 accumulators.
// - P never touches shared memory: the S accumulator, rounded to bf16, is
//   already the register A fragment of P V (sm90.cuh frag_a). That rounding
//   is the route's one numerical change; the running max and l are fp32
//   and l sums the unrounded p.
// - Shared memory holds bf16 in the 128-byte-swizzled layout wgmma reads:
//   the Q tile once (32 KB at D=128), and K and V tiles of 64 kv rows in a
//   ring of 2 stages (2 x 32 KB), 97 KB a block.
// - Loads are asynchronous (cp.async): the next kv tile's K and V are in
//   flight while the current one computes; one barrier per kv tile.
// - The online softmax runs in registers on the accumulator fragments, in
//   base 2: the row max is taken on the raw scores (scale > 0), and each p
//   is one fmaf (score * scale * log2 e - m) and one ex2. A row's max and
//   sum reduce over the 4 lanes that share it. lse goes out in natural log.
// - The kv loop stops at the causal diagonal, per warpgroup, and only the
//   diagonal tile is masked. Under causal masking the q tiles run in
//   reverse order (nq - 1 - blockIdx.x), so the longest blocks start first.
// - o goes out in bf16 straight from the registers to the strided output.
// It takes bf16 strides divisible by 8 elements and 16-byte-aligned
// pointers (the wrapper checks). ptxas (CUDA 12.8) gives it 168 registers at
// D=128 and 124 at D=64, no spills: with 256 threads and 97 KB of shared
// memory, one block per SM (__launch_bounds__(256, 1)).
// What it still leaves: warp specialisation (a producer warp with TMA and
// mbarriers instead of loads started by the consumers), ping-pong of one
// warpgroup's softmax against the other's products, the next tile's Q K^T
// started before this tile's softmax, persistent blocks, and a staged,
// coalesced epilogue.
//
// fp32: flash_fwd_kernel, on CUDA cores in fp32 (fp32 means fp32 here: the
// 1e-4 tolerances would not survive TF32). One block of 256 threads per
// (b, h, 64-row q tile); each 64-row kv tile is staged in shared memory as
// fp32 (K, then V into the same buffer), the q tile once. Thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i (i < 4) and, of the scores,
// columns tx + 16 j (j < 4), of the output columns tx + 16 j (j < D / 16). A
// row's 16 owners are 16 neighbouring lanes of one warp, so its max and sum
// reduce with four xor shuffles. Shared-memory rows are padded (D + 1,
// 64 + 16) so the inner loops read without bank conflicts; staging is
// synchronous.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace flash;

constexpr int BQ = TILE;        // q rows per block
constexpr int BK = TILE;        // kv rows per tile

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
        tile_dot<D>(s, qs, kvs, ty, tx);

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

        tile_accumulate<D>(acc, ps, kvs, ty, tx);
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

// ------------------------------------------------ bf16: the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;     // q rows per block, 64 per warpgroup
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // two warpgroups
constexpr int STAGES = 2;   // ring of K / V tiles

// + 1024 to align the tiles by hand
template <int D>
__host__ __device__ constexpr int smem_bytes() {
    return 1024 + BQ * D * 2 + STAGES * 2 * BK * D * 2;
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int H, int n_rep, int Sq, int Skv, int causal,
    float scale_log2, const Strides st) {
    constexpr uint32_t Q_BYTES = BQ * D * 2;
    constexpr uint32_t KV_BYTES = BK * D * 2;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t qs = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
    // stage s of the ring: K at kv0 + 2 s KV_BYTES, V right after it
    const uint32_t kv0 = qs + Q_BYTES;

    const int nq = Sq / BQ;
    const int q0 = (causal ? nq - 1 - blockIdx.x : blockIdx.x) * BQ;
    const int h = blockIdx.y;
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
    sm90::load_tile<BK, D, NT>(kv0, kb, st.k_ss, tid);
    sm90::load_tile<BK, D, NT>(kv0 + KV_BYTES, vb, st.v_ss, tid);
    sm90::cp_async_commit();

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // rows r_lo, r_lo + 8 (base 2)
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums

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

        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            sm90::wgmma_m64n64k16_ss(s, sm90::desc_k(qs, BQ, wg * 64, kk),
                                     sm90::desc_k(ks, BK, 0, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);

        const int k0 = j * BK;
        const bool diag = causal && k0 + BK - 1 > row0;
        float mx[2] = {NEG_INF, NEG_INF};  // raw scores: scale > 0
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int hi = (i % 4) / 2;
            if (diag && r_lo + 8 * hi < k0 + 8 * (i / 4) + c_lo + i % 2)
                s[i] = NEG_INF;
            mx[hi] = fmaxf(mx[hi], s[i]);
        }
        float alpha[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
            const float m_new = fmaxf(m[e], mx[e] * scale_log2);
            alpha[e] = sm90::ex2(m[e] - m_new);
            m[e] = m_new;
            l[e] *= alpha[e];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int hi = (i % 4) / 2;
            s[i] = sm90::ex2(fmaf(s[i], scale_log2, -m[hi]));
            l[hi] += s[i];  // the unrounded p
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

        uint32_t pa[BK / 16][4];  // P in bf16, the A fragments of P V
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) sm90::frag_a(pa[kk], s, kk);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            sm90::wgmma_rs_tb(acc, pa[kk], sm90::desc_mn(vs, BK, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
    }

    float lc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
        l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
        lc[e] = fmaxf(l[e], 1e-30f);
    }
    sm90::store_acc(o + b * st.o_sb + h * st.o_sh + row0 * st.o_ss, st.o_ss,
                    acc, 1.f / lc[0], 1.f / lc[1], wt);
    if (wt % 4 == 0) {
        float* lrow = lse + (static_cast<int64_t>(b) * H + h) * Sq;
        lrow[r_lo] = m[0] * sm90::LN2 + logf(lc[0]);
        lrow[r_lo + 8] = m[1] * sm90::LN2 + logf(lc[1]);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int KVH, int Sq, int Skv,
                   int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
    constexpr int smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Sq / BQ, H, B);
    flash_fwd_kernel_tc<D><<<grid, NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), H, H / KVH, Sq, Skv, causal,
        scale * sm90::LOG2E, st);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_fwd_kernel), 1 = bfloat16 (flash_fwd_kernel_tc).
// Strides are in elements, in the order (batch, head, seq) for q, k, v, o;
// the last dimension must be contiguous. bf16 needs strides divisible by 8
// and 16-byte-aligned pointers.
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
        return tc::launch<64>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return tc::launch<128>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
