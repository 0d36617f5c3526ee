// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels, as
// inline PTX: asynchronous tile loads into the 128-byte-swizzled layout that
// wgmma reads, shared-memory matrix descriptors, wgmma and its fences, and
// the register fragments that carry one product's result into the next.
//
// Layout of a staged tile. A ROWS x D bf16 tile (D = 64 or 128) is held as
// D / 64 subtiles of ROWS x 64; each subtile row is 128 bytes, and its 16-byte
// chunk c sits at chunk position c ^ (row % 8) (the 128-byte swizzle, whose
// atom is 8 rows x 128 bytes = 1024 bytes). Every subtile starts on a
// 1024-byte boundary. The same bytes serve two readings:
// - K-major (the product's depth runs along the row, as D in Q K^T): one
//   wgmma k-step of 16 elements is 32 bytes into the row, so the descriptor
//   of k-step s starts at subtile s / 4, plus (s % 4) * 32 bytes; the 8-row
//   groups are 1024 bytes apart (SBO). LBO is unused.
// - MN-major (the depth runs down the rows, as the kv rows of V in P V): the
//   descriptor of k-step s starts 16 rows down (s * 2048 bytes), the next
//   8 rows are 1024 bytes on (SBO), and the next 64 columns are in the next
//   subtile (LBO = ROWS * 128 bytes); wgmma's transpose-B flag reads it so.
//
// Loads are cp.async (16 bytes a thread, tracked by commit / wait groups);
// each thread that waited runs fence.proxy.async before the block barrier,
// so that wgmma, which reads shared memory through the async proxy, sees
// the bytes. (With cp.async groups no mbarrier is needed.)
//
// Accumulator fragment of an m64nN fp32 wgmma result, thread t of the
// warpgroup (warp w = t / 32, lane l): d[4 j + e] holds row
// 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2. Rounded to bf16
// in pairs, columns 16 kk .. 16 kk + 15 of it are exactly the register A
// fragment of k-step kk of the next product (frag_a below): that is how P
// (forward) and P^T, dS^T (dk/dv) go from one wgmma into the next without
// touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x by the special-function unit (flush-to-zero: the softmax's masked
// and underflowing terms are 0 either way).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's completed cp.async writes visible to the async proxy
// (wgmma's operand reads); a block barrier must follow.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start copying a ROWS x D bf16 tile (contiguous along D, rows row_stride
// elements apart, 16-byte aligned) into shared memory at dst (1024-byte
// aligned) in the swizzled layout above; NT threads share the work, thread
// tid takes chunks tid, tid + NT, ...
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int tid) {
    constexpr int CPR = D / 8;  // 16-byte chunks per row
    static_assert((ROWS * CPR) % NT == 0, "chunks must split evenly");
#pragma unroll
    for (int i = 0; i < ROWS * CPR / NT; ++i) {
        const int c = tid + i * NT;
        const int r = c / CPR;
        const int ch = c % CPR;
        const uint32_t off = (ch / 8) * (ROWS * 128) + r * 128
                             + (((ch % 8) ^ (r % 8)) << 4);
        cp_async16(dst + off, src + r * row_stride + ch * 8);
    }
}

// Start copying N contiguous fp32 values (16-byte aligned) to dst.
template <int N>
__device__ __forceinline__ void load_row(uint32_t dst, const float* src,
                                         int tid) {
    if (tid < N / 4) cp_async16(dst + tid * 16, src + tid * 4);
}

// ------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
           | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
           | (1ull << 62);
}

// K-major descriptor of k-step s of a staged tile of `rows` rows, starting
// at row `row0` (a multiple of 8).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int s) {
    return desc_sw128(tile + (s / 4) * rows * 128 + row0 * 128 + (s % 4) * 32,
                      16, 1024);
}

// MN-major descriptor of k-step s (rows 16 s .. 16 s + 15) of a staged
// tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int s) {
    return desc_sw128(tile + s * 2048, rows * 128, 1024);
}

// Before a wgmma reads registers (accumulators, A fragments) that other
// instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64n64, fp32) += A (smem, K-major) * B (smem, K-major)^T; scale_d == 0
// overwrites d instead.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64n64, fp32) += A (registers, bf16 fragment) * B (smem, MN-major:
// the transpose-B flag); scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (m64n128, fp32) += A (registers, bf16 fragment) * B (smem, MN-major:
// the transpose-B flag); scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ------------------------------------------------------------ fragments

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of an
// fp32 accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&d)[N],
                                       int kk) {
    a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Store an m64nD fp32 accumulator, rounded to bf16, to rows row0 + (its
// fragment rows) of a strided [rows, D] output; scale multiplies row r's
// values (lo for the first 8 rows of a warp's 16, hi for the last 8).
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          int64_t row_stride,
                                          const float (&d)[N], float lo,
                                          float hi, int tid) {
    const int r = (tid / 32) * 16 + (tid % 32) / 4;
    const int c = 2 * (tid % 4);
    __nv_bfloat16* r0 = out + r * row_stride + c;
    __nv_bfloat16* r1 = r0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
        *reinterpret_cast<uint32_t*>(r0 + 8 * j) =
            pack_bf16(d[4 * j] * lo, d[4 * j + 1] * lo);
        *reinterpret_cast<uint32_t*>(r1 + 8 * j) =
            pack_bf16(d[4 * j + 2] * hi, d[4 * j + 3] * hi);
    }
}

}  // namespace sm90
