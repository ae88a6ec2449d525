// Device helpers shared by the generated row kernels (the fused reduce,
// csrc/fused_reduce_gen.cuh, and the row mask, csrc/row_mask_gen.cuh):
// their shape constants, 16-byte read-only loads and the lanes of staged
// rows. kernels/rowgen.py splices this text into each template at its
// ROW_COMMON mark; NVRTC compiles it with its builtins only.

namespace rowgen {

constexpr int kThreads = 512;          // rowgen.THREADS
constexpr int kRowsPerThread = 16;     // rowgen.ROWS_PER_THREAD
constexpr long long kTile = (long long)kThreads * kRowsPerThread;
constexpr int kMaxSlots = 32;          // rowprog.MAX_SLOTS
constexpr int kMaxConsts = 128;        // rowgen.MAX_CONSTS

struct __align__(16) V16 {
  unsigned x, y, z, w;
};

// one 16-byte read-only load (the address is 16-byte aligned)
__device__ __forceinline__ V16 ldg16(const void* p) {
  V16 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int N>
__device__ __forceinline__ void vload(const void* base, long long byte_off,
                                      V16 (&out)[N]) {
  const char* p = static_cast<const char*>(base) + byte_off;
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = ldg16(p + 16 * j);
}

// 32-bit word k of staged vectors (k is a constant once unrolled)
__device__ __forceinline__ unsigned word(const V16* v, int k) {
  const V16 q = v[k >> 2];
  const int s = k & 3;
  return s == 0 ? q.x : s == 1 ? q.y : s == 2 ? q.z : q.w;
}

// row r of 16 staged rows of each element type (little-endian)
__device__ __forceinline__ int lane_i8(const V16* v, int r) {
  return (int)(signed char)(word(v, r >> 2) >> (8 * (r & 3)));
}
__device__ __forceinline__ int lane_b8(const V16* v, int r) {
  return ((word(v, r >> 2) >> (8 * (r & 3))) & 0xffu) != 0;
}
__device__ __forceinline__ int lane_i16(const V16* v, int r) {
  return (int)(short)(word(v, r >> 1) >> (16 * (r & 1)));
}
__device__ __forceinline__ int lane_i32(const V16* v, int r) {
  return (int)word(v, r);
}
__device__ __forceinline__ long long lane_i64(const V16* v, int r) {
  return (long long)(((unsigned long long)word(v, 2 * r + 1) << 32) |
                     word(v, 2 * r));
}

__device__ __forceinline__ int min(int a, int b) { return a < b ? a : b; }

}  // namespace rowgen
