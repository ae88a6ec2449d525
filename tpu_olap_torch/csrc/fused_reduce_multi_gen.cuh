// The multi-leg fused reduce for Hopper (sm_90a): N query legs in one
// launch, the kernel template into which kernels/rowgen.py splices every
// leg's row function and reduce glue, compiled per batch composition with
// NVRTC (kernels/cuda_build.py).
//
// Replaces: the fused XLA program of the JAX package's shared-scan batch
// executor (tpu_olap/executor/batch.py::_build_fused, run by
// _enqueue_fused_device), which runs N legs' front halves and reduces
// over one read of the shared columns. Like B1 (csrc/fused_reduce_gen.cuh)
// this is not a port of a Pallas kernel: the JAX package fuses a batch
// with XLA; here the legs that B1 would serve alone (plan.fused_reason
// is None) run in one generated kernel. Each leg gets back exactly what
// B1 gives it alone: per group `_rows`, counts, exact int64 sums and
// int32 minimums (a max rides negated).
//
// What bounds it on this card: bytes read, then atomics, as for B1, but
// summed over the union of the legs' streams instead of over each leg:
// every row of a segment some leg keeps has one valid byte; each leg that
// keeps the segment reads its mask cone's streams, and the streams its
// key and values need for the rows that pass it.
//
// What the design does about it:
//  - A block serves one leg at a time, as a block of B1 does: the leg's
//    tiles (kThreads x 16 rows inside one segment), loads, row function
//    and group table. So a block's shared memory holds one leg's table,
//    not every leg's side by side, and 2 or more blocks share an SM (see
//    the launch bounds): with every leg in every thread and every table
//    in each block, one block fit an SM and the launch ran slower than
//    the legs' B1 launches one after another.
//  - Blocks start spread over the legs (block b on leg b mod N) and draw
//    their leg's tiles in order from a counter of the leg's own (one
//    atomic a tile). A block whose leg has no tile left flushes its
//    table and moves to the next leg, so legs that keep few segments do
//    not leave SMs idle. A tile of a segment the leg does not keep reads
//    nothing more. (Drawing 8 tiles at a time, or starting each draw
//    before the work on the tile before it, ran no faster on SSB.)
//  - Loads: the legs move through the rows side by side, so a column or
//    valid byte that several legs read comes from device memory about
//    once and from L2 for the other legs. The legs do NOT share one load
//    in registers or shared memory; staging the union of the cones once
//    (TMA or cp.async) is later work.
//  - Group tables, as B1: in dynamic shared memory when a leg's table
//    fits 200 KB (the launch reserves the largest such table), flushed to
//    the leg's outputs with one global atomic per nonzero slot; past
//    200 KB the leg updates its global outputs with atomics directly. A
//    one-group leg (K = 1) accumulates in registers and reduces across
//    the warp with shuffles.
//  - Every leg's slot pointers, tables, segment mask, outputs and kernel
//    constants ride in the kernel's parameter block, packed at offsets
//    that are literals in the generated code, as B1's ride in its own:
//    so the row functions read them as constant-bank operands: read
//    from a table in device memory, they are hoisted into registers.
//    The block may exceed the classic 4 KB: sm_90 kernels built with CUDA
//    12.1 or later take up to 32,764 bytes, which the wrapper checks.
//    Only the legs' tile counters live in device memory, zeroed with
//    the outputs.
//
// No header is included: NVRTC compiles this with its builtins only;
// kernels/rowgen.py splices csrc/row_common.cuh in at ROW_COMMON and the
// legs' code at ROWGEN_PLAN.

//@@ROW_COMMON@@

namespace rowgen {

// The launch's fields that are not per leg; the head of the generated
// `rowgen_multi::MultiParams`, mirrored by rowgen.MultiHead.
struct MultiHead {
  unsigned long long* next;       // [N] each leg's next tile, 0 at launch
  const unsigned char* valid;     // [S, R] row validity
  long long seg_rows;             // R
  long long tiles_per_seg;        // ceil(R / kTile)
  long long n_tiles;              // S * tiles_per_seg
  int vec;                        // 16-byte loads allowed for every leg
};

// One leg's arguments, pointers into and values from the parameter
// block (the generated `rowgen_multi::run` fills it per leg).
struct LegView {
  const void* const* slot;        // the leg program's input streams
  const long long* data;          // the leg program's tables
  const unsigned char* seg_mask;  // [S] segments this leg keeps
  unsigned long long* sums;       // [K, kSum] int64
  int* mins;                      // [K, kMin] int32
  const long long* consts;        // rowgen.constants: the leg's literals
};

// The block's next tile of a leg: one atomic by thread 0, handed to the
// block through two shared slots used in turn (`round` counts the
// block's draws), so one barrier a draw suffices.
__device__ __forceinline__ long long next_tile(unsigned long long* next,
                                               unsigned long long* slots,
                                               unsigned& round) {
  unsigned long long* s = slots + (round++ & 1u);
  if (threadIdx.x == 0) *s = atomicAdd(next, 1ull);
  __syncthreads();
  return (long long)*s;
}

// One block's share of leg L: B1's loop (csrc/fused_reduce_gen.cuh) over
// the tiles it draws from the leg's counter, then its flush. Every
// thread of the block takes the same path through the draws.
template <class L>
__device__ __forceinline__ void leg_run(const LegView& lp,
                                        const MultiHead& p,
                                        unsigned long long* next,
                                        unsigned char* smem,
                                        unsigned long long* slots,
                                        unsigned& round) {
  long long t = next_tile(next, slots, round);
  if (t >= p.n_tiles) return;  // the leg is done: no table to set up
  unsigned long long* t64 = reinterpret_cast<unsigned long long*>(smem);
  unsigned* t32 = reinterpret_cast<unsigned*>(t64 + L::kGroups * L::kN64);
  int* tmin = reinterpret_cast<int*>(t32 + L::kGroups * L::kN32);
  if constexpr (L::kShared) {
    for (long long j = threadIdx.x; j < L::kGroups * L::kN64; j += kThreads)
      t64[j] = 0ull;
    for (long long j = threadIdx.x; j < L::kGroups * L::kN32; j += kThreads)
      t32[j] = 0u;
    for (long long j = threadIdx.x; j < L::kGroups * L::kNMin; j += kThreads)
      tmin[j] = 2147483647;
    __syncthreads();
  }
  typename L::Acc acc;
  L::acc_init(acc);
  typename L::RowOut o;
  for (; t < p.n_tiles; t = next_tile(next, slots, round)) {
    const long long seg = t / p.tiles_per_seg;
    if (!lp.seg_mask[seg]) continue;  // a pruned tile reads nothing more
    const long long seg_end = (seg + 1) * p.seg_rows;
    const long long i0 = seg * p.seg_rows +
                         (t - seg * p.tiles_per_seg) * kTile +
                         (long long)threadIdx.x * kRowsPerThread;
    if (i0 >= seg_end) continue;
    if (p.vec && i0 + kRowsPerThread <= seg_end) {
      V16 vb[1];
      vb[0] = ldg16(p.valid + i0);
      if ((vb[0].x | vb[0].y | vb[0].z | vb[0].w) == 0u) continue;
      typename L::Cone c;
      L::cone_load(lp.slot, i0, c);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (!lane_b8(vb, r)) continue;
        if (!L::row_vec(lp.slot, lp.data, lp.consts, i0 + r, c, r, o))
          continue;
        if constexpr (L::kOneGroup) L::acc_take(acc, o);
        else if constexpr (L::kShared) L::take_shared(o, t64, t32, tmin);
        else L::take_global(o, lp.sums, lp.mins);
      }
    } else {
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long i = i0 + r;
        if (i >= seg_end) break;
        if (!p.valid[i]) continue;
        if (!L::row_scalar(lp.slot, lp.data, lp.consts, i, o)) continue;
        if constexpr (L::kOneGroup) L::acc_take(acc, o);
        else if constexpr (L::kShared) L::take_shared(o, t64, t32, tmin);
        else L::take_global(o, lp.sums, lp.mins);
      }
    }
  }
  if constexpr (L::kShared) {
    if constexpr (L::kOneGroup) L::acc_spill(acc, t64, t32, tmin);
    __syncthreads();
    for (long long k = threadIdx.x; k < L::kGroups; k += kThreads)
      L::flush(k, t64, t32, tmin, lp.sums, lp.mins);
    __syncthreads();  // the table is free for the block's next leg
  }
}

}  // namespace rowgen

//@@ROWGEN_PLAN@@

// At least 2 blocks per SM: each leg alone needs what its B1 kernel does
// (28-46 registers for SSB's legs), but ptxas gives the whole switch of
// SSB's 12 legs 106 registers and so 1 block per SM; capped at 64 it
// spills ~3 KB and runs 0.2125 ms against 0.2899 (H100, SSB SF1).
extern "C" __global__ void __launch_bounds__(rowgen::kThreads, 2)
fused_reduce_multi_gen(const __grid_constant__ rowgen_multi::MultiParams p) {
  using namespace rowgen;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long slots[2];
  unsigned round = 0;
  const int n = rowgen_multi::kLegs;
  const int first = (int)(blockIdx.x % (unsigned)n);
  for (int j = 0; j < n; ++j)
    rowgen_multi::run(first + j < n ? first + j : first + j - n, p, smem,
                      slots, round);
}
