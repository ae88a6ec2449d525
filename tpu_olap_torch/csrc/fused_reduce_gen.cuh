// Fused filter -> group key -> grouped reduce for Hopper (sm_90a): the
// kernel template into which kernels/rowgen.py splices one plan's row
// function, compiled per plan with NVRTC (kernels/cuda_build.py).
//
// Replaces: the TPU kernel B1, tpu_olap/kernels/pallas_reduce.py::
// build_kernel (pl.pallas_call in fn). Like B1's body, one pass over the
// rows ANDs the validity, segment, interval and filter masks, evaluates
// the integer virtual columns, computes the dimension ids and the
// mixed-radix group key, and reduces per group (counts, exact int64
// sums, int32 minimums; a max rides negated). B1 is traced and compiled
// by JAX once per query; this kernel is generated and compiled once per
// program structure, so nothing is looked up per row: the row function
// is straight-line code with its widths, slot types and table offsets as
// literals, and reads the query's literals (immediates, short IN lists)
// as kernel constants from the parameter block, so queries that differ
// only in literals share one compiled kernel.
//
// What bounds it on this card: bytes read, then atomics. Every row of a
// kept segment reads its valid byte and the streams of the mask's cone;
// a row that passes reads the streams its key and values need and
// updates the group table. For SSB q2.1 at SF1 that is ~19 MB: ~6 us at
// 3.35 TB/s. PERF.md keeps the measured times (chip_smoke.py).
//
// What the design does about it:
//  - Segment-aligned tiles: a block walks tiles of kThreads x 16 rows
//    that lie inside one segment and reads the segment's keep flag once
//    per tile, so a pruned tile reads nothing.
//  - Each thread takes 16 consecutive rows: their valid bytes as one
//    16-byte load, and each stream of the mask's cone as 16-byte loads
//    (ld.global.nc.v4); streams outside the cone are read as scalars
//    only for rows that pass. A launch whose segment length or pointers
//    do not allow aligned vectors takes scalar loads throughout.
//  - The reduce: a block-private group table in dynamic shared memory
//    when it fits 200 KB: value sums as 64-bit atomics (two's-complement
//    wrap gives signed sums exactly), counts as 32-bit atomics (a block
//    sees fewer than 2^32 rows; the wrapper checks), minimums as 32-bit
//    atomicMin; flushed with one global atomic per nonzero slot. With
//    one group (K = 1) each thread accumulates in registers and a warp
//    reduces with shuffles before one shared atomic per column. Past
//    200 KB the rows update the int64 / int32 outputs with global
//    atomics directly.
//  - The wrapper launches only as many blocks as the occupancy
//    calculator allows for this kernel at its shared-memory size.
//
// The segment-extended variant (kSegGroups = K > 0, kGroups = W * K)
// serves tier 1 of the result cache (executor.resultcache): like the JAX
// package's QueryRunner._seg_partials_kernel, it reduces every segment
// of the window [seg_lo, seg_lo + W) into groups of its own, the row's
// key plus (seg - seg_lo) * K, so that one launch returns each computed
// segment's own partials. The blocks walk only the window's tiles, and
// seg_lo is a launch parameter: a window that slides at the same W
// reuses the compiled kernel.
//
// No header is included: NVRTC compiles this with its builtins only;
// kernels/rowgen.py splices csrc/row_common.cuh in at ROW_COMMON.

//@@ROW_COMMON@@

//@@ROWGEN_PLAN@@

namespace rowgen {

// mirrored by rowgen.Params
struct Params {
  const void* slot[kMaxSlots];
  const unsigned char* valid;     // [S, R] row validity
  const unsigned char* seg_mask;  // [S] segments kept by pruning
  const long long* data;          // the program's tables
  unsigned long long* sums;       // [K, kSum] int64
  int* mins;                      // [K, kMin] int32
  long long seg_rows;             // R
  long long tiles_per_seg;        // ceil(R / kTile)
  long long n_tiles;              // end of the tiles walked
  long long tile_lo;              // first tile walked
  long long seg_lo;               // the segment-extended key's window
  long long consts[kMaxConsts];   // rowgen.constants: the query's literals
  int vec;                        // 16-byte loads allowed
};

// the segment-extended key: a row keyed outside [0, K) is dropped, as
// the plain kernel drops it; else it moves to its segment's groups
__device__ __forceinline__ bool seg_key(rowgen_plan::RowOut& o,
                                        long long seg, long long lo) {
  if constexpr (rowgen_plan::kSegGroups > 0) {
    if (o.key < 0 || o.key >= rowgen_plan::kSegGroups) return false;
    o.key += (seg - lo) * rowgen_plan::kSegGroups;
  }
  (void)seg; (void)lo;
  return true;
}

}  // namespace rowgen

extern "C" __global__ void __launch_bounds__(rowgen::kThreads)
fused_reduce_gen(const __grid_constant__ rowgen::Params p) {
  using namespace rowgen;
  using namespace rowgen_plan;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* t64 = reinterpret_cast<unsigned long long*>(smem);
  unsigned* t32 = reinterpret_cast<unsigned*>(t64 + kGroups * kN64);
  int* tmin = reinterpret_cast<int*>(t32 + kGroups * kN32);
  if constexpr (kShared) {
    for (long long j = threadIdx.x; j < kGroups * kN64; j += kThreads)
      t64[j] = 0ull;
    for (long long j = threadIdx.x; j < kGroups * kN32; j += kThreads)
      t32[j] = 0u;
    for (long long j = threadIdx.x; j < kGroups * kNMin; j += kThreads)
      tmin[j] = 2147483647;
    __syncthreads();
  }
  Acc acc;
  acc_init(acc);

  for (long long t = p.tile_lo + blockIdx.x; t < p.n_tiles;
       t += gridDim.x) {
    const long long seg = t / p.tiles_per_seg;
    if (!p.seg_mask[seg]) continue;  // a pruned tile reads nothing more
    const long long seg_end = (seg + 1) * p.seg_rows;
    const long long i0 = seg * p.seg_rows +
                         (t - seg * p.tiles_per_seg) * kTile +
                         (long long)threadIdx.x * kRowsPerThread;
    if (i0 >= seg_end) continue;
    RowOut o;
    if (p.vec && i0 + kRowsPerThread <= seg_end) {
      V16 vb[1];
      vb[0] = ldg16(p.valid + i0);
      if ((vb[0].x | vb[0].y | vb[0].z | vb[0].w) == 0u) continue;
      Cone c;
      cone_load(p.slot, i0, c);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (!lane_b8(vb, r)) continue;
        if (!row_vec(p.slot, p.data, p.consts, i0 + r, c, r, o)) continue;
        if (!seg_key(o, seg, p.seg_lo)) continue;
        if constexpr (kOneGroup) acc_take(acc, o);
        else if constexpr (kShared) take_shared(o, t64, t32, tmin);
        else take_global(o, p.sums, p.mins);
      }
    } else {
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long i = i0 + r;
        if (i >= seg_end) break;
        if (!p.valid[i]) continue;
        if (!row_scalar(p.slot, p.data, p.consts, i, o)) continue;
        if (!seg_key(o, seg, p.seg_lo)) continue;
        if constexpr (kOneGroup) acc_take(acc, o);
        else if constexpr (kShared) take_shared(o, t64, t32, tmin);
        else take_global(o, p.sums, p.mins);
      }
    }
  }

  if constexpr (kShared) {
    if constexpr (kOneGroup) acc_spill(acc, t64, t32, tmin);
    __syncthreads();
    for (long long k = threadIdx.x; k < kGroups; k += kThreads)
      flush(k, t64, t32, tmin, p.sums, p.mins);
  }
}
