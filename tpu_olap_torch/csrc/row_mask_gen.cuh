// Row mask for Hopper (sm_90a): the kernel template into which
// kernels/rowgen.py splices one Scan/Select/Search plan's row function,
// compiled per program structure with NVRTC (kernels/cuda_build.py).
//
// Replaces: no Pallas kernel. The JAX package computes a scan's row mask
// as a plain XLA program (tpu_olap/executor/lowering.py::_lower_mask: the
// validity and segment masks ANDed with the filter and the interval
// mask). Here that front half is traced into a row program like the
// fused reduce's (csrc/fused_reduce_gen.cuh) and written out as straight-
// line code, so the whole mask is one launch instead of one torch launch
// per operator. The query's literals are kernel constants (rowgen), so
// scans that differ only in literals share one compiled kernel.
//
// Output: one byte per row of the launch's [S, R] segment stack (the
// segment window the runner dispatches): 1 where the row is valid, its
// segment is kept and the plan's mask holds, else 0. Every byte is
// written, so rows of pruned segments read as 0 in place.
//
// What bounds it on this card: bytes. Each row of a kept segment reads
// its valid byte and, when valid, the streams of the mask's cone; every
// row writes its mask byte. For q1.1's filter at SF1 that is ~48 MB:
// ~14 us at 3.35 TB/s. PERF.md keeps the measured times (chip_smoke.py).
//
// What the design does about it: the tiles and loads of the fused
// reduce. A block walks tiles of kThreads x 16 rows inside one segment;
// each thread reads its 16 valid bytes and each cone stream as 16-byte
// loads (ld.global.nc.v4), evaluates the rows that are valid, and writes
// its 16 mask bytes with one 16-byte store. A pruned tile reads nothing
// and writes zeros. A launch whose segment length or pointers do not
// allow aligned vectors reads and writes one row at a time.
//
// No header is included: NVRTC compiles this with its builtins only;
// kernels/rowgen.py splices csrc/row_common.cuh in at ROW_COMMON.

//@@ROW_COMMON@@

//@@ROWGEN_PLAN@@

namespace rowgen {

// mirrored by row_mask.MaskParams
struct MaskParams {
  const void* slot[kMaxSlots];
  const unsigned char* valid;     // [S, R] row validity
  const unsigned char* seg_mask;  // [S] segments kept by pruning
  const long long* data;          // the program's tables
  unsigned char* out;             // [S, R] the row mask
  long long seg_rows;             // R
  long long tiles_per_seg;        // ceil(R / kTile)
  long long n_tiles;              // S * tiles_per_seg
  long long consts[kMaxConsts];   // rowgen.constants: the query's literals
  int vec;                        // 16-byte loads and stores allowed
};

__device__ __forceinline__ void stg16(void* p, const V16& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

}  // namespace rowgen

extern "C" __global__ void __launch_bounds__(rowgen::kThreads)
row_mask_gen(const __grid_constant__ rowgen::MaskParams p) {
  using namespace rowgen;
  using namespace rowgen_plan;
  for (long long t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const long long seg = t / p.tiles_per_seg;
    const long long seg_end = (seg + 1) * p.seg_rows;
    const long long i0 = seg * p.seg_rows +
                         (t - seg * p.tiles_per_seg) * kTile +
                         (long long)threadIdx.x * kRowsPerThread;
    if (i0 >= seg_end) continue;
    const bool kept = p.seg_mask[seg] != 0;
    if (p.vec && i0 + kRowsPerThread <= seg_end) {
      V16 m = {0u, 0u, 0u, 0u};
      if (kept) {
        V16 vb[1];
        vb[0] = ldg16(p.valid + i0);
        if ((vb[0].x | vb[0].y | vb[0].z | vb[0].w) != 0u) {
          Cone c;
          cone_load(p.slot, i0, c);
          unsigned w[4] = {0u, 0u, 0u, 0u};
          RowOut o;
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            if (lane_b8(vb, r) &&
                row_vec(p.slot, p.data, p.consts, i0 + r, c, r, o))
              w[r >> 2] |= 1u << (8 * (r & 3));
          }
          m.x = w[0];
          m.y = w[1];
          m.z = w[2];
          m.w = w[3];
        }
      }
      stg16(p.out + i0, m);
    } else {
      RowOut o;
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long i = i0 + r;
        if (i >= seg_end) break;
        p.out[i] = kept && p.valid[i] &&
                   row_scalar(p.slot, p.data, p.consts, i, o);
      }
    }
  }
}
