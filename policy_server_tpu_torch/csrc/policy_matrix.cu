// Policy-matrix kernels for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ops/cuda_kernels.py).
//
// policy_matrix — replaces the Pallas kernel
// policy_server_tpu/ops/pallas_kernels.py::policy_matrix_program, the fused
// gather -> predicate -> reduce step of /validate. One launch evaluates every
// policy of a policy set over a batch of packed feature rows and writes the
// (batch, n_tiles * width) allowed / first-violated-rule matrices in the
// Pallas kernel's column layout.
//
// Why an interpreter: the Pallas kernel's body is traced from the policy
// set, so it differs for every set. A fixed CUDA source cannot hold those
// predicates; it interprets them instead. The host compiles the set's
// optimizer-folded rule conditions into a flat instruction tape
// (ops/cuda_kernels.py::compile_tape) with the same CSE keys the PyTorch
// lowering uses. Every instruction writes one slot of an arena; a slot holds
// the elements of one lowered sub-expression for one row (bool bytes or
// 32-bit words, element count = product of the quantifier axis caps).
//
// Bound on this card: the kernel must read B x W packed bytes and write
// B x cols x 5 output bytes: at B = 1024 and W = 14,208 B (narrow rows of
// the flagship set's large bucket) about 14.9 MB, 4.4 us at 3.35 TB/s. The
// interpreter's instruction stream, not memory, is what costs: the flagship
// tape has 354 instructions, half of them on one element per row.
//
// Design. Like the Pallas kernel, which vectorises over a 128-row tile, a
// block takes a tile of rows and walks its tape part once for all of them:
// every warp decodes the same instruction at the same time (warp-uniform
// control flow), and no instruction ends in a block-wide barrier.
//
//  * Tape parts. The host splits the policies into parts of about equal
//    instruction count (CSE shares within a part); grid dim 1 runs the
//    parts side by side, so the serial walk per block is one part long.
//    Each part writes its own policies' output columns.
//  * A warp per row: lanes stride over a slot's elements, with a
//    __syncwarp between instructions; reductions whose inner axis spans
//    the warp reduce with __reduce_add_sync. An instruction on one
//    element idles 31 lanes of one warp, not 255 threads of a block, and
//    the block's other warps, each on its own row, run beside it. The row
//    is read from device memory through the read-only cache (lanes on
//    neighbouring elements, so coalesced) and each warp's arena lives in
//    shared memory; the spill instance (L_WARPS_SPILL) keeps the arenas in a device scratch
//    buffer when even one warp's does not fit. A block holds 1-16 rows,
//    fewer while the grid would leave SMs without a block. (A lane per
//    row needs no barrier at all, but runs a slot's elements one after
//    another; it was slower at every batch the server forms: PERF.md.)
//  * The block stages its part's code (instructions, column records and
//    the InSet constants its own instructions use) into shared memory
//    once, each thread keeping eight 16-byte loads in flight, and decodes
//    from there, prefetching the next instruction; nothing on the walk
//    waits on device memory but the row reads.
//  * Broadcast divisors arrive as shifts when they are powers of two
//    (every quantifier cap the schemas use) and as negated divisors
//    otherwise (divide()).
//  * The interpreter's code is kept small (one plain loop per opcode, one
//    comparison for all six ops through a truth table, the rare division
//    out of line): a first version with every element loop unrolled four
//    times compiled to a larger body and walked the tape more slowly.
//
// Not done here (later work): per-set generated kernels instead of an
// interpreter, TMA or cp.async double-buffered row staging (rows of
// 364-27,268 B are read where an instruction needs them, a few hundred
// bytes per instruction), and fusing the group combine and output packing.
//
// probe — a (8, 128) float32 `x + 1` kernel, launched once per process when
// an environment is built on the card: it proves that the library was built
// for this card and that a launch runs (it replaces the Mosaic capability
// probe of policy_server_tpu/ops/pallas_kernels.py::probe_mosaic_support).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// opcodes; keep in sync with ops/cuda_kernels.py. div(x, w) is divide().
enum Op : int {
  OP_LOAD_BIT = 0,   // bool[i] = bit (p0 + i) of the row's bit region
  OP_LOAD_U8 = 1,    // bool[i] = row[p0 + i] != 0
  OP_LOAD_U16 = 2,   // i32[i] = little-endian u16 at row[p0 + 2i]
  OP_LOAD_W32 = 3,   // w32[i] = 32-bit word at row[p0 + 4i]
  OP_CONST = 4,      // scalar: p1 == T_BOOL ? (p0 != 0) : p0 bits
  OP_CMP = 5,        // bool[i] = a[div(i, p0)] <op> b[div(i, p1)], p2 = op|ta<<4|tb<<6
  OP_AND = 6,        // bool[i] = a[div(i, p0)] & b[div(i, p1)]
  OP_OR = 7,         // bool[i] = a[div(i, p0)] | b[div(i, p1)]
  OP_NOT = 8,        // bool[i] = !a[i]
  OP_INSET = 9,      // bool[i] = a[i] in pool[p0 : p0 + p1] (the part's), p2 = type
  OP_ANY = 10,       // bool[o] = any_k(a[div(o*p0+k, p1)] & b[o*p0+k])
  OP_ALL = 11,       // bool[o] = all_k(a[div(o*p0+k, p1)] | !b[o*p0+k])
  OP_COUNT = 12,     // i32[o] = sum_k(a[div(o*p0+k, p1)] & b[o*p0+k])
  OP_RULE = 13,      // if a[0] and local column p0 not yet violated: rule = p1
};

enum Type : int { T_BOOL = 0, T_I32 = 1, T_F32 = 2 };

enum Cmp : int { C_EQ = 0, C_NE = 1, C_LT = 2, C_LE = 3, C_GT = 4, C_GE = 5 };

// where the arenas live; keep in sync with ops/cuda_kernels.py
enum Layout : int { L_WARPS = 0, L_WARPS_SPILL = 1 };

constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const uint8_t* buf;
  const int4* code;   // each part: 2 int4 per instruction, one (output
                      // column, allowed, rule, 0) per column, its pool
  const int4* meta;   // per part: (code offset, instructions, columns,
                      // pool int4s)
  uint8_t* scratch;   // L_WARPS_SPILL arenas, (batch, n_parts)
  uint8_t* allowed_out;
  int* rule_out;
  int batch, row_width, n_parts, out_cols, arena_bytes;
  int rows_per_block, max_cols, off_cols, off_arena;
};

__device__ __noinline__ int divide_slow(int x, int d) { return x / d; }

// a broadcast divisor: w >= 0 is a shift, w < 0 divides by -w
__device__ __forceinline__ int divide(int x, int w) {
  return w >= 0 ? x >> w : divide_slow(x, -w);
}

// For each comparison op (EQ, NE, LT, LE, GT, GE, a nibble each), the
// outcomes that make it true: bit 0 less, 1 equal, 2 greater, 3 unordered.
constexpr int kCmpTruth = 0x6431D2;

// One row's arena: bool slots are bytes, other slots 32-bit words.
struct Arena {
  unsigned char* base;
  __device__ __forceinline__ int ldb(int off, int i) const {
    return base[off + i];
  }
  __device__ __forceinline__ void stb(int off, int i, int v) const {
    base[off + i] = static_cast<unsigned char>(v);
  }
  __device__ __forceinline__ int ldw(int off, int i) const {
    return reinterpret_cast<const int*>(base + off)[i];
  }
  __device__ __forceinline__ void stw(int off, int i, int v) const {
    reinterpret_cast<int*>(base + off)[i] = v;
  }
  // element i of a slot of `type`, as raw bits (a bool as 0/1)
  __device__ __forceinline__ int ld(int off, int type, int i) const {
    return type == T_BOOL ? ldb(off, i) : ldw(off, i);
  }
};

// raw bits of `type` -> float32; int32 rounds to nearest, as the PyTorch
// and jnp promotions do
__device__ __forceinline__ float to_float(int v, int type) {
  return type == T_F32 ? __int_as_float(v) : __int2float_rn(v);
}

// Copies n 16-byte words from device memory to shared memory, each thread
// keeping eight loads in flight before it stores.
__device__ __forceinline__ void stage(const int4* __restrict__ src, int n,
                                      int4* dst) {
  constexpr int U = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * blockDim.x) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

template <int kLayout>
__global__ void __launch_bounds__(512)
    policy_matrix_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rpb = p.rows_per_block;
  const int row0 = blockIdx.x * rpb;
  const int nrows = min(rpb, p.batch - row0);
  const int4 meta = __ldg(p.meta + blockIdx.y);
  const int n_instr = meta.y;
  const int ncols = meta.z;

  // stage the part's code: instructions, column records, pool
  int4* code = reinterpret_cast<int4*>(smem);
  stage(p.code + meta.x, 2 * n_instr + ncols + meta.w, code);
  __syncthreads();

  const int r = tid >> 5;  // this warp's row in the block
  if (r >= nrows) return;  // no barrier follows
  const int row = row0 + r;
  const int4* cols = code + 2 * n_instr;
  const int* pool = reinterpret_cast<const int*>(cols + ncols);
  const unsigned char* src = p.buf + static_cast<size_t>(row) * p.row_width;
  Arena arena;
  arena.base =
      kLayout == L_WARPS
          ? smem + p.off_arena + r * p.arena_bytes
          : p.scratch + (static_cast<size_t>(row) * p.n_parts + blockIdx.y) *
                            p.arena_bytes;
  // local column k of this row at [k * rpb]
  int* col_allowed = reinterpret_cast<int*>(smem + p.off_cols) + r;
  int* col_rule = col_allowed + rpb * p.max_cols;
  for (int k = lane; k < ncols; k += 32) {
    col_allowed[k * rpb] = cols[k].y;
    col_rule[k * rpb] = cols[k].z;
  }
  __syncwarp();

  int4 w0 = make_int4(0, 0, 0, 0), w1 = w0;
  if (n_instr > 0) {
    w0 = code[0];
    w1 = code[1];
  }
  for (int pc = 0; pc < n_instr; ++pc) {
    const int op = w0.x, d = w0.y, a = w0.z, b = w0.w;
    const int n = w1.x, p0 = w1.y, p1 = w1.z, p2 = w1.w;
    if (pc + 1 < n_instr) {
      w0 = code[2 * pc + 2];
      w1 = code[2 * pc + 3];
    }
    switch (op) {
      case OP_LOAD_BIT:
        for (int i = lane; i < n; i += 32) {
          const int bit = p0 + i;
          arena.stb(d, i, (__ldg(src + (bit >> 3)) >> (bit & 7)) & 1);
        }
        break;
      case OP_LOAD_U8:
        for (int i = lane; i < n; i += 32)
          arena.stb(d, i, __ldg(src + p0 + i) != 0);
        break;
      case OP_LOAD_U16:
        for (int i = lane; i < n; i += 32)
          arena.stw(d, i,
                    __ldg(src + p0 + 2 * i) | (__ldg(src + p0 + 2 * i + 1) << 8));
        break;
      case OP_LOAD_W32:
        for (int i = lane; i < n; i += 32)
          arena.stw(d, i, __ldg(reinterpret_cast<const int*>(src + p0) + i));
        break;
      case OP_CONST:
        if (lane == 0) {
          if (p1 == T_BOOL)
            arena.stb(d, 0, p0 != 0);
          else
            arena.stw(d, 0, p0);
        }
        break;
      case OP_CMP: {
        const int truth = kCmpTruth >> (4 * (p2 & 15));
        const int ta = (p2 >> 4) & 3, tb = (p2 >> 6) & 3;
        const bool fp = ta == T_F32 || tb == T_F32;
        for (int i = lane; i < n; i += 32) {
          const int x = arena.ld(a, ta, divide(i, p0));
          const int y = arena.ld(b, tb, divide(i, p1));
          int outcome;
          if (fp) {
            const float fx = to_float(x, ta), fy = to_float(y, tb);
            outcome = fx < fy ? 0 : fx == fy ? 1 : fx > fy ? 2 : 3;
          } else {
            outcome = x < y ? 0 : x == y ? 1 : 2;
          }
          arena.stb(d, i, (truth >> outcome) & 1);
        }
        break;
      }
      case OP_AND:
      case OP_OR:
        for (int i = lane; i < n; i += 32) {
          const int x = arena.ldb(a, divide(i, p0));
          const int y = arena.ldb(b, divide(i, p1));
          arena.stb(d, i, op == OP_AND ? x & y : x | y);
        }
        break;
      case OP_NOT:
        for (int i = lane; i < n; i += 32)
          arena.stb(d, i, !arena.ldb(a, i));
        break;
      case OP_INSET:
        for (int i = lane; i < n; i += 32) {
          const int x = arena.ld(a, p2, i);
          bool hit = false;
          for (int k = 0; k < p1; ++k) {
            const int m = pool[p0 + k];
            hit |= p2 == T_F32 ? __int_as_float(x) == __int_as_float(m)
                               : x == m;
          }
          arena.stb(d, i, hit);
        }
        break;
      case OP_ANY:
      case OP_ALL:
      case OP_COUNT: {
        // each output folds the count of its inner elements where the
        // predicate holds (ANY, COUNT) or fails (ALL) under the mask
        const int flip = op == OP_ALL;
        if (p0 >= 32 || n == 1) {
          // lanes over the inner axis, one warp reduction per output
          for (int o = 0; o < n; ++o) {
            int acc = 0;
            for (int k = lane; k < p0; k += 32) {
              const int j = o * p0 + k;
              acc += (arena.ldb(a, divide(j, p1)) ^ flip) & arena.ldb(b, j);
            }
            acc = static_cast<int>(__reduce_add_sync(kFull, acc));
            if (lane == 0) {
              if (op == OP_COUNT)
                arena.stw(d, o, acc);
              else
                arena.stb(d, o, (acc != 0) ^ flip);
            }
          }
        } else {
          // lanes over the outputs
          for (int o = lane; o < n; o += 32) {
            int acc = 0;
            for (int k = 0; k < p0; ++k) {
              const int j = o * p0 + k;
              acc += (arena.ldb(a, divide(j, p1)) ^ flip) & arena.ldb(b, j);
            }
            if (op == OP_COUNT)
              arena.stw(d, o, acc);
            else
              arena.stb(d, o, (acc != 0) ^ flip);
          }
        }
        break;
      }
      case OP_RULE:
        if (lane == 0 && arena.ldb(a, 0) && col_allowed[p0 * rpb]) {
          col_allowed[p0 * rpb] = 0;
          col_rule[p0 * rpb] = p1;
        }
        break;
      default:
        break;
    }
    __syncwarp();
  }

  for (int k = lane; k < ncols; k += 32) {
    const size_t o = static_cast<size_t>(row) * p.out_cols + cols[k].x;
    p.allowed_out[o] = static_cast<uint8_t>(col_allowed[k * rpb] != 0);
    p.rule_out[o] = col_rule[k * rpb];
  }
}

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

template <int kLayout>
cudaError_t launch_policy_matrix(const Params& p, int smem_bytes,
                                 cudaStream_t stream) {
  static int smem_attr = 48 * 1024;
  if (smem_bytes > smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        policy_matrix_kernel<kLayout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    smem_attr = smem_bytes;
  }
  const dim3 grid((p.batch + p.rows_per_block - 1) / p.rows_per_block,
                  p.n_parts);
  policy_matrix_kernel<kLayout>
      <<<grid, 32 * p.rows_per_block, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// What a launch needs that does not change from call to call for one
// program, batch size and device; keep in sync with
// ops/cuda_kernels.py::_LaunchArgs.
struct LaunchArgs {
  const void* code;
  const void* meta;
  int row_width, n_parts, out_cols, arena_bytes;
  int layout, rows_per_block, max_cols, off_cols, off_arena, smem_bytes;
};

extern "C" {

// Launches policy_matrix_kernel in args->layout on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown layout).
int pm_policy_matrix(const LaunchArgs* args, const void* buf, int batch,
                     void* scratch, void* allowed_out, void* rule_out,
                     void* stream) {
  const LaunchArgs& a = *args;
  Params p;
  p.buf = static_cast<const uint8_t*>(buf);
  p.code = static_cast<const int4*>(a.code);
  p.meta = static_cast<const int4*>(a.meta);
  p.scratch = static_cast<uint8_t*>(scratch);
  p.allowed_out = static_cast<uint8_t*>(allowed_out);
  p.rule_out = static_cast<int*>(rule_out);
  p.batch = batch;
  p.row_width = a.row_width;
  p.n_parts = a.n_parts;
  p.out_cols = a.out_cols;
  p.arena_bytes = a.arena_bytes;
  p.rows_per_block = a.rows_per_block;
  p.max_cols = a.max_cols;
  p.off_cols = a.off_cols;
  p.off_arena = a.off_arena;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (a.layout) {
    case L_WARPS:
      err = launch_policy_matrix<L_WARPS>(p, a.smem_bytes, s);
      break;
    case L_WARPS_SPILL:
      err = launch_policy_matrix<L_WARPS_SPILL>(p, a.smem_bytes, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Launches probe_kernel (y = x + 1) on `stream`; returns cudaGetLastError().
int pm_probe(const void* x, void* y, int n, void* stream) {
  const int threads = 256;
  probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
