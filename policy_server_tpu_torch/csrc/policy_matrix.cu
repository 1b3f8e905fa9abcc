// Policy-matrix kernels for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ops/cuda_kernels.py).
//
// policy_matrix — replaces the Pallas kernel
// policy_server_tpu/ops/pallas_kernels.py::policy_matrix_program, the fused
// gather -> predicate -> reduce step of /validate. One launch evaluates every
// policy of a policy set over a batch of packed feature rows and writes the
// (batch, n_tiles * width) allowed / first-violated-rule matrices.
//
// Why an interpreter: the Pallas kernel's body is traced from the policy
// set, so it differs for every set. A fixed CUDA source cannot hold those
// predicates; it interprets them instead. The host compiles each policy
// tile's optimizer-folded rule conditions into a flat instruction tape
// (ops/cuda_kernels.py::compile_tape) with the same CSE keys the PyTorch
// lowering uses, so a subtree shared by several policies is evaluated once
// per row. Every instruction writes one slot of a per-block arena; a slot
// holds the elements of one lowered sub-expression for one row (bool bytes
// or 32-bit words, element count = product of the quantifier axis caps).
//
// Layout: grid = (rows, policy tiles), one block per (row, tile). The block
// stages its packed row into shared memory with coalesced 16-byte loads
// (4-byte loads when the row width is not a multiple of 16), walks the
// tile's tape with its threads striding over each slot's elements and a
// barrier between instructions, and writes the tile's `width` columns of
// the allowed (uint8 0/1) and rule (int32, -1 when allowed) outputs in the
// Pallas kernel's output layout. As in the Pallas kernel, the unpacked
// feature matrix never reaches device memory: the arena lives in shared
// memory unless the tape's footprint does not fit, in which case the
// wrapper hands a device scratch buffer and the arena spills there.
//
// Bound on this card: the kernel must read B x W packed bytes and write
// B x cols x 5 output bytes; at B = 1024, W = 14,208 B (narrow rows of the
// flagship set's large bucket) that is about 14.9 MB, about 4.4 us at
// 3.35 TB/s, so the bound is memory. In practice instruction dispatch and the
// per-instruction barriers of the interpreter dominate; the simple design
// keeps one row per block so each block's work is independent and many
// blocks are in flight to hide the barriers. Specialising the tape,
// warp-per-row layouts and TMA staging are later work.
//
// probe — a (8, 128) float32 `x + 1` kernel, launched once per process when
// an environment is built on the card: it proves that the library was built
// for this card and that a launch runs (it replaces the Mosaic capability
// probe of policy_server_tpu/ops/pallas_kernels.py::probe_mosaic_support).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// opcodes; keep in sync with ops/cuda_kernels.py
enum Op : int {
  OP_LOAD_BIT = 0,   // bool[i] = bit (p0 + i) of the row's bit region
  OP_LOAD_U8 = 1,    // bool[i] = row[p0 + i] != 0
  OP_LOAD_U16 = 2,   // i32[i] = little-endian u16 at row[p0 + 2i]
  OP_LOAD_W32 = 3,   // w32[i] = 32-bit word at row[p0 + 4i]
  OP_CONST = 4,      // scalar: p1 == T_BOOL ? (p0 != 0) : p0 bits
  OP_CMP = 5,        // bool[i] = a[i / p0] <op> b[i / p1], p2 = op|ta<<4|tb<<6
  OP_AND = 6,        // bool[i] = a[i / p0] & b[i / p1]
  OP_OR = 7,         // bool[i] = a[i / p0] | b[i / p1]
  OP_NOT = 8,        // bool[i] = !a[i]
  OP_INSET = 9,      // bool[i] = a[i] in pool[p0 : p0 + p1], p2 = type
  OP_ANY = 10,       // bool[o] = any_k(a[(o*p0+k) / p1] & b[o*p0+k])
  OP_ALL = 11,       // bool[o] = all_k(a[(o*p0+k) / p1] | !b[o*p0+k])
  OP_COUNT = 12,     // i32[o] = sum_k(a[(o*p0+k) / p1] & b[o*p0+k])
  OP_RULE = 13,      // if a[0] and column p0 not yet violated: rule = p1
};

enum Type : int { T_BOOL = 0, T_I32 = 1, T_F32 = 2 };

enum Cmp : int { C_EQ = 0, C_NE = 1, C_LT = 2, C_LE = 3, C_GT = 4, C_GE = 5 };

constexpr int kInstrWords = 8;

__device__ __forceinline__ int load_int(const unsigned char* slot, int type,
                                        int i) {
  if (type == T_BOOL) return slot[i];
  return reinterpret_cast<const int*>(slot)[i];
}

__device__ __forceinline__ float load_float(const unsigned char* slot,
                                            int type, int i) {
  if (type == T_BOOL) return static_cast<float>(slot[i]);
  if (type == T_F32) return reinterpret_cast<const float*>(slot)[i];
  // int32 -> float32 rounds to nearest, as the PyTorch and jnp promotions do
  return __int2float_rn(reinterpret_cast<const int*>(slot)[i]);
}

template <typename T>
__device__ __forceinline__ bool compare(int op, T a, T b) {
  switch (op) {
    case C_EQ: return a == b;
    case C_NE: return a != b;
    case C_LT: return a < b;
    case C_LE: return a <= b;
    case C_GT: return a > b;
    default: return a >= b;
  }
}

__global__ void policy_matrix_kernel(
    const uint8_t* __restrict__ buf, int row_width,
    const int* __restrict__ tape, const int* __restrict__ tile_start,
    const int* __restrict__ pool, const int* __restrict__ col_init,
    int width, int arena_bytes, int arena_in_smem,
    uint8_t* __restrict__ scratch, uint8_t* __restrict__ allowed_out,
    int* __restrict__ rule_out, int out_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row_bytes = (row_width + 15) & ~15;

  unsigned char* srow = smem;
  int* col_allowed = reinterpret_cast<int*>(smem + row_bytes);
  int* col_rule = col_allowed + width;
  const int col_bytes = (8 * width + 15) & ~15;
  unsigned char* arena =
      arena_in_smem
          ? smem + row_bytes + col_bytes
          : scratch + (static_cast<size_t>(tile) * gridDim.x + row) *
                          static_cast<size_t>(arena_bytes);

  // stage the packed row
  const uint8_t* grow = buf + static_cast<size_t>(row) * row_width;
  if ((row_width & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(grow);
    uint4* dst = reinterpret_cast<uint4*>(srow);
    for (int i = tid; i < row_width / 16; i += nthreads) dst[i] = src[i];
  } else {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(grow);
    uint32_t* dst = reinterpret_cast<uint32_t*>(srow);
    for (int i = tid; i < row_width / 4; i += nthreads) dst[i] = src[i];
  }
  for (int k = tid; k < width; k += nthreads) {
    const int* init = col_init + 2 * (tile * width + k);
    col_allowed[k] = init[0];
    col_rule[k] = init[1];
  }
  __syncthreads();

  const int end = tile_start[tile + 1];
  for (int pc = tile_start[tile]; pc < end; ++pc) {
    const int* ins = tape + static_cast<size_t>(pc) * kInstrWords;
    const int op = __ldg(ins + 0);
    const int d = __ldg(ins + 1);
    const int a = __ldg(ins + 2);
    const int b = __ldg(ins + 3);
    const int n = __ldg(ins + 4);
    const int p0 = __ldg(ins + 5);
    const int p1 = __ldg(ins + 6);
    const int p2 = __ldg(ins + 7);
    unsigned char* dst = arena + d;
    const unsigned char* sa = arena + a;
    const unsigned char* sb = arena + b;
    switch (op) {
      case OP_LOAD_BIT:
        for (int i = tid; i < n; i += nthreads) {
          const int bit = p0 + i;
          dst[i] = (srow[bit >> 3] >> (bit & 7)) & 1;
        }
        break;
      case OP_LOAD_U8:
        for (int i = tid; i < n; i += nthreads) dst[i] = srow[p0 + i] != 0;
        break;
      case OP_LOAD_U16:
        for (int i = tid; i < n; i += nthreads) {
          const unsigned char* p = srow + p0 + 2 * i;
          reinterpret_cast<int*>(dst)[i] = p[0] | (p[1] << 8);
        }
        break;
      case OP_LOAD_W32:
        for (int i = tid; i < n; i += nthreads)
          reinterpret_cast<int*>(dst)[i] =
              reinterpret_cast<const int*>(srow + p0)[i];
        break;
      case OP_CONST:
        if (tid == 0) {
          if (p1 == T_BOOL)
            dst[0] = p0 != 0;
          else
            reinterpret_cast<int*>(dst)[0] = p0;
        }
        break;
      case OP_CMP: {
        const int cop = p2 & 15, ta = (p2 >> 4) & 3, tb = (p2 >> 6) & 3;
        const bool fp = ta == T_F32 || tb == T_F32;
        for (int i = tid; i < n; i += nthreads) {
          const int ia = i / p0, ib = i / p1;
          dst[i] = fp ? compare(cop, load_float(sa, ta, ia),
                                load_float(sb, tb, ib))
                      : compare(cop, load_int(sa, ta, ia),
                                load_int(sb, tb, ib));
        }
        break;
      }
      case OP_AND:
        for (int i = tid; i < n; i += nthreads)
          dst[i] = sa[i / p0] & sb[i / p1];
        break;
      case OP_OR:
        for (int i = tid; i < n; i += nthreads)
          dst[i] = sa[i / p0] | sb[i / p1];
        break;
      case OP_NOT:
        for (int i = tid; i < n; i += nthreads) dst[i] = !sa[i];
        break;
      case OP_INSET:
        for (int i = tid; i < n; i += nthreads) {
          bool hit = false;
          if (p2 == T_F32) {
            const float v = load_float(sa, T_F32, i);
            for (int k = 0; k < p1; ++k)
              hit |= v == __int_as_float(__ldg(pool + p0 + k));
          } else {
            const int v = load_int(sa, p2, i);
            for (int k = 0; k < p1; ++k) hit |= v == __ldg(pool + p0 + k);
          }
          dst[i] = hit;
        }
        break;
      case OP_ANY:
      case OP_ALL:
      case OP_COUNT:
        for (int o = tid; o < n; o += nthreads) {
          int acc = op == OP_ALL ? 1 : 0;
          for (int k = 0; k < p0; ++k) {
            const int j = o * p0 + k;
            const int pv = sa[j / p1];
            const int m = sb[j];
            if (op == OP_ANY)
              acc |= pv & m;
            else if (op == OP_ALL)
              acc &= pv | !m;
            else
              acc += pv & m;
          }
          if (op == OP_COUNT)
            reinterpret_cast<int*>(dst)[o] = acc;
          else
            dst[o] = acc;
        }
        break;
      case OP_RULE:
        if (tid == 0 && sa[0] && col_allowed[p0]) {
          col_allowed[p0] = 0;
          col_rule[p0] = p1;
        }
        break;
      default:
        break;
    }
    __syncthreads();
  }

  const size_t out_row = static_cast<size_t>(row) * out_cols + tile * width;
  for (int k = tid; k < width; k += nthreads) {
    allowed_out[out_row + k] = static_cast<uint8_t>(col_allowed[k] != 0);
    rule_out[out_row + k] = col_rule[k];
  }
}

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// Launches policy_matrix_kernel on `stream`; returns cudaGetLastError().
int pm_policy_matrix(const void* buf, int batch, int row_width,
                     const void* tape, const void* tile_start,
                     const void* pool, const void* col_init, int n_tiles,
                     int width, int arena_bytes, int arena_in_smem,
                     void* scratch, void* allowed_out, void* rule_out,
                     int threads, int smem_bytes, void* stream) {
  static int smem_attr = 48 * 1024;
  if (smem_bytes > smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        policy_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_attr = smem_bytes;
  }
  dim3 grid(batch, n_tiles);
  policy_matrix_kernel<<<grid, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), row_width,
      static_cast<const int*>(tape), static_cast<const int*>(tile_start),
      static_cast<const int*>(pool), static_cast<const int*>(col_init), width,
      arena_bytes, arena_in_smem, static_cast<uint8_t*>(scratch),
      static_cast<uint8_t*>(allowed_out), static_cast<int*>(rule_out),
      n_tiles * width);
  return static_cast<int>(cudaGetLastError());
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
