// Table-batched embedding bag (K6) for Hopper (sm_90a):
//   out[b, t] = sum_l table_t[idx[b, t, l]]
// for T tables of one width D and one dtype (float32, or bfloat16 widened
// exactly), ids (B, T, L) int32 given by three strides, and out (B, T, D)
// float32 given by a bag stride and a field stride.  One launch covers
// up to kMaxTables tables; the wrapper splits more into launches of the
// same kernel.  A single table is the T = 1 call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embed_bag/kernel.py:34
// (embedding_bag): there a sequential (B, L) grid streams one row a step
// into a revisited output block, zeroed at l = 0, one table a call.  The
// reference's one-device DLRM lookup stacks a take per field, which XLA
// fuses into one program under jit; here the whole lookup is one launch.
// The sum runs in l order from zero, each add __fadd_rn:
// acc = ((0 + r0) + r1) + ..., the Pallas grid's order and the plain
// version's, so the kernel and the plain version agree bit for bit.
//
// Bound: device-memory bytes.  Per table it reads B L rows of D elements
// and B L int32 ids and writes B D floats: T (B L D elem + B L 4 + B D 4)
// bytes, with no arithmetic to speak of.  At DLRM-RM2's training lookup
// (T 26, B 65,536, L 1, D 64 float32) that is 879.2 MB, 0.262 ms at
// 3.35 TB/s.  A row that several bags look up is read from memory once
// at best (the small tables stay in the L2), so the least the card can
// move is each table's distinct rows, the ids and the sums: about 603
// MB, 0.180 ms, of which the (B, T, D) sums are 436 MB.  Rows are scattered,
// each its own 16-byte-aligned stream of D elem bytes; the card needs
// about 2.4 MB in flight (3.35 TB/s times a ~0.7 us latency) at its rate.
//
// Design (bags_kernel):
// - The tables' descriptors (base, row stride, flags) come by value in a
//   __grid_constant__ parameter (64 x 24 B of the 4 KB parameter space):
//   no host-to-device copy, allocation or sync per call.  Each block
//   copies them to shared memory once.
// - A persistent grid: as many blocks as fit on the SMs at once (read
//   once per instantiation from cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//   striding over units.  A unit is kRows x (kThreads / tpr) consecutive
//   (bag, field) pairs in bag-major order, so its ids are one coalesced
//   block of the (B, T) id matrix and its output one contiguous region of
//   the (B, T, D) result.
// - A group of tpr lanes (a power of two, the least that covers the row
//   in 16-byte pieces, at most 32: 16 for a float32 row of 64) takes one
//   pair; each lane holds kRows pairs of the unit.  Every row of a lane's
//   kRows is loaded before the first add, and the ids of the next step
//   (the next l, or the block's next unit) are loaded while those rows
//   are in flight, so the id -> row dependency is paid once per block,
//   not once per row.  At D 64 float32 a lane keeps 4 x 16 B in flight,
//   a block of 256 lanes 16 KB.
// - The sums leave with streaming stores (st.global.cs).
// scripts/torch_k6_variants.py times the choices side by side: 8 pairs a
// lane, plain stores, and a kernel that moves each row global -> shared
// -> global with TMA bulk copies on an mbarrier ring; each was slower at
// the lookup (PERF.md).
// Pieces are 16 bytes (four float32 or eight bfloat16) when every
// table's base, row stride and row width and the output allow it (the
// wrapper checks), else 8 bytes (D = 18 or 50 float32: 9 and 25 pieces),
// else one element (an unaligned view).  Ids are not range checked:
// in-range ids are the caller's contract, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

namespace {

constexpr int kMaxTables = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // pairs a lane holds in flight

// One table: row r, column c at base + r * ld + c (elements).
struct Table {
  const void* base;
  long long ld;
  int flags;  // kBf16 | kPiece8 or kPiece16
  int pad;
};
static_assert(sizeof(Table) == 24, "the descriptor layout is shared with ops.py");
constexpr int kBf16 = 1, kPiece8 = 2, kPiece16 = 4;

struct Tables {
  Table t[kMaxTables];
};

template <typename T, int VEC>
struct Piece;

// One element.
template <>
struct Piece<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void add(const Raw& r, float* acc) {
    acc[0] = __fadd_rn(acc[0], r);
  }
};

template <>
struct Piece<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw load(const __nv_bfloat16* p) { return *p; }
  __device__ static void add(const Raw& r, float* acc) {
    acc[0] = __fadd_rn(acc[0], __bfloat162float(r));
  }
};

// Two float32 in one 8-byte load.
template <>
struct Piece<float, 2> {
  using Raw = float2;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static void add(const Raw& r, float* acc) {
    acc[0] = __fadd_rn(acc[0], r.x);
    acc[1] = __fadd_rn(acc[1], r.y);
  }
};

// Four float32 in one 16-byte load.
template <>
struct Piece<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void add(const Raw& r, float* acc) {
    acc[0] = __fadd_rn(acc[0], r.x);
    acc[1] = __fadd_rn(acc[1], r.y);
    acc[2] = __fadd_rn(acc[2], r.z);
    acc[3] = __fadd_rn(acc[3], r.w);
  }
};

// Pairs of bfloat16 packed in 32-bit words, widened (exactly) and added.
template <int N>
__device__ __forceinline__ void add_bf16_words(const uint32_t (&w)[N],
                                               float* acc) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    __nv_bfloat162 pair;
    memcpy(&pair, &w[i], 4);
    const float2 f = __bfloat1622float2(pair);
    acc[2 * i] = __fadd_rn(acc[2 * i], f.x);
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], f.y);
  }
}

// Four bfloat16 in one 8-byte load.
template <>
struct Piece<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static void add(const Raw& r, float* acc) {
    add_bf16_words<2>({r.x, r.y}, acc);
  }
};

// Eight bfloat16 in one 16-byte load.
template <>
struct Piece<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(const Raw& r, float* acc) {
    add_bf16_words<4>({r.x, r.y, r.z, r.w}, acc);
  }
};

// A streaming store (st.global.cs): the sums are written once and read
// by the next kernel, so they are first out of the L2, before the rows of
// the small tables that later bags look up again.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  __stcs(p, v[0]);
}

struct Args {
  const int* idx;
  long long sb, st, sl;  // id (b, t, l) at idx[b sb + t st + l sl]
  float* out;
  long long sob, sot;  // out (b, t, :) at out + b sob + t sot
  unsigned n_bags, n_tables, n_pairs, n_units;
  int n_len, chunks, tpr;
};

// The bag and field of each of a lane's kRows pairs in `unit` (bag -1
// past the last pair), and their ids at step l.
__device__ __forceinline__ void pairs_of(const Args& a, unsigned unit,
                                         unsigned slot, unsigned slots,
                                         int (&bag)[kRows],
                                         int (&field)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const unsigned p = unit * (slots * kRows) + k * slots + slot;
    const bool in = p < a.n_pairs;
    const unsigned b = in ? p / a.n_tables : 0u;
    bag[k] = in ? (int)b : -1;
    field[k] = in ? (int)(p - b * a.n_tables) : 0;
  }
}

__device__ __forceinline__ void ids_of(const Args& a, const int (&bag)[kRows],
                                       const int (&field)[kRows], int l,
                                       int (&id)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    id[k] = bag[k] >= 0 ? __ldg(a.idx + bag[k] * a.sb + field[k] * a.st +
                                (long long)l * a.sl)
                        : 0;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    bags_kernel(__grid_constant__ const Tables tabs, const Args a) {
  using P = Piece<T, VEC>;
  __shared__ Table sh[kMaxTables];
  for (unsigned i = threadIdx.x; i < a.n_tables; i += kThreads)
    sh[i] = tabs.t[i];
  __syncthreads();
  const unsigned slot = threadIdx.x / a.tpr, slots = kThreads / a.tpr;
  const int lane = threadIdx.x & (a.tpr - 1);
  for (int j0 = 0; j0 < a.chunks; j0 += a.tpr) {
    const int j = j0 + lane;
    const bool piece = j < a.chunks;
    int bag[kRows], field[kRows], id[kRows];
    unsigned unit = blockIdx.x;
    if (unit < a.n_units) {
      pairs_of(a, unit, slot, slots, bag, field);
      if (a.n_len > 0) ids_of(a, bag, field, 0, id);
    }
    for (; unit < a.n_units; unit += gridDim.x) {
      float acc[kRows][VEC];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = 0.0f;
      int cur_bag[kRows], cur_field[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        cur_bag[k] = bag[k];
        cur_field[k] = field[k];
      }
      for (int l = 0; l < a.n_len; ++l) {
        typename P::Raw raw[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          if (cur_bag[k] >= 0 && piece) {
            const Table& tb = sh[cur_field[k]];
            raw[k] = P::load(static_cast<const T*>(tb.base) +
                             (long long)id[k] * tb.ld + (long long)j * VEC);
          }
        // The next step's ids, while the rows are in flight.
        if (l + 1 < a.n_len) {
          ids_of(a, cur_bag, cur_field, l + 1, id);
        } else if (unit + gridDim.x < a.n_units) {
          pairs_of(a, unit + gridDim.x, slot, slots, bag, field);
          ids_of(a, bag, field, 0, id);
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          if (cur_bag[k] >= 0 && piece) P::add(raw[k], acc[k]);
      }
      if (a.n_len == 0 && unit + gridDim.x < a.n_units)
        pairs_of(a, unit + gridDim.x, slot, slots, bag, field);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (cur_bag[k] < 0 || !piece) continue;
        float* o = a.out + cur_bag[k] * a.sob + cur_field[k] * a.sot +
                   (long long)j * VEC;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int v = 0; v < VEC; v += 4)
            store4(o + v, make_float4(acc[k][v], acc[k][v + 1],
                                      acc[k][v + 2], acc[k][v + 3]));
        } else {
          store(o, acc[k]);
        }
      }
    }
  }
}

// Blocks of `kernel` resident on the card at once (kernel, threads and
// shared memory fixed), read once.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (per_sm > 0 ? per_sm : 1) * sms;
}

template <typename T, int VEC>
void launch(const Tables& tabs, Args a, cudaStream_t s) {
  a.chunks /= VEC;
  a.tpr = 1;
  while (a.tpr < a.chunks && a.tpr < 32) a.tpr *= 2;
  const unsigned per_unit = (kThreads / a.tpr) * kRows;
  a.n_units = (a.n_pairs + per_unit - 1) / per_unit;
  static const int blocks = resident_blocks(bags_kernel<T, VEC>, kThreads, 0);
  const unsigned grid = min(a.n_units, (unsigned)blocks);
  bags_kernel<T, VEC><<<grid, kThreads, 0, s>>>(tabs, a);
}

}  // namespace

// tables: host array of n_tables (1..64) descriptors {base, ld, flags},
// the flags (kBf16, and kPiece8 or kPiece16 for 8- or 16-byte pieces)
// alike in all of them (the wrapper makes sure), rows with a unit column
// stride; idx: int32, element (b, t, l) at
// idx[b sb + t st + l sl]; out: float32, (b, t, :) at out + b sob + t sot,
// D contiguous.  B n_tables < 2^31.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int embed_bags(const void* tables, int n_tables, const void* idx,
                          long long sb, long long st, long long sl,
                          long long n_bags, int n_len, int d, void* out,
                          long long sob, long long sot, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || n_bags < 0 || n_len < 0 ||
      d < 0 || n_bags * n_tables >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Tables tabs;
  std::memcpy(tabs.t, tables, sizeof(Table) * n_tables);
  const int flags = tabs.t[0].flags;
  for (int i = 1; i < n_tables; ++i)
    if (tabs.t[i].flags != flags) return (int)cudaErrorInvalidValue;
  if (n_bags == 0 || d == 0) return (int)cudaGetLastError();
  Args a{static_cast<const int*>(idx), sb, st, sl,
         static_cast<float*>(out), sob, sot,
         (unsigned)n_bags, (unsigned)n_tables,
         (unsigned)(n_bags * n_tables), 0u, n_len, d, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flags) {
    case 0: launch<float, 1>(tabs, a, s); break;
    case kPiece8: launch<float, 2>(tabs, a, s); break;
    case kPiece16: launch<float, 4>(tabs, a, s); break;
    case kBf16: launch<__nv_bfloat16, 1>(tabs, a, s); break;
    case kBf16 | kPiece8: launch<__nv_bfloat16, 4>(tabs, a, s); break;
    case kBf16 | kPiece16: launch<__nv_bfloat16, 8>(tabs, a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
