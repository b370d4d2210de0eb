// Sliding-window trim cuts on Hopper: the whole device step of `sickle se`
// in one launch.
//
// Replaces sickle_tpu/ops/trim_pallas.py::_trim_kernel (generic ragged
// rows), ::_trim_kernel_noseq (the same without the -n seq operand),
// ::_trim_kernel_uniform and ::_trim_kernel_uniform_noseq (static window
// for uniform-length chunks), and fuses the XLA programs that wrap them on
// the JAX path (sickle_tpu/engine/pipeline.py, _tpu_cuts_fn): derive_lengths
// (read length = first zero value of the row) and the wire decoders
// sickle_tpu/ops/trim.py::decode_fields (the field wire) and ::apply_rank_lut
// (the rank wire) as the load prologue, and encode (one int32 per read) as
// the epilogue.  The math is that of sickle_tpu_torch/ops/trim.py
// (compute_cuts for raw rows, wire_codes for the wires), the plain versions
// this kernel is held against (bit-exact, int32 two's-complement sums).
//
// The work: a 150 bp read brings ~152 B of raw quality row in (114 B on
// the 6-bit field wire, 57 B on the 3-bit rank wire; plus 152 B of seq
// under -n) and sends 4 B out.  HBM would move a 65,536-row batch in ~3
// us; the cut math takes ~20x that, because each 32 window starts cost a
// warp ~100 instructions (two 5-step shuffle scans, two ballots, the
// window tests), so what bounds the kernel on the H100 is the warp
// scans' instructions, not bytes.  The load path's job is to stay out of
// their way: each input byte leaves HBM once, in bulk, and a wire
// position is unpacked once, not at each of its three or four reads.  Two
// kernels share the cut math; ops/trim_cuda.py::tile_rows picks one by
// shape.
//
// * The tiled kernel (rows that fit a shared-memory tile: every main-path
//   shape).  Block k owns tile k, R consecutive rows (R a multiple of 8,
//   chosen by the wrapper: 24 for short reads).  Each of its 8 warps owns
//   R / 8 consecutive rows, one contiguous byte range of device memory,
//   and copies it into its own part of shared memory with 16-byte
//   cp.async copies; the head and tail off a 16-byte boundary (wire rows
//   are 19-114 B, and a view may start anywhere) move as single bytes,
//   and no load reaches past the tensor.  On the BAND and RANK wires the
//   warp then expands its rows to one byte per position, the wire's value
//   v (0 for padding), reading each wire byte once.  The cut math reads
//   the staged rows with plain shared-memory loads (by offset into the
//   dynamic shared array).  Warps synchronise only within themselves, so
//   none waits for another's rows; eight blocks per SM (32 registers)
//   hide the copies behind other warps' scans.  (A grid of resident
//   blocks that prefetches tile t+1 while cutting tile t, and tiles of 64
//   rows, measured slower: the scans leave no latency for a software
//   pipeline to hide, and larger tiles leave a longer tail per launch.)
// * The direct kernel (rows too long for a tile: the 50 kbp rows).  One
//   warp per row, 8 rows per block, every read of a position goes to
//   device memory (L1) through one accessor that decodes it there, so
//   shared memory stays at zero at every L.
// * No prefix array is materialized.  The TPU kernels build the whole
//   D[j] = C[j] - t*j row in VMEM and shift it by the window w.  Here two
//   running warp scans advance in lockstep, one at the window start i and
//   one at i + w, so D[i] and D[i+w] are both in registers for a 32-wide
//   stride of window starts.  A 50 kbp row needs no 200 KB D array.
// * Every "first index" (length, 5' trigger, 3' trigger, 5' cut, 3' cut,
//   N/n) is a ballot plus __ffs over 32-wide strides with early exit, so a
//   read whose 3' trigger fires early stops there.
// * The bad-quality flag covers the whole read (any out-of-range char, not
//   only those the scan touches); the host re-derives scalar semantics for
//   flagged rows, as on the JAX path.  On the wires the flag is 0: the host
//   proved every char of the chunk in range before it chose one.
//
// Built with nvcc into a plain C ABI shared library (no PyTorch headers)
// and called through ctypes from sickle_tpu_torch/ops/trim_cuda.py.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps per block, in both kernels
constexpr int kThreads = kRowsPerBlock * kWarp;
constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kAll = 0xffffffffu;

// The row's source form.
constexpr int kRaw = 0;   // raw ASCII qualities, zero padded
constexpr int kBand = 1;  // field wire of v = q - bias (io/fastq.qual_fields)
constexpr int kRank = 2;  // field wire of v = 1 + rank (qual_rank_fields)

struct Args {
  const uint8_t* seq;      // [B, L], read only under TRUNC_N
  const uint8_t* qual;     // [B, row_bytes]: raw rows, or the wire's rows
  const int32_t* lengths;  // [B] explicit read lengths, or null: derive
  int32_t* out;            // [B] packed codes, or [3, B] (five, three, flag)
  long long B;
  int L;                   // read positions per row
  int row_bytes;           // L for raw rows, p * L / 8 on a wire
  int offset, qmin, qmax;  // the encoding
  int t, lthr;             // -q, -l
  int fork_order;          // -n looks for 'n' before 'N'
  int uniform_w;           // UNIFORM: the shared window size
  // the wire's subfields (io/fastq.field_widths), at most three
  int n_fields;
  int f_log2w[3];          // log2 of the field's width in bits (4, 2, 1)
  int f_shift[3];          // the field's bit offset in v
  int f_col[3];            // the field's first byte in the wire row
  int bias;                // BAND: q = v + bias
  unsigned long long lut;  // RANK: q = byte v of lut, as a signed char
  int tile_rows;           // rows per shared-memory tile; 0: direct kernel
};

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned x, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const unsigned y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
  return x;
}

// Mask of the lanes at or above k (k may lie outside [0, 32)).
__device__ __forceinline__ unsigned lanes_from(int k) {
  return k <= 0 ? kAll : (k >= kWarp ? 0u : (kAll << k));
}

// What the row holds at position j, 0 for padding: the raw char, or the
// wire's v, ORed together from its subfields.  A field of width w keeps
// 8 / w positions per byte, lowest position in the lowest bits.
template <int SRC>
__device__ __forceinline__ int value_at(const Args& a, const uint8_t* row, int j) {
  if (SRC == kRaw) return row[j];
  int v = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < a.n_fields) {
      const int lw = a.f_log2w[k];
      const int byte = row[a.f_col[k] + (j >> (3 - lw))];
      const int at = (j & ((8 >> lw) - 1)) << lw;  // (j mod 8/w) * w
      v |= ((byte >> at) & ((1 << (1 << lw)) - 1)) << a.f_shift[k];
    }
  }
  return v;
}

// The decoded quality of a non-padding value.
template <int SRC>
__device__ __forceinline__ int quality_of(const Args& a, int v) {
  if (SRC == kRaw) return v - a.offset;
  if (SRC == kBand) return v + a.bias;
  return static_cast<int>(static_cast<int8_t>(a.lut >> (8 * (v & 7))));
}

// One row as the cut math reads it: as it lies in device memory, a wire
// position decoded where it is read (the direct kernel), or STAGED in
// shared memory (Row<SRC, true>, below).
template <int SRC, bool STAGED>
struct Row {
  const uint8_t* p;
  __device__ __forceinline__ int value(const Args& a, int j) const {
    return value_at<SRC>(a, p, j);
  }
};

extern __shared__ __align__(16) uint8_t tile_smem[];

// A staged row, `off` bytes into the tiled kernel's shared memory: byte j
// is the value at position j (the raw char, or the wire's v decoded once
// per tile).
template <int SRC>
struct Row<SRC, true> {
  unsigned off;
  __device__ __forceinline__ int value(const Args&, int j) const {
    return tile_smem[off + j];
  }
};

// First j in [from, len) with pred(j), else kBig.
template <class Pred>
__device__ __forceinline__ int first_from(int from, int len, int lane, Pred pred) {
  for (int s = from & ~(kWarp - 1); s < len; s += kWarp) {
    const int j = s + lane;
    const unsigned m = __ballot_sync(kAll, j >= from && j < len && pred(j));
    if (m) return s + __ffs(m) - 1;
  }
  return kBig;
}

// The cuts of one non-empty read; returns false when it is discarded.
template <int SRC, bool UNIFORM, bool TRUNC_N, bool NO_FIVE, bool STAGED>
__device__ __forceinline__ bool row_cuts(const Args& a, Row<SRC, STAGED> qrow,
                                         Row<kRaw, STAGED> srow, int len,
                                         int lane, int& five, int& three) {
  const int t = a.t;
  const int w = UNIFORM ? a.uniform_w : (len / 10 > 0 ? len / 10 : len);
  const int last = len - w;  // last window start: i + w <= len

  // decoded quality at j < len; 0 past the read's end (as the sums see it)
  auto q_of = [&](int j) -> int {
    return quality_of<SRC>(a, qrow.value(a, j));
  };
  auto q_at = [&](int j) -> unsigned {
    return j < len ? static_cast<unsigned>(q_of(j)) : 0u;
  };

  // Running exclusive prefixes C[b] (window starts) and C[b + w] (window
  // ends) for the stride of window starts i = b + lane.  Unsigned sums
  // wrap like the int32 reference.
  unsigned c_start = 0;
  unsigned c_end = 0;
  for (int j = lane; j < w; j += kWarp) c_end += q_at(j);
  c_end = warp_sum(c_end);

  int i5 = NO_FIVE ? 0 : kBig;  // -x: the 3' trigger is searched from 0
  int i3 = kBig;
  for (int b = 0; b <= last; b += kWarp) {
    const int i = b + lane;
    const unsigned qs = q_at(i);
    const unsigned qe = q_at(i + w);
    const unsigned ss = warp_inclusive_sum(qs, lane);
    const unsigned se = warp_inclusive_sum(qe, lane);
    // D[j] = C[j] - t*j; the window at i has average >= t iff D[i+w] >= D[i]
    const int d_start = static_cast<int>(c_start + ss - qs -
                                         static_cast<unsigned>(t) * static_cast<unsigned>(i));
    const int d_end = static_cast<int>(c_end + se - qe -
                                       static_cast<unsigned>(t) * static_cast<unsigned>(i + w));
    const bool valid = i <= last;
    const unsigned hi = __ballot_sync(kAll, valid && d_end >= d_start);
    const unsigned lo = __ballot_sync(kAll, valid && d_end < d_start);
    if (!NO_FIVE && i5 == kBig && hi) i5 = b + __ffs(hi) - 1;
    if (i5 != kBig) {
      const unsigned m = lo & lanes_from(i5 - b);
      if (m) {
        i3 = b + __ffs(m) - 1;
        break;
      }
    }
    c_start += __shfl_sync(kAll, ss, kWarp - 1);
    c_end += __shfl_sync(kAll, se, kWarp - 1);
  }
  if (!NO_FIVE && i5 == kBig) return false;  // no 5' trigger: discard

  // 5' cut: first position >= i5 with q >= t
  five = 0;
  if (!NO_FIVE) {
    five = min(first_from(i5, len, lane, [&](int j) { return q_of(j) >= t; }), len);
  }
  // 3' cut: first position >= i3 with q < t; the read end if no trigger
  three = len;
  if (i3 != kBig) {
    three = min(first_from(i3, len, lane, [&](int j) { return q_of(j) < t; }), len);
  }
  // -n: truncate to the base before the first N ('N' then 'n' for 1.33,
  // 'n' then 'N' for the fork); an N at position 0 gives three = -1
  if (TRUNC_N) {
    int up = kBig, low = kBig;
    for (int s = 0; s < len; s += kWarp) {
      const int j = s + lane;
      const int c = j < len ? srow.value(a, j) : 0;
      const unsigned mu = __ballot_sync(kAll, c == 'N');
      const unsigned ml = __ballot_sync(kAll, c == 'n');
      if (up == kBig && mu) up = s + __ffs(mu) - 1;
      if (low == kBig && ml) low = s + __ffs(ml) - 1;
      if (a.fork_order ? low != kBig : up != kBig) break;
    }
    const int nidx = a.fork_order ? (low != kBig ? low : up)
                                  : (up != kBig ? up : low);
    if (nidx != kBig) three = nidx - 1;
  }
  return len >= a.lthr && three - five >= a.lthr;
}

// One row, by one warp: its length and bad flag, its cuts, its code.
template <int SRC, bool UNIFORM, bool TRUNC_N, bool NO_FIVE, bool PACKED, bool STAGED>
__device__ __forceinline__ void cut_row(const Args& a, Row<SRC, STAGED> qrow,
                                        Row<kRaw, STAGED> srow, long long row,
                                        int lane) {
  const int L = a.L;

  // 1. the read's length, and whether any char inside it is out of range
  int len = L;
  bool bad = false;
  if (SRC == kRaw && a.lengths != nullptr) {
    len = min(max(a.lengths[row], 0), L);
    for (int j = lane; j < len; j += kWarp) {
      const int c = qrow.value(a, j);
      bad |= c < a.qmin || c > a.qmax;
    }
  } else {
    for (int s = 0; s < L; s += kWarp) {
      const int j = s + lane;
      // lanes past the row read as padding
      const int c = j < L ? qrow.value(a, j) : 0;
      const unsigned z = __ballot_sync(kAll, c == 0);
      const int end = z ? s + __ffs(z) - 1 : s + kWarp;
      if (SRC == kRaw && j < end) bad |= c < a.qmin || c > a.qmax;
      if (z) {
        len = end;
        break;
      }
    }
  }
  const int flag = __any_sync(kAll, bad) ? 1 : 0;

  // 2. the cuts; padding rows (len 0) are always discarded
  int five = -1, three = -1;
  if (len == 0 || !row_cuts<SRC, UNIFORM, TRUNC_N, NO_FIVE, STAGED>(
                      a, qrow, srow, len, lane, five, three)) {
    five = -1;
    three = -1;
  }

  // 3. the per-read code
  if (lane == 0) {
    if (PACKED) {
      a.out[row] = ((five + 1) << 16) | (flag << 15) | (three + 1);
    } else {
      a.out[row] = five;
      a.out[a.B + row] = three;
      a.out[2 * a.B + row] = flag;
    }
  }
}

// The direct kernel: one warp per row, rows read in device memory.
template <int SRC, bool UNIFORM, bool TRUNC_N, bool NO_FIVE, bool PACKED>
__global__ void __launch_bounds__(kThreads)
trim_cuts_kernel(const Args a) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= a.B) return;  // the whole warp leaves together
  const Row<SRC, false> qrow{a.qual + row * a.row_bytes};
  const Row<kRaw, false> srow{TRUNC_N ? a.seq + row * a.L : nullptr};
  cut_row<SRC, UNIFORM, TRUNC_N, NO_FIVE, PACKED>(a, qrow, srow, row, lane);
}

// ---- the tiled kernel ----

// Bytes of a stage for `rows` rows of `row_bytes`: the rows, the up to 15
// bytes by which their start lies past a 16-byte boundary, rounded up to
// 16.
__host__ __device__ __forceinline__ int stage_bytes(int rows, int row_bytes) {
  return (rows * row_bytes + 30) / 16 * 16;
}

// Shared memory of one warp of the tiled kernel, for its R / 8 rows of a
// tile: the quality rows as they lie in device memory, under TRUNC_N the
// seq rows, on a wire the rows decoded (ops/trim_cuda.py::tile_smem_bytes
// mirrors this, times the 8 warps of a block).
__host__ __device__ __forceinline__ int warp_smem(const Args& a, bool trunc_n,
                                                  bool wire) {
  const int rows = a.tile_rows / kRowsPerBlock;
  return stage_bytes(rows, a.row_bytes) + (trunc_n ? stage_bytes(rows, a.L) : 0) +
         (wire ? (rows * a.L + 15) / 16 * 16 : 0);
}

__device__ __forceinline__ void cp_async16(unsigned at, uintptr_t gmem) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(tile_smem + at));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy the device bytes [g0, g1) into shared memory, address x to offset
// at + (x - (g0 & ~15)), by the 32 lanes of a warp: the 16-byte aligned
// interior with cp.async; the unaligned head (before the first 16-byte
// boundary, or all of the range if it crosses none) and tail (after the
// last boundary), at most 15 bytes each, as single bytes, one per lane.
// Nothing outside [g0, g1) is read.  The caller waits for the copies.
__device__ __forceinline__ void stage_range(unsigned at, uintptr_t g0,
                                            uintptr_t g1, int lane) {
  const uintptr_t a0 = g0 & ~uintptr_t(15);
  const uintptr_t up = (g0 + 15) & ~uintptr_t(15);
  const uintptr_t m0 = up < g1 ? up : g1;      // head: [g0, m0)
  const uintptr_t down = g1 & ~uintptr_t(15);
  const uintptr_t m1 = down > m0 ? down : m0;  // tail: [m1, g1)
  for (uintptr_t c = m0 + 16 * static_cast<uintptr_t>(lane); c < m1;
       c += 16 * kWarp) {
    cp_async16(at + static_cast<unsigned>(c - a0), c);
  }
  const int nh = static_cast<int>(m0 - g0);
  if (lane < nh + static_cast<int>(g1 - m1)) {
    const uintptr_t x = lane < nh ? g0 + lane : m1 + (lane - nh);
    tile_smem[at + static_cast<unsigned>(x - a0)] =
        *reinterpret_cast<const uint8_t*>(x);
  }
}

// Expand n staged wire rows (at `src`) to one byte per position at `dec`,
// the value v (0 for padding), by the 32 lanes of a warp: each lane takes
// 8 positions of a row at a time, whose subfields fill whole bytes (a
// field of width w holds 8 positions in w bytes), so each wire byte is
// read once.  The byte is v, not q: on the rank wire q may be any signed
// byte (the LUT is the caller's), so no value of q is free to mark
// padding; q = v + bias or the LUT's byte v costs one or two
// instructions at each read.
__device__ __forceinline__ void decode_rows(const Args& a, unsigned src,
                                            unsigned dec, int n, int lane) {
  const int groups = a.L >> 3;  // L % 8 == 0 on a wire
  for (int k = lane; k < n * groups; k += kWarp) {
    const int r = k / groups;
    const int g = k - r * groups;
    const unsigned row = src + r * a.row_bytes;
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if (f < a.n_fields) {
        const int w = 1 << a.f_log2w[f];  // bits per position = bytes per 8
        const unsigned p = row + a.f_col[f] + g * w;
        unsigned x = 0;
        for (int b = 0; b < w; ++b) {
          x |= static_cast<unsigned>(tile_smem[p + b]) << (8 * b);
        }
        const unsigned mask = (1u << w) - 1;
        const int sh = a.f_shift[f];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo |= ((x >> (i * w)) & mask) << (sh + 8 * i);
          hi |= ((x >> ((i + 4) * w)) & mask) << (sh + 8 * i);
        }
      }
    }
    *reinterpret_cast<uint2*>(tile_smem + dec + r * a.L + 8 * g) =
        make_uint2(lo, hi);
  }
}

// The tiled kernel: rows staged in shared memory (see the file header).
// Block k holds tile k, rows [k * R, k * R + R); warp w stages and cuts
// its R / 8 consecutive rows of it in its own part of shared memory
// (warp_smem), so warps synchronise only within themselves and no warp
// waits for another's rows.  Eight blocks per SM (64 warps) need at most
// 32 registers a thread, which every form fits without spilling.
template <int SRC, bool UNIFORM, bool TRUNC_N, bool NO_FIVE>
__global__ void __launch_bounds__(kThreads, 8)
trim_cuts_tiled(const Args a) {
  constexpr bool kWire = SRC != kRaw;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int rows = a.tile_rows / kRowsPerBlock;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * a.tile_rows + warp * rows;
  if (row0 >= a.B) return;  // the whole warp leaves together
  const int n = static_cast<int>(min(static_cast<long long>(rows), a.B - row0));

  // this warp's part: its quality rows, its seq rows, its decoded rows
  const unsigned q_at = warp * warp_smem(a, TRUNC_N, kWire);
  const unsigned s_at = q_at + stage_bytes(rows, a.row_bytes);
  const unsigned d_at = s_at + (TRUNC_N ? stage_bytes(rows, a.L) : 0);
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(a.qual) + row0 * a.row_bytes;
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(a.seq) + row0 * a.L;
  stage_range(q_at, g0, g0 + static_cast<uintptr_t>(n) * a.row_bytes, lane);
  if (TRUNC_N) stage_range(s_at, s0, s0 + static_cast<uintptr_t>(n) * a.L, lane);
  cp_async_commit_and_wait_all();
  __syncwarp();

  const unsigned qrows = q_at + static_cast<unsigned>(g0 & 15);
  const unsigned srows = s_at + static_cast<unsigned>(s0 & 15);
  if (kWire) {
    decode_rows(a, qrows, d_at, n, lane);
    __syncwarp();
  }
  for (int r = 0; r < n; ++r) {
    const Row<SRC, true> qrow{kWire ? d_at + r * a.L : qrows + r * a.row_bytes};
    cut_row<SRC, UNIFORM, TRUNC_N, NO_FIVE, true>(
        a, qrow, Row<kRaw, true>{srows + r * a.L}, row0 + r, lane);
  }
}

template <int SRC, int V>
void launch(const Args& a, cudaStream_t stream) {
  constexpr bool kUniform = (V & 1) != 0, kTruncN = (V & 2) != 0;
  constexpr bool kNoFive = (V & 4) != 0, kPacked = (V & 8) != 0;
  if (a.tile_rows == 0) {
    const long long blocks = (a.B + kRowsPerBlock - 1) / kRowsPerBlock;
    trim_cuts_kernel<SRC, kUniform, kTruncN, kNoFive, kPacked>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
    return;
  }
  // tiles hold packed results only (L < 32766); the entry points refuse
  // a tile for an unpacked one
  if constexpr (kPacked) {
    const long long tiles = (a.B + a.tile_rows - 1) / a.tile_rows;
    trim_cuts_tiled<SRC, kUniform, kTruncN, kNoFive>
        <<<static_cast<unsigned>(tiles), kThreads,
           kRowsPerBlock * warp_smem(a, kTruncN, SRC != kRaw), stream>>>(a);
  }
}

using LaunchFn = void (*)(const Args&, cudaStream_t);
// raw rows, indexed by uniform | trunc_n << 1 | no_five << 2 | packed << 3
const LaunchFn kLaunchRaw[16] = {
    launch<kRaw, 0>,  launch<kRaw, 1>,  launch<kRaw, 2>,  launch<kRaw, 3>,
    launch<kRaw, 4>,  launch<kRaw, 5>,  launch<kRaw, 6>,  launch<kRaw, 7>,
    launch<kRaw, 8>,  launch<kRaw, 9>,  launch<kRaw, 10>, launch<kRaw, 11>,
    launch<kRaw, 12>, launch<kRaw, 13>, launch<kRaw, 14>, launch<kRaw, 15>,
};
// the wires never carry seq (-n takes raw rows) and always pack the
// result (L < 32766); indexed by [rank][uniform | no_five << 1]
const LaunchFn kLaunchWire[2][4] = {
    {launch<kBand, 8>, launch<kBand, 9>, launch<kBand, 12>, launch<kBand, 13>},
    {launch<kRank, 8>, launch<kRank, 9>, launch<kRank, 12>, launch<kRank, 13>},
};

bool bad_tile(int tile_rows, bool packed) {
  return tile_rows < 0 || tile_rows % kRowsPerBlock != 0 || (tile_rows > 0 && !packed);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `out` ([B] int32 when packed, else [3, B]).  Explicit
// `lengths` (may be null) must lie in [0, L].  `tile_rows`: rows per
// shared-memory tile (a multiple of 8, packed results only), or 0 for the
// direct kernel; ops/trim_cuda.py::tile_rows chooses it.
extern "C" int sk_trim_cuts(const void* seq, const void* qual,
                            const void* lengths, void* out, long long B,
                            int L, int offset, int qmin, int qmax, int t,
                            int lthr, int no_five, int trunc_n, int fork_order,
                            int uniform_w, int packed, int tile_rows,
                            void* stream) {
  if (B <= 0) return 0;
  if (bad_tile(tile_rows, packed != 0)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.seq = static_cast<const uint8_t*>(seq);
  a.qual = static_cast<const uint8_t*>(qual);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = static_cast<int32_t*>(out);
  a.B = B;
  a.L = L;
  a.row_bytes = L;
  a.offset = offset;
  a.qmin = qmin;
  a.qmax = qmax;
  a.t = t;
  a.lthr = lthr;
  a.fork_order = fork_order;
  a.uniform_w = uniform_w;
  a.tile_rows = tile_rows;
  const int v = (uniform_w > 0 ? 1 : 0) | (trunc_n ? 2 : 0) |
                (no_five ? 4 : 0) | (packed ? 8 : 0);
  kLaunchRaw[v](a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same step on a wire chunk: `wire` is [B, row_bytes] (row_bytes =
// p * L / 8), `fields` holds n_fields triples (log2 width, bit offset in
// v, first byte in the row).  rank = 0: the band wire, q = v + bias;
// rank = 1: q = lut byte v as a signed char (v < 8).  `out` is [B] int32
// packed codes; lengths are the first v == 0.  `tile_rows` as above.
extern "C" int sk_trim_cuts_wire(const void* wire, void* out, long long B,
                                 int L, int row_bytes, int rank, int n_fields,
                                 const int* fields, int bias,
                                 unsigned long long lut, int t, int lthr,
                                 int no_five, int uniform_w, int tile_rows,
                                 void* stream) {
  if (B <= 0) return 0;
  if (n_fields < 1 || n_fields > 3 || bad_tile(tile_rows, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.qual = static_cast<const uint8_t*>(wire);
  a.out = static_cast<int32_t*>(out);
  a.B = B;
  a.L = L;
  a.row_bytes = row_bytes;
  a.t = t;
  a.lthr = lthr;
  a.uniform_w = uniform_w;
  a.n_fields = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    a.f_log2w[k] = fields[3 * k];
    a.f_shift[k] = fields[3 * k + 1];
    a.f_col[k] = fields[3 * k + 2];
  }
  a.bias = bias;
  a.lut = lut;
  a.tile_rows = tile_rows;
  const int v = (uniform_w > 0 ? 1 : 0) | (no_five ? 2 : 0);
  kLaunchWire[rank ? 1 : 0][v](a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
