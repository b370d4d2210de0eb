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
// What bounds it on the H100: bytes.  A 150 bp read brings ~152 B of raw
// quality row in (114 B on the 6-bit field wire, 57 B on the 3-bit rank
// wire; plus 152 B of seq under -n) and sends 4 B out, for a few hundred
// integer ops, far below the ~295 ops/B where compute would bind; and the
// row crosses PCIe before it ever reaches HBM, so the kernel's job is to
// touch each input byte from HBM once and keep every intermediate out of
// device memory.  The design answers that:
//
// * One warp per row, kRowsPerBlock rows per block.  The row is read with
//   coalesced byte loads (32 consecutive bytes per warp instruction); the
//   later passes re-read the same bytes from L1.
// * The row's source form is a template parameter: RAW ASCII qualities,
//   the BAND field wire (q = v + bias) or the RANK wire (q = lut[v]).  Every
//   read of a quality goes through one accessor that decodes position j
//   from the row as it lies in device memory (at most three subfield bytes
//   for a wire), so the decoded row v never exists in device memory and
//   shared memory stays at zero.
// * No prefix array is materialized.  The TPU kernels build the whole
//   D[j] = C[j] - t*j row in VMEM and shift it by the window w.  Here two
//   running warp scans advance in lockstep, one at the window start i and
//   one at i + w, so D[i] and D[i+w] are both in registers for a 32-wide
//   stride of window starts.  Shared memory use is zero at every L, which
//   is how long reads are handled: a 50 kbp row needs no 200 KB D array,
//   no one-row-per-block dynamic shared memory and no global scratch.
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
constexpr int kRowsPerBlock = 8;
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
template <int SRC, bool UNIFORM, bool TRUNC_N, bool NO_FIVE>
__device__ __forceinline__ bool row_cuts(const Args& a, const uint8_t* qrow,
                                         const uint8_t* srow, int len,
                                         int lane, int& five, int& three) {
  const int t = a.t;
  const int w = UNIFORM ? a.uniform_w : (len / 10 > 0 ? len / 10 : len);
  const int last = len - w;  // last window start: i + w <= len

  // decoded quality at j < len; 0 past the read's end (as the sums see it)
  auto q_of = [&](int j) -> int {
    return quality_of<SRC>(a, value_at<SRC>(a, qrow, j));
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
      const int c = j < len ? srow[j] : 0;
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

template <int SRC, bool UNIFORM, bool TRUNC_N, bool NO_FIVE, bool PACKED>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
trim_cuts_kernel(const Args a) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= a.B) return;  // the whole warp leaves together
  const int L = a.L;
  const uint8_t* qrow = a.qual + row * a.row_bytes;

  // 1. the read's length, and whether any char inside it is out of range
  int len = L;
  bool bad = false;
  if (SRC == kRaw && a.lengths != nullptr) {
    len = min(max(a.lengths[row], 0), L);
    for (int j = lane; j < len; j += kWarp) {
      const int c = qrow[j];
      bad |= c < a.qmin || c > a.qmax;
    }
  } else {
    for (int s = 0; s < L; s += kWarp) {
      const int j = s + lane;
      // lanes past the row read as padding
      const int c = j < L ? value_at<SRC>(a, qrow, j) : 0;
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
  const uint8_t* srow = TRUNC_N ? a.seq + row * L : nullptr;
  if (len == 0 || !row_cuts<SRC, UNIFORM, TRUNC_N, NO_FIVE>(a, qrow, srow, len,
                                                            lane, five, three)) {
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

template <int SRC, int V>
void launch(const Args& a, dim3 grid, cudaStream_t stream) {
  trim_cuts_kernel<SRC, (V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 8) != 0>
      <<<grid, kRowsPerBlock * kWarp, 0, stream>>>(a);
}

using LaunchFn = void (*)(const Args&, dim3, cudaStream_t);
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

dim3 grid_for(long long B) {
  return dim3(static_cast<unsigned>((B + kRowsPerBlock - 1) / kRowsPerBlock));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller allocates `out` ([B] int32 when packed, else [3, B]).  Explicit
// `lengths` (may be null) must lie in [0, L].
extern "C" int sk_trim_cuts(const void* seq, const void* qual,
                            const void* lengths, void* out, long long B,
                            int L, int offset, int qmin, int qmax, int t,
                            int lthr, int no_five, int trunc_n, int fork_order,
                            int uniform_w, int packed, void* stream) {
  if (B <= 0) return 0;
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
  const int v = (uniform_w > 0 ? 1 : 0) | (trunc_n ? 2 : 0) |
                (no_five ? 4 : 0) | (packed ? 8 : 0);
  kLaunchRaw[v](a, grid_for(B), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same step on a wire chunk: `wire` is [B, row_bytes] (row_bytes =
// p * L / 8), `fields` holds n_fields triples (log2 width, bit offset in
// v, first byte in the row).  rank = 0: the band wire, q = v + bias;
// rank = 1: q = lut byte v as a signed char (v < 8).  `out` is [B] int32
// packed codes; lengths are the first v == 0.
extern "C" int sk_trim_cuts_wire(const void* wire, void* out, long long B,
                                 int L, int row_bytes, int rank, int n_fields,
                                 const int* fields, int bias,
                                 unsigned long long lut, int t, int lthr,
                                 int no_five, int uniform_w, void* stream) {
  if (B <= 0) return 0;
  if (n_fields < 1 || n_fields > 3) return static_cast<int>(cudaErrorInvalidValue);
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
  const int v = (uniform_w > 0 ? 1 : 0) | (no_five ? 2 : 0);
  kLaunchWire[rank ? 1 : 0][v](a, grid_for(B), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
