// K7 sw_local: exact local alignment (ksw_align2's ksw_u8 / ksw_i16
// semantics, reference lib/aln/ksw.c:111-334) for a batch of mate-rescue
// lanes.
//
// Replaces the XLA function sw_local_kernel of biscuit_tpu/ops/sw_local.py.
// There every lane stepped the target rows in lockstep over a [B, Lq] plane,
// with F as a closed-form prefix scan, until the last lane stopped.
//
// What bounds it on an H100: integer operations, about 14 a DP cell over
// ext x tlen cells a lane (some 160 x 300 at rescue shapes); the inputs are
// under a kilobyte a lane and the output is 4 bytes a row. The DP is serial
// over target rows, so the kernel is as fast as the card is full and a row
// is short. Tensor cores, TMA and clusters have nothing to give an integer
// recurrence whose row fits in registers: the whole design is to keep the
// row out of device memory.
//
// What the design does about it (K1, sw_extend.cu, is built the same way):
//  * a warp owns a lane and walks that lane's target rows until the lane's
//    own break row; blocks of 4 warps, ceil(B / 4) blocks;
//  * thread l holds the strip of C consecutive query columns
//    [l * C, l * C + C) of the H and E rows in registers for the whole run
//    (C a template parameter, 32 * C >= Lq); the diagonal value a strip
//    needs from its left neighbour crosses by one __shfl_up_sync a row. A
//    query wider than the widest C runs the wide instance (C = 0,
//    strip.cuh): the same rows with the strips in shared memory,
//    ceil(Lq / 32) columns a thread, a warp a block, the scores from the
//    lane's matrix and the strip's query codes;
//  * the strip's scores against each of the five target letters lie in
//    shared memory (a conflict-free load a cell), pad columns scoring 0; the
//    target's bases are read 32 rows at a time and broadcast by a shuffle;
//  * F reads only H1 = max(M, E) of its own row, so
//    F(j) = max(0, max_{k<j} tF(k) - (j-1-k) * e_ins), tF = max(H1 - oe_ins,
//    0), the closed form of sw_local.py:88-95, is a max-plus prefix scan:
//    a serial pass over the strip, five shuffle steps that combine the
//    strips' carries (decayed by distance * e_ins), a second serial pass;
//  * the row maximum and its first column are warp reductions
//    (redux.sync), so the break decision is the same in every thread;
//  * the stripe's end `ext` is a mask on the strip;
//  * thread 0 writes the row's maximum; the rows after the stop are filled
//    by all 32 threads.
//
// What must match sw_local_kernel bit for bit:
//  * striped padding: ext is qlen rounded up to 16 (u8 lanes) or 8 (i16
//    lanes); columns qlen <= j < ext score 0 against every target base and
//    count in the row maximum; columns j >= ext stay 0;
//  * shift = (256 - min of the lane's matrix) & 0xFF on u8 lanes, 0 else;
//  * the break after the row's update, on u8 saturation
//    (gmax + shift >= 255) or gmax >= endsc, only in a row that raised gmax;
//  * te starts at -1, qe at 0 (np.argmax of an all-zero Hmax); qe is the
//    first column holding the maximum of the row that last raised gmax;
//  * imax_rows[i, b] is the row maximum (>= 0) for every row the lane ran
//    (0 in every row of a lane whose query is empty), NEGB for every row
//    after it stopped.
#include <limits.h>

#include "strip.cuh"

namespace {

constexpr int NEGB = -(1 << 28);

// words of work memory a lane of the wide instance: H, E, H1 and the query
// codes of the row
__host__ __device__ constexpr int64_t wide_words(int Lq) {
  return 4 * 32 * (int64_t)wide_cols(Lq);
}

template <int C>
__global__ void __launch_bounds__(WARPS * 32) sw_local_kernel(
    const void* __restrict__ query, const void* __restrict__ target,
    const int32_t* __restrict__ matb, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ endscv,
    const int32_t* __restrict__ u8v, int32_t* scratch,
    int32_t* __restrict__ out, int32_t* __restrict__ rows, int B, int Lq,
    int Lt, int code_bytes, int o_del, int e_del, int o_ins, int e_ins) {
  // [target letter][k][thread]; the wide instance has none
  __shared__ int32_t prof[WARPS][5][C ? C : 1][32];
  __shared__ int32_t smat[WARPS][32];
  extern __shared__ int32_t dyn[];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = C ? blockIdx.x * WARPS + wid : blockIdx.x;
  if (b >= B) return;  // a whole warp; the kernel has no block-wide barrier
  const int Cn = C ? C : wide_cols(Lq);  // columns a thread
  // the wide instance's work memory: the block's, or the lane's of `scratch`
  int32_t* mem = scratch ? scratch + (size_t)b * wide_words(Lq) : dyn;
  int32_t* qcode = mem + (size_t)3 * 32 * Cn + lane;  // [k][thread]
  const size_t sB = (size_t)B;
  const int qlen = qlens[b], tlen = tlens[b], endsc = endscv[b];
  const bool u8 = u8v[b] > 0;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int c0 = lane * Cn;  // the strip's first column
  const int n_rows = min(tlen, Lt);

  // the lane's matrix and its minimum, then the strip's profile
  const int mv = lane < 25 ? matb[(size_t)b * 25 + lane] : INT_MAX;
  if (lane < 25) smat[wid][lane] = mv;
  const int mn = __reduce_min_sync(FULL, mv);
  const int shift = u8 ? (256 - mn) & 0xFF : 0;
  const int stripe = u8 ? 16 : 8;
  const int ext = min((qlen + stripe - 1) / stripe * stripe, Lq);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < Cn; ++k) {
    const int j = c0 + k;
    const int qc = j < Lq ? load_code(query, (size_t)b * Lq + j, code_bytes) : 4;
    if constexpr (C != 0) {
#pragma unroll
      for (int tc = 0; tc < 5; ++tc)
        prof[wid][tc][k][lane] = j < qlen ? smat[wid][tc * 5 + qc] : 0;
    } else {
      qcode[k * 32] = qc;
    }
  }
  // the score of column c0 + k against target letter tb (0 on pad columns)
  auto sc = [&](int tb, int k) -> int {
    if constexpr (C != 0) return prof[wid][tb][k][lane];
    else return c0 + k < qlen ? smat[wid][tb * 5 + qcode[k * 32]] : 0;
  };

  int gmax = 0, te = -1, qe = 0;
  int i = 0;
  if (ext > 0) {
    // H and E of the previous row on the strip's columns, H1 of this row
    Strip<C> HH(mem, 0, Cn, lane), EE(mem, 1, Cn, lane), H1(mem, 2, Cn, lane);
#pragma unroll
    for (int k = 0; k < Cn; ++k) HH[k] = EE[k] = 0;
    // the target's bases, 32 rows a tile, one a thread, the next in flight
    const size_t row0 = (size_t)b * Lt;
    int tile = load_tile(target, row0, 0, lane, n_rows, code_bytes);
    int tile_next = load_tile(target, row0, 32, lane, n_rows, code_bytes);
    for (; i < n_rows; ++i) {
      if ((i & 31) == 0 && i > 0) {
        tile = tile_next;
        tile_next =
            load_tile(target, row0, i + 32, lane, n_rows, code_bytes);
      }
      const int tb = __shfl_sync(FULL, tile, i & 31);
      // H of the previous row at the column left of the strip
      int hd = __shfl_up_sync(FULL, HH[Cn - 1], 1);
      if (lane == 0) hd = 0;

      // pass 1 over the strip: H1 = max(M, E), masked at ext, and the
      // strip's own carry g = F at the column after the strip if nothing
      // came from the left
      int g = 0;
#pragma unroll
      for (int k = 0; k < Cn; ++k) {
        const bool inb = c0 + k < ext;
        const int m = max(hd + sc(tb, k), 0);
        const int h1 = inb ? max(m, EE[k]) : 0;
        H1[k] = h1;
        g = max(g - e_ins, max(h1 - oe_ins, 0));
        hd = HH[k];
      }
      // the strips' carries combined: v is F at the column after this strip
      int v = g;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v = max(v, u - d * Cn * e_ins);
      }
      int f = __shfl_up_sync(FULL, v, 1);  // F at this strip's first column
      if (lane == 0) f = 0;

      // pass 2: H, the next row's E, the strip's maximum and its first column
      int lm = 0, lj = c0;
#pragma unroll
      for (int k = 0; k < Cn; ++k) {
        const bool inb = c0 + k < ext;
        const int h1 = H1[k];
        const int H = inb ? max(h1, f) : 0;
        f = max(f - e_ins, max(h1 - oe_ins, 0));
        EE[k] = inb ? max(EE[k] - e_del, max(H - oe_del, 0)) : 0;
        HH[k] = H;
        if (H > lm) {
          lm = H;
          lj = c0 + k;
        }
      }
      const int rmax = __reduce_max_sync(FULL, lm);
      if (lane == 0) rows[(size_t)i * sB + b] = rmax;
      if (rmax > gmax) {
        qe = __reduce_min_sync(FULL, lm == rmax ? lj : INT_MAX);
        gmax = rmax;
        te = i;
        if ((u8 && gmax + shift >= 255) || gmax >= endsc) {
          ++i;
          break;
        }
      }
    }
  } else {
    // an empty query: the lane runs all its rows, each with maximum 0
    for (int r = lane; r < n_rows; r += 32) rows[(size_t)r * sB + b] = 0;
    i = n_rows;
  }
  for (int r = i + lane; r < Lt; r += 32) rows[(size_t)r * sB + b] = NEGB;
  if (lane == 0) {
    out[0 * sB + b] = gmax;
    out[1 * sB + b] = te;
    out[2 * sB + b] = qe;
    out[3 * sB + b] = shift;
    out[4 * sB + b] = (u8 && gmax + shift >= 255) ? 1 : 0;
  }
}

template <int C>
int launch(const void* query, const void* target, const void* matb,
           const void* qlens, const void* tlens, const void* endsc,
           const void* u8, void* scratch, void* out, void* rows, int B,
           int Lq, int Lt, int code_bytes, int o_del, int e_del, int o_ins,
           int e_ins, void* stream) {
  int64_t shared = 0;
  if (C == 0) {
    shared = wide_shared_bytes(wide_words(Lq));
    static int64_t raised = 48 * 1024;
    if (shared == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (const int rc = raise_shared(sw_local_kernel<C>, shared, raised))
      return rc;
  }
  sw_local_kernel<C><<<Shape<C>::blocks(B), Shape<C>::threads, (size_t)shared,
                       (cudaStream_t)stream>>>(
      query, target, (const int32_t*)matb, (const int32_t*)qlens,
      (const int32_t*)tlens, (const int32_t*)endsc, (const int32_t*)u8,
      C == 0 && shared == 0 ? (int32_t*)scratch : nullptr, (int32_t*)out,
      (int32_t*)rows, B, Lq, Lt, code_bytes, o_del, e_del, o_ins, e_ins);
  return (int)cudaGetLastError();
}

template <int C>
int resident(int Lq) {
  const int64_t shared = C ? 0 : wide_shared_bytes(wide_words(Lq));
  int64_t raised = 48 * 1024;
  int blocks = 0;
  if (raise_shared(sw_local_kernel<C>, shared, raised) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sw_local_kernel<C>, Shape<C>::threads, (size_t)shared) !=
          cudaSuccess)
    return -1;
  return blocks * Shape<C>::threads / 32;
}

}  // namespace

// every instance of the strip width C; the wrapper picks the smallest with
// 32 * C >= Lq (ops/strip_scan.py keeps the same list), and the wide
// instance, C = 0, for a query wider than them all
#define FOR_EACH_C(X) X(2) X(4) X(5) X(6) X(8) X(12) X(16)

// `scratch` is read only by the wide instance, and only when
// sw_local_scratch_words says a lane's row needs device memory: then it
// holds that many words a lane
extern "C" int sw_local(const void* query, const void* target,
                        const void* matb, const void* qlens,
                        const void* tlens, const void* endsc, const void* u8,
                        void* scratch, void* out, void* rows, int B, int Lq,
                        int Lt, int code_bytes, int C, int o_del, int e_del,
                        int o_ins, int e_ins, void* stream) {
  if ((C != 0 && Lq > 32 * C) || (code_bytes != 1 && code_bytes != 4))
    return (int)cudaErrorInvalidValue;
  switch (C) {
#define CASE(N)                                                            \
  case N:                                                                  \
    return launch<N>(query, target, matb, qlens, tlens, endsc, u8,        \
                     scratch, out, rows, B, Lq, Lt, code_bytes, o_del,    \
                     e_del, o_ins, e_ins, stream);
    CASE(0)
    FOR_EACH_C(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// device memory, in words a lane, that the wide instance needs at query
// width Lq: 0 while a lane's row fits shared memory
extern "C" int64_t sw_local_scratch_words(int Lq) {
  return wide_shared_bytes(wide_words(Lq)) ? 0 : wide_words(Lq);
}

// warps (lanes of the batch) of instance C that one SM holds at once (of
// the wide instance, C = 0, at query width Lq), -1 for no such instance
extern "C" int sw_local_resident_warps(int C, int Lq) {
  switch (C) {
#define CASE(N) \
  case N:       \
    return resident<N>(Lq);
    CASE(0)
    FOR_EACH_C(CASE)
#undef CASE
  }
  return -1;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
