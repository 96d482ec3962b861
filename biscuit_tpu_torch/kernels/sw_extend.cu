// K1 sw_extend: banded affine-gap Smith-Waterman extension, exact
// ksw_extend2 (reference lib/aln/ksw.c:380-479), for a batch of lanes.
//
// Replaces the Pallas kernel _sw_kernel of biscuit_tpu/ops/pallas_sw.py
// (sw_extend_batch_pallas). On the TPU the lanes rode the 128-wide vector
// axis and every tile stepped its rows in lockstep, masked, until its last
// lane broke.
//
// What bounds it on an H100: integer operations, about a dozen a DP cell; the
// inputs are a few hundred bytes a lane and the output 24. The DP is serial
// over target rows, so the kernel is as fast as (a) the card is full and
// (b) a row is short. Tensor cores, TMA and clusters have nothing to give an
// integer recurrence whose row fits in registers: the whole design is to keep
// the row out of device memory.
//
// What the design does about it:
//  * a warp owns a lane (an alignment) and runs that lane's rows until the
//    lane itself breaks (m == 0, z-drop, band collapse, end of its target).
//    Blocks of 4 warps, ceil(B / 4) blocks: 4096 lanes are 4096 warps, all
//    resident at once, and a late round of a few hundred lanes still puts a
//    warp on every SM;
//  * thread l of the warp holds the strip of C consecutive query columns
//    [l * C, l * C + C) of the H and E rows in registers for the whole run
//    (C is a template parameter, 32 * C >= Lq). Nothing of the DP state is
//    ever in device memory. The diagonal value a strip needs from its left
//    neighbour crosses by one __shfl_up_sync a row. A query wider than the
//    widest C runs the wide instance (C = 0, strip.cuh): the same rows with
//    the strips in shared memory, ceil(Lq / 32) columns a thread, a warp a
//    block; the scores then come from the lane's matrix and the strip's
//    query codes, both in shared memory;
//  * the scores of the strip against each of the five target letters (the
//    query profile) are laid out once in shared memory, so a cell's score is
//    one conflict-free load; the target's bases are read 32 rows at a time,
//    one a thread, and broadcast by a shuffle;
//  * F does not feed itself through H here (it reads only M of the same
//    row), so F(j) = max(0, max_{k<j} tF(k) - (j-1-k) * e_ins) with
//    tF = max(M - oe_ins, 0) is a max-plus prefix scan: each thread scans its
//    strip serially, five shuffle steps combine the strips' carries (decayed
//    by distance * e_ins), and a second serial pass over the strip applies
//    the carry. No cell waits for its left neighbour's F across threads;
//  * the row's reductions (maximum and its rightmost column, last nonzero
//    cell, H at the band's end) are warp reductions (redux.sync), so every
//    thread takes the same break decision and the warp never diverges;
//  * the band [beg, end) is a mask on the strip: cells outside it hold 0, as
//    the JAX kernel zeroes them.
//
// What must match _sw_kernel bit for bit:
//  * the first row's closed-form decay (pallas_sw.py:97-102);
//  * h[beg] = h1_first and h[j+1] = H(j) inside the band, 0 in every cell
//    outside the band (also those the next row can read beyond this row's
//    band: h[end+1], e[end], e[end+1]);
//  * F is cut at the band's end: a carry that runs past `end` is dropped;
//  * the end-side narrowing: the next row's end is last_nz + 2, with
//    last_nz the last nonzero h or e cell at or left of this row's end;
//  * gscore/max_ie at the query end, including the collapsed-band case;
//  * the z-drop test with e_del or e_ins chosen by di > dj, against the
//    previous maximum;
//  * the row maximum's column is the rightmost one that holds it, and when
//    the maximum is 0 the rightmost column of the padded row (Lq - 1, the
//    width of the call, not of the strips).
#include "strip.cuh"

namespace {

// words of work memory a lane of the wide instance: h, e, M and the query
// codes of the row
__host__ __device__ constexpr int64_t wide_words(int Lq) {
  return 4 * 32 * (int64_t)wide_cols(Lq);
}

template <int C>
__global__ void __launch_bounds__(WARPS * 32) sw_extend_kernel(
    const void* __restrict__ query, const void* __restrict__ target,
    const int32_t* __restrict__ matb, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ wv,
    const int32_t* __restrict__ h0v, int32_t* scratch,
    int32_t* __restrict__ out, int B, int Lq, int Lt, int code_bytes,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop) {
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
  const int qlen = qlens[b], tlen = tlens[b], w = wv[b], h0 = h0v[b];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int c0 = lane * Cn;  // the strip's first column
  const int n_rows = min(tlen, Lt);

  // the lane's matrix, then the strip's profile
  if (lane < 25) smat[wid][lane] = matb[(size_t)b * 25 + lane];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < Cn; ++k) {
    const int j = c0 + k;
    const int qc = j < Lq ? load_code(query, (size_t)b * Lq + j, code_bytes) : 4;
    if constexpr (C != 0) {
#pragma unroll
      for (int tc = 0; tc < 5; ++tc)
        prof[wid][tc][k][lane] = smat[wid][tc * 5 + qc];
    } else {
      qcode[k * 32] = qc;
    }
  }
  // the score of column c0 + k against target letter tb
  auto sc = [&](int tb, int k) -> int {
    if constexpr (C != 0) return prof[wid][tb][k][lane];
    else return smat[wid][tb * 5 + qcode[k * 32]];
  };

  // first row (ksw.c:395-397): hh[k] is h[c0 + k], the diagonal of column
  // c0 + k; ee[k] is e[c0 + k]
  Strip<C> hh(mem, 0, Cn, lane), ee(mem, 1, Cn, lane), M(mem, 2, Cn, lane);
  const int h1v = max(h0 - oe_ins, 0);
#pragma unroll
  for (int k = 0; k < Cn; ++k) {
    const int j = c0 + k;
    hh[k] = j == 0 ? h0 : j <= qlen ? max(h1v - (j - 1) * e_ins, 0) : 0;
    ee[k] = 0;
  }

  // the target's bases, 32 rows a tile, one a thread, the next tile in flight
  const size_t row0 = (size_t)b * Lt;
  int tile = load_tile(target, row0, 0, lane, n_rows, code_bytes);
  int tile_next = load_tile(target, row0, 32, lane, n_rows, code_bytes);

  int end = qlen, mx = h0, max_i = -1, max_j = -1, max_ie = -1;
  int gscore = -1, max_off = 0;
  for (int i = 0; i < n_rows; ++i) {
    if ((i & 31) == 0 && i > 0) {
      tile = tile_next;
      tile_next = load_tile(target, row0, i + 32, lane, n_rows, code_bytes);
    }
    const int beg_i = max(i - w, 0);
    const int end_i = min(min(end, i + w + 1), qlen);
    const bool at_tail = end_i == qlen;
    const int h1_first =
        beg_i == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    if (beg_i >= end_i) {  // band collapsed: the lane ends here
      if (at_tail && gscore <= h1_first) {
        gscore = max(gscore, h1_first);
        max_ie = i;
      }
      break;
    }
    const int tb = __shfl_sync(FULL, tile, i & 31);

    // pass 1 over the strip: M, the band's mask on E, and the strip's own
    // carry g = F at the column after the strip if nothing came from the left
    int g = 0;
#pragma unroll
    for (int k = 0; k < Cn; ++k) {
      const int j = c0 + k;
      const bool inb = j >= beg_i && j < end_i;
      const int hd = hh[k];
      const int m = inb && hd != 0 ? hd + sc(tb, k) : 0;
      M[k] = m;
      ee[k] = inb ? ee[k] : 0;
      g = max(g - e_ins, max(m - oe_ins, 0));
    }
    // the strips' carries combined: after the loop v is F at the column after
    // this strip, from every column at or left of it
    int v = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v = max(v, u - d * Cn * e_ins);
    }
    int f = __shfl_up_sync(FULL, v, 1);  // F at this strip's first column
    if (lane == 0) f = 0;

    // pass 2: H, the next row's E, and the strip's share of the reductions
    int lm = 0, lj = -1, lnz = -1, hl = 0, hprev = 0;
#pragma unroll
    for (int k = 0; k < Cn; ++k) {
      const int j = c0 + k;
      const bool inb = j >= beg_i && j < end_i;
      const int m = M[k], E = ee[k];
      const int hc = inb ? max(max(m, E), f) : 0;
      f = max(f - e_ins, max(m - oe_ins, 0));
      const int ne = inb ? max(E - e_del, max(m - oe_del, 0)) : 0;
      ee[k] = ne;
      if (hc >= lm) {
        lm = hc;
        lj = j;
      }
      if (ne != 0) lnz = max(lnz, j);
      if (hc != 0) lnz = j + 1;
      if (j == end_i - 1) hl = hc;
      if (k > 0) hh[k] = hprev;  // h[j] = H(j - 1)
      hprev = hc;
    }
    const int up = __shfl_up_sync(FULL, hprev, 1);
    hh[0] = lane == 0 ? 0 : up;
#pragma unroll
    for (int k = 0; k < Cn; ++k)
      if (c0 + k == beg_i) hh[k] = h1_first;

    const int m_val = __reduce_max_sync(FULL, lm);
    int mj = __reduce_max_sync(FULL, lm == m_val ? lj : -1);
    if (m_val == 0) mj = Lq - 1;
    int last_nz = __reduce_max_sync(FULL, lnz);
    if (h1_first != 0) last_nz = max(last_nz, beg_i);

    if (at_tail) {
      const int h_last = __reduce_max_sync(FULL, hl);  // H(end_i - 1) >= 0
      if (gscore <= h_last) {
        gscore = h_last;
        max_ie = i;
      }
    }
    const bool brk0 = m_val == 0;
    const bool improved = m_val > mx;
    const int di = i - max_i, dj = mj - max_j;
    const bool zd = di > dj ? (mx - m_val - (di - dj) * e_del > zdrop)
                            : (mx - m_val - (dj - di) * e_ins > zdrop);
    const bool zbrk = !improved && zdrop > 0 && zd && !brk0;
    if (improved) {
      mx = m_val;
      max_i = i;
      max_j = mj;
      max_off = max(max_off, abs(mj - i));
    }
    end = min(last_nz + 2, qlen);
    if (brk0 || zbrk) break;
  }
  if (lane == 0) {
    out[0 * sB + b] = mx;
    out[1 * sB + b] = max_j + 1;
    out[2 * sB + b] = max_i + 1;
    out[3 * sB + b] = max_ie + 1;
    out[4 * sB + b] = gscore;
    out[5 * sB + b] = max_off;
  }
}

template <int C>
int launch(const void* query, const void* target, const void* matb,
           const void* qlens, const void* tlens, const void* w,
           const void* h0, void* scratch, void* out, int B, int Lq, int Lt,
           int code_bytes, int o_del, int e_del, int o_ins, int e_ins,
           int zdrop, void* stream) {
  int64_t shared = 0;
  if (C == 0) {
    shared = wide_shared_bytes(wide_words(Lq));
    static int64_t raised = 48 * 1024;
    if (shared == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (const int rc = raise_shared(sw_extend_kernel<C>, shared, raised))
      return rc;
  }
  sw_extend_kernel<C><<<Shape<C>::blocks(B), Shape<C>::threads, (size_t)shared,
                        (cudaStream_t)stream>>>(
      query, target, (const int32_t*)matb, (const int32_t*)qlens,
      (const int32_t*)tlens, (const int32_t*)w, (const int32_t*)h0,
      C == 0 && shared == 0 ? (int32_t*)scratch : nullptr, (int32_t*)out, B,
      Lq, Lt, code_bytes, o_del, e_del, o_ins, e_ins, zdrop);
  return (int)cudaGetLastError();
}

template <int C>
int resident(int Lq) {
  const int64_t shared = C ? 0 : wide_shared_bytes(wide_words(Lq));
  int64_t raised = 48 * 1024;
  int blocks = 0;
  if (raise_shared(sw_extend_kernel<C>, shared, raised) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sw_extend_kernel<C>, Shape<C>::threads, (size_t)shared) !=
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
// sw_extend_scratch_words says a lane's row needs device memory: then it
// holds that many words a lane
extern "C" int sw_extend(const void* query, const void* target,
                         const void* matb, const void* qlens,
                         const void* tlens, const void* w, const void* h0,
                         void* scratch, void* out, int B, int Lq, int Lt,
                         int code_bytes, int C, int o_del, int e_del,
                         int o_ins, int e_ins, int zdrop, void* stream) {
  if ((C != 0 && Lq > 32 * C) || (code_bytes != 1 && code_bytes != 4))
    return (int)cudaErrorInvalidValue;
  switch (C) {
#define CASE(N)                                                              \
  case N:                                                                    \
    return launch<N>(query, target, matb, qlens, tlens, w, h0, scratch, out, \
                     B, Lq, Lt, code_bytes, o_del, e_del, o_ins, e_ins,      \
                     zdrop, stream);
    CASE(0)
    FOR_EACH_C(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// device memory, in words a lane, that the wide instance needs at query
// width Lq: 0 while a lane's row fits shared memory
extern "C" int64_t sw_extend_scratch_words(int Lq) {
  return wide_shared_bytes(wide_words(Lq)) ? 0 : wide_words(Lq);
}

// warps (lanes of the batch) of instance C that one SM holds at once (of
// the wide instance, C = 0, at query width Lq), -1 for no such instance
extern "C" int sw_extend_resident_warps(int C, int Lq) {
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
