// K2 sw_global: banded global alignment with traceback, exact ksw_global2
// (reference lib/aln/ksw.c:504-606), for a batch of lanes.
//
// Replaces the Pallas kernel _glob_kernel of biscuit_tpu/ops/pallas_global.py
// (sw_global_batch_pallas) and its XLA companion global_traceback. On the
// TPU the DP walked target rows as the sequential grid axis with the H and E
// rows in VMEM scratch, 128 lanes a tile, and the traceback ran as a lockstep
// while_loop over the whole batch.
//
// What bounds it on an H100: bytes. The direction bytes are the output, one
// a cell of the padded rectangle (Lq * Lt a lane, 49 MB for 2048 lanes of
// 150 x 160), against a dozen integer operations a band cell. The least the
// card can do is write every word of z once; everything else the DP touches
// (the H and E rows, the scores) is a few hundred bytes a lane and has no
// business in device memory. The DP is serial over target rows, so beside
// that the kernel is as fast as the card is full and a row is short.
//
// What the design does about it:
//  * a warp owns a lane (an alignment). Blocks of 4 warps, ceil(B / 4)
//    blocks: 2048 lanes are 2048 warps, all resident at once;
//  * thread l of the warp holds the strip of C consecutive query columns
//    [l * C, l * C + C) of the H and E rows in registers for the lane's whole
//    run (C is a template parameter, 32 * C >= Lq). No DP state is in device
//    memory. h[c0 + C], which is the right neighbour's h[c0], is kept beside
//    the strip and handed over by one __shfl_up_sync a row. A query wider
//    than the widest C runs the wide instance (C = 0, strip.cuh): the same
//    rows with the strips in shared memory, ceil(Lq / 32) columns a thread,
//    a warp a block, the scores from the lane's matrix and the strip's query
//    codes;
//  * the scores of the strip against each of the five target letters (the
//    query profile) lie in shared memory [letter][k][thread], so a cell's
//    score is one conflict-free load; the target's bases are read 32 rows at
//    a time, one a thread, and broadcast by a shuffle; the codes are read in
//    place as [B, L] uint8 or int32;
//  * F(beg) = MINUS_INF, F(j + 1) = max(F(j) - e_ins, M(j) - oe_ins) reads
//    only M, which comes from the row above, so it is a prefix scan: with
//    b(k) = M(k) - oe_ins + k * e_ins inside the band and VERYNEG outside it,
//    F(j) = max(MINUS_INF - (j - beg) * e_ins,
//               max_{k < j} b(k) - (j - 1) * e_ins).
//    Each thread takes the maximum of its strip, five shuffle steps make the
//    prefix maximum over the strips, a second pass over the strip applies it
//    (ops/strip_scan.global_f_row_strips is the same algebra in torch, held
//    to the serial recurrence by the CPU tests). Nothing leaves int32: b is
//    at least VERYNEG = -0x48000000 and the largest term added or taken off
//    is (Lq - 1) * e_ins, so at 512 columns and e_ins up to 6 the smallest
//    value is above -0x48000000 - 3066, more than 9 * 10^8 above -2^31 (the
//    wrappers take Lq up to 2^20 columns: with e_ins up to 256 that margin
//    still holds);
//  * each word of z is written once and never read by the DP: a thread
//    gathers the direction bytes of four rows of its C columns in registers,
//    and every fourth row the warp lays the C * 32 words out in shared memory
//    and stores them as one contiguous run. Cells outside the band hold 0 in
//    those words, and the word rows at and past the target's end are written
//    as zeros, so the wrapper zeroes nothing. For the stores to be runs, z
//    lies lane-major in memory ([B, ceil(Lt/4), Lq]); the wrapper returns it
//    as the permuted view [ceil(Lt/4), Lq, B] of the JAX layout, equal in
//    every element;
//  * the traceback follows the DP in the same launch (the fused entry
//    sw_global_cigar): after a __syncwarp one thread of the warp walks the
//    bytes its warp has just written (read through L2, __ldcg), pushing runs
//    into shared memory, and the whole warp writes the reversed list out.
//    global_traceback stays as a kernel of its own, one thread a lane, for a
//    z of any strides.
//
// What must match _glob_kernel and global_traceback bit for bit:
//  * MINUS_INF = -0x40000000 is ramped (the first row, h1_first, F's start)
//    and its exact value reaches bit 5 of the direction byte of in-band
//    sentinel cells (pallas_global.py:35-39), so the same constant and the
//    exact F are used;
//  * h[beg] = h1_first after the row's M was taken, e[end] = MINUS_INF,
//    end = min(i + w + 1, qlen, Lq), rows i < min(tlen, Lt), tlen and w
//    clamped to at least 1 for the DP (raw for the traceback),
//    score = h[qlen];
//  * cells outside the band keep their h and e from the row before (they are
//    not zeroed, unlike the extension kernel);
//  * the traceback's `which` state, the pushes M, D, I, the tail pushes D
//    then I, the flush, the max_ops overflow flag and the reversal of the
//    emitted prefix.
#include "strip.cuh"

namespace {

constexpr int MINUS_INF = -0x40000000;
constexpr int VERYNEG = -0x48000000;  // below any ramped MINUS_INF
constexpr int MAX_OPS = 64;

// shared memory words a warp: the profile, the z staging tile, the op list
__host__ __device__ constexpr int warp_words(int C) { return 5 * C * 32 + 32 * C + MAX_OPS; }
// words of work memory a lane of the wide instance: h, e, the direction
// bytes, M and the query codes of the row, the z staging tile, the op list
__host__ __device__ constexpr int64_t wide_words(int Lq) {
  return 6 * 32 * (int64_t)wide_cols(Lq) + MAX_OPS;
}

// the run-length op list of one lane (scalar push(), ops/sw.py:197-201)
struct Runs {
  int* ops;
  int n = 0, last_op = -1, last_len = 0, max_ops;
  bool ov = false;
  __device__ Runs(int* buf, int m) : ops(buf), max_ops(m) {}
  __device__ void push(int op, int len) {
    if (last_op == op) {
      last_len += len;
      return;
    }
    if (last_op >= 0) {
      ops[min(n, max_ops - 1)] = last_op | (last_len << 4);
      if (n >= max_ops) ov = true;
      ++n;
    }
    last_op = op;
    last_len = len;
  }
};

// the walk over the direction bytes from (tlen - 1, min(tlen + w, qlen) - 1)
// with the raw tlen and w; word(r, k) gives packed word row r, column k
template <typename Word>
__device__ void walk(Word word, int qlen, int tlen, int w, Runs& r) {
  int i = tlen - 1;
  int k = min(i + w + 1, qlen) - 1;
  int which = 0;
  while (i >= 0 && k >= 0) {
    const uint32_t wd = (uint32_t)word(i >> 2, k);
    const int byte = (int)((wd >> ((i & 3) << 3)) & 0xFFu);
    which = (byte >> (which << 1)) & 3;
    if (which == 0) {
      r.push(0, 1);
      --i;
      --k;
    } else if (which == 1) {
      r.push(2, 1);
      --i;
    } else {
      r.push(1, 1);
      --k;
    }
  }
  if (i >= 0) r.push(2, i + 1);
  if (k >= 0) r.push(1, k + 1);
  r.push(3, 0);  // flush the open run
}

template <int C, bool FUSED>
__global__ void __launch_bounds__(WARPS * 32) sw_global_kernel(
    const void* __restrict__ query, const void* __restrict__ target,
    const int32_t* __restrict__ matb, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ wv,
    int32_t* scratch, int32_t* __restrict__ score, int32_t* z,
    int32_t* __restrict__ ops, int32_t* __restrict__ n_ops,
    uint8_t* __restrict__ ov, int B, int Lq, int Lt, int code_bytes, int o_del,
    int e_del, int o_ins, int e_ins, int max_ops) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t smat[32];  // the lane's matrix, for the wide instance
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = C ? blockIdx.x * WARPS + wid : blockIdx.x;
  if (b >= B) return;  // a whole warp; the kernel has no block-wide barrier
  const int Cn = C ? C : wide_cols(Lq);  // columns a thread
  // the wide instance's work memory: the block's, or the lane's of `scratch`
  int32_t* mem = scratch ? scratch + (size_t)b * wide_words(Lq) : smem;
  int32_t* qcode = mem + (size_t)4 * 32 * Cn + lane;  // [k][thread]
  // [target letter][k][thread]; the wide instance has none
  int32_t* prof = smem + wid * warp_words(C);
  int32_t* ztile = C ? prof + 5 * C * 32 : mem + (size_t)5 * 32 * Cn;
  int32_t* sops = ztile + 32 * Cn;
  const int qlen = qlens[b], tlen_raw = tlens[b], w_raw = wv[b];
  // the DP clamps both to >= 1 (pallas_global.py:218-219)
  const int tlen = max(tlen_raw, 1), w = max(w_raw, 1);
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int c0 = lane * Cn;  // the strip's first column
  const int n_rows = min(tlen, Lt);
  const int Lt4 = (Lt + 3) >> 2;
  int32_t* zl = z + (size_t)b * Lt4 * Lq;  // this lane's [Lt4, Lq] words

  // the strip's profile, from the lane's matrix (row = target letter)
#pragma unroll
  for (int k = 0; k < Cn; ++k) {
    const int j = c0 + k;
    const int qc = j < Lq ? load_code(query, (size_t)b * Lq + j, code_bytes) : 4;
    if constexpr (C != 0) {
#pragma unroll
      for (int tc = 0; tc < 5; ++tc)
        prof[(tc * C + k) * 32 + lane] = matb[(size_t)b * 25 + tc * 5 + qc];
    } else {
      qcode[k * 32] = qc;
    }
  }
  if constexpr (C == 0) {
    if (lane < 25) smat[lane] = matb[(size_t)b * 25 + lane];
    __syncwarp();
  }

  // hh[k] is h[c0 + k], the diagonal of column c0 + k; hx is h[c0 + C];
  // ee[k] is e[c0 + k]; zacc[k] the direction bytes of up to four rows
  Strip<C> hh(mem, 0, Cn, lane), ee(mem, 1, Cn, lane), zacc(mem, 2, Cn, lane);
  Strip<C> M(mem, 3, Cn, lane);
  // the first row: 0, then the insertion ramp as far as the band and the
  // query reach, MINUS_INF beyond
  auto h_first = [&](int j) {
    return j == 0 ? 0 : (j <= w && j <= qlen) ? -(o_ins + e_ins * j) : MINUS_INF;
  };
#pragma unroll
  for (int k = 0; k < Cn; ++k) {
    hh[k] = h_first(c0 + k);
    ee[k] = MINUS_INF;
    zacc[k] = 0;
  }
  int hx = h_first(c0 + Cn);

  const size_t row0 = (size_t)b * Lt;
  int tile = load_tile(target, row0, 0, lane, n_rows, code_bytes);
  int tile_next = load_tile(target, row0, 32, lane, n_rows, code_bytes);

  for (int i = 0; i < n_rows; ++i) {
    if ((i & 31) == 0 && i > 0) {
      tile = tile_next;
      tile_next = load_tile(target, row0, i + 32, lane, n_rows, code_bytes);
    }
    const int beg = max(i - w, 0);
    const int end = min(min(i + w + 1, qlen), Lq);
    const int h1_first = beg == 0 ? -(o_del + e_del * (i + 1)) : MINUS_INF;
    const int tb = __shfl_sync(FULL, tile, i & 31);
    // the score of column c0 + k against this row's target letter
    auto sc = [&](int k) -> int {
      if constexpr (C != 0) return prof[(tb * C + k) * 32 + lane];
      else return smat[tb * 5 + qcode[k * 32]];
    };

    // pass 1 over the strip: M, and the strip's maximum of b
    int g = VERYNEG;
#pragma unroll
    for (int k = 0; k < Cn; ++k) {
      const int j = c0 + k;
      const bool inb = j >= beg && j < end;
      const int m = hh[k] + sc(k);
      M[k] = m;
      g = max(g, inb ? m - oe_ins + j * e_ins : VERYNEG);
    }
    // the prefix maximum over the strips at and left of this one
    int v = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v = max(v, u);
    }
    int run = __shfl_up_sync(FULL, v, 1);  // over the columns left of c0
    if (lane == 0) run = VERYNEG;

    // pass 2: F, H, the direction byte, the next row's E and h
    const int sh = (i & 3) << 3;
    int hprev = 0;
    bool inb_prev = false;
#pragma unroll
    for (int k = 0; k < Cn; ++k) {
      const int j = c0 + k;
      const bool inb = j >= beg && j < end;
      const int m = M[k], E = ee[k];
      const int f = max(MINUS_INF - (j - beg) * e_ins, run - (j - 1) * e_ins);
      const int me = max(m, E);
      const int H = max(me, f);
      int d = m >= E ? 0 : 1;
      if (H > me) d = 2;
      d |= ((E - e_del) > (m - oe_del)) << 2;
      d |= ((f - e_ins) > (m - oe_ins)) << 5;
      if (inb) zacc[k] |= d << sh;
      ee[k] = inb ? max(E - e_del, m - oe_del) : (j == end ? MINUS_INF : E);
      run = max(run, inb ? m - oe_ins + j * e_ins : VERYNEG);
      if (k > 0 && inb_prev) hh[k] = hprev;  // h[j] = H(j - 1) inside the band
      hprev = H;
      inb_prev = inb;
    }
    if (inb_prev) hx = hprev;
    if (c0 + Cn == beg) hx = h1_first;
    const int up = __shfl_up_sync(FULL, hx, 1);
    if (lane > 0) hh[0] = up;
#pragma unroll
    for (int k = 0; k < Cn; ++k)
      if (c0 + k == beg) hh[k] = h1_first;

    // every fourth row, and after the last: the word row goes out as a run
    if ((i & 3) == 3 || i == n_rows - 1) {
#pragma unroll
      for (int k = 0; k < Cn; ++k) {
        ztile[c0 + k] = zacc[k];
        zacc[k] = 0;
      }
      __syncwarp();
      int32_t* zr = zl + (size_t)(i >> 2) * Lq;
      for (int idx = lane; idx < Lq; idx += 32) zr[idx] = ztile[idx];
      __syncwarp();
    }
  }

  {  // score = h[qlen]: one thread owns it
    const int owner = min(qlen / Cn, 31);
    const int idx = qlen - owner * Cn;
    if (lane == owner) {
      int v = hx;
#pragma unroll
      for (int k = 0; k < Cn; ++k)
        if (k == idx) v = hh[k];
      score[b] = v;
    }
  }

  if constexpr (!FUSED) {
    // the word rows at and past the target's end hold 0
    for (int r = (n_rows + 3) >> 2; r < Lt4; ++r) {
      int32_t* zr = zl + (size_t)r * Lq;
      for (int idx = lane; idx < Lq; idx += 32) zr[idx] = 0;
    }
  } else {
    // the traceback, by one thread, over the words the warp has just written
    __syncwarp();
    int n = 0;
    if (lane == 0) {
      Runs r(sops, max_ops);
      // a row past the last is out of contract; read the last instead
      walk([&](int wr, int k) { return __ldcg(zl + (size_t)min(wr, Lt4 - 1) * Lq + k); },
           qlen, tlen_raw, w_raw, r);
      n = r.n;
      n_ops[b] = r.n;
      ov[b] = r.ov ? 1 : 0;
    }
    __syncwarp();
    n = __shfl_sync(FULL, n, 0);
    for (int idx = lane; idx < max_ops; idx += 32) {
      const int src = min(max(n - 1 - idx, 0), max_ops - 1);
      ops[(size_t)idx * B + b] = idx < n ? sops[src] : 0;
    }
  }
}

// the traceback alone, one thread a lane, over a z of any strides (in words)
__global__ void global_traceback_kernel(
    const int32_t* __restrict__ z, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ wv,
    int32_t* __restrict__ ops, int32_t* __restrict__ n_ops,
    uint8_t* __restrict__ ov, int B, int max_ops, int64_t s_row,
    int64_t s_col, int64_t s_lane) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int buf[MAX_OPS];
  Runs r(buf, max_ops);
  const int32_t* zl = z + (int64_t)b * s_lane;
  walk([&](int wr, int k) { return zl[(int64_t)wr * s_row + (int64_t)k * s_col]; },
       qlens[b], tlens[b], wv[b], r);
  for (int idx = 0; idx < max_ops; ++idx) {
    const int src = min(max(r.n - 1 - idx, 0), max_ops - 1);
    ops[(size_t)idx * B + b] = idx < r.n ? buf[src] : 0;
  }
  n_ops[b] = r.n;
  ov[b] = r.ov ? 1 : 0;
}

// the dynamic shared memory of a block of instance C; for the wide instance
// 0 when a lane's row does not fit and lies in device scratch
template <int C>
int64_t smem_bytes(int Lq) {
  if (C == 0) return wide_shared_bytes(wide_words(Lq));
  return WARPS * warp_words(C) * (int64_t)sizeof(int32_t);
}

template <int C, bool FUSED>
int launch(const void* query, const void* target, const void* matb,
           const void* qlens, const void* tlens, const void* w, void* scratch,
           void* score, void* z, void* ops, void* n_ops, void* ov, int B,
           int Lq, int Lt, int code_bytes, int o_del, int e_del, int o_ins,
           int e_ins, int max_ops, void* stream) {
  const int64_t shared = smem_bytes<C>(Lq);
  static int64_t raised = 48 * 1024;
  if (shared == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (const int rc = raise_shared(sw_global_kernel<C, FUSED>, shared, raised))
    return rc;
  sw_global_kernel<C, FUSED><<<Shape<C>::blocks(B), Shape<C>::threads,
                               (size_t)shared, (cudaStream_t)stream>>>(
      query, target, (const int32_t*)matb, (const int32_t*)qlens,
      (const int32_t*)tlens, (const int32_t*)w,
      shared == 0 ? (int32_t*)scratch : nullptr, (int32_t*)score, (int32_t*)z,
      (int32_t*)ops, (int32_t*)n_ops, (uint8_t*)ov, B, Lq, Lt, code_bytes,
      o_del, e_del, o_ins, e_ins, max_ops);
  return (int)cudaGetLastError();
}

template <int C>
int resident(int Lq) {
  const int64_t shared = smem_bytes<C>(Lq);
  int64_t raised = 48 * 1024;
  int blocks = 0;
  if (raise_shared(sw_global_kernel<C, true>, shared, raised) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sw_global_kernel<C, true>, Shape<C>::threads,
          (size_t)shared) != cudaSuccess)
    return -1;
  return blocks * Shape<C>::threads / 32;
}

bool takes(int Lq, int C, int code_bytes) {
  return (C == 0 || Lq <= 32 * C) && (code_bytes == 1 || code_bytes == 4);
}

}  // namespace

// every instance of the strip width C; the wrapper picks the smallest with
// 32 * C >= Lq (ops/strip_scan.py keeps the same list), and the wide
// instance, C = 0, for a query wider than them all
#define FOR_EACH_C(X) X(2) X(4) X(5) X(6) X(8) X(12) X(16)

// the DP alone: score [B] and z, lane-major [B, ceil(Lt/4), Lq]. `scratch`
// is read only by the wide instance, and only when sw_global_scratch_words
// says a lane's row needs device memory: then it holds that many words a lane
extern "C" int sw_global(const void* query, const void* target,
                         const void* matb, const void* qlens,
                         const void* tlens, const void* w, void* scratch,
                         void* score, void* z, int B, int Lq, int Lt,
                         int code_bytes, int C, int o_del, int e_del,
                         int o_ins, int e_ins, void* stream) {
  if (!takes(Lq, C, code_bytes)) return (int)cudaErrorInvalidValue;
  switch (C) {
#define CASE(N)                                                             \
  case N:                                                                   \
    return launch<N, false>(query, target, matb, qlens, tlens, w, scratch, \
                            score, z, nullptr, nullptr, nullptr, B, Lq,    \
                            Lt, code_bytes, o_del, e_del, o_ins, e_ins, 0, \
                            stream);
    CASE(0)
    FOR_EACH_C(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// the DP and the traceback behind it in one launch; z is scratch
extern "C" int sw_global_cigar(const void* query, const void* target,
                               const void* matb, const void* qlens,
                               const void* tlens, const void* w,
                               void* scratch, void* score, void* z, void* ops,
                               void* n_ops, void* ov, int B, int Lq, int Lt,
                               int code_bytes, int C, int o_del, int e_del,
                               int o_ins, int e_ins, int max_ops,
                               void* stream) {
  if (!takes(Lq, C, code_bytes) || max_ops < 1 || max_ops > MAX_OPS)
    return (int)cudaErrorInvalidValue;
  switch (C) {
#define CASE(N)                                                            \
  case N:                                                                  \
    return launch<N, true>(query, target, matb, qlens, tlens, w, scratch, \
                           score, z, ops, n_ops, ov, B, Lq, Lt,           \
                           code_bytes, o_del, e_del, o_ins, e_ins,        \
                           max_ops, stream);
    CASE(0)
    FOR_EACH_C(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// device memory, in words a lane, that the wide instance needs at query
// width Lq: 0 while a lane's row fits shared memory
extern "C" int64_t sw_global_scratch_words(int Lq) {
  return wide_shared_bytes(wide_words(Lq)) ? 0 : wide_words(Lq);
}

// the traceback alone over z [Lt4, Lq, B] with the strides given in words
extern "C" int global_traceback(const void* z, const void* qlens,
                                const void* tlens, const void* w, void* ops,
                                void* n_ops, void* ov, int B, int max_ops,
                                int64_t s_row, int64_t s_col, int64_t s_lane,
                                void* stream) {
  if (max_ops < 1 || max_ops > MAX_OPS) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  global_traceback_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)qlens, (const int32_t*)tlens,
      (const int32_t*)w, (int32_t*)ops, (int32_t*)n_ops, (uint8_t*)ov, B,
      max_ops, s_row, s_col, s_lane);
  return (int)cudaGetLastError();
}

// warps (lanes of the batch) of the fused instance C that one SM holds at
// once (of the wide instance, C = 0, at query width Lq), -1 for no such
// instance
extern "C" int sw_global_resident_warps(int C, int Lq) {
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
