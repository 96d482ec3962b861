// K3 smem_seed: mem_collect_intv for a batch of lanes, a warp a lane, with
// K5 (occ4 and the bidirectional extend) inside it.
//
// Replaces the XLA log machine of the JAX device engine
// (biscuit_tpu/ops/seed_batch.py, `_collect_sm_log` over `smem4_pool_batch`)
// and its primitives `occ4_sel` and `extend_sel`. The TPU machine advances
// every lane of a pool by one extension per while_loop step, refills lanes
// from the pool, and streams seeds into an iteration-indexed log with caps
// (W stores per step, T2 pass-2 tasks, LOG_LEN steps) that exist only for
// XLA's fixed shapes. Here each warp runs the scalar mem_collect_intv of
// biscuit_tpu/align/smem.py (and native/align_host.cpp:1029-1400) for its
// own lane: pass 1 (smem1a from every restart), pass 2 (smem1a at the middle
// of each long pass-1 SMEM of at most split_width occurrences, with one
// occurrence more), pass 3 (seed_strategy1), then a stable sort of its rows
// by (start, end). The only capacity is S rows per lane: a lane that would
// store row S+1 stops, reports n = 0 and is flagged, which happens iff
// smem.collect_intv gives it more than S rows.
//
// What bounds it on an H100: the latency of a lane's chain while the card is
// not full, the warp schedulers' issue rate once it is. A lane is a chain of dependent
// extensions, each two gathers of a 32-byte (narrow) or 48-byte (wide) row
// of the fused occ+BWT table (seed_batch._fused_tab), at x-1 and x-1+s, and
// the next step's ranks depend on them: about 300 forward extensions and
// 100 to 1200 backward ones for a 150 bp read. A 5 Mbp index (two 10 MB
// strand tables) sits in the 50 MB L2, a 50 Mbp one does not. The bytes a
// lane must move are a few kilobytes; the card is as fast as it has chains
// in flight, as a chain has few steps, and as each step is short (about
// 250 issue slots a forward step: the popcounts of eight BWT words).
//
// What the design does about it:
//  * a warp owns a lane, so 8192 lanes are 8192 warps and every SM holds as
//    many chains as its registers and shared memory allow, each waiting for
//    its own round trip only. The lane's scalar state (positions, the open
//    interval, counts) is kept alike in every thread of the warp;
//  * a thread does a whole extension: it reads each of the two table rows
//    as two (wide: three) 16-byte words and counts in the BWT words itself,
//    so a step is one round trip with no shuffle in it. A lane alone on an
//    SM runs at the latency of its own dependent operations, so a step is
//    kept short: of occ4's four counts an extension by class c needs only
//    class c and the sum of the classes above it, two popcounts a word; the
//    cut at the
//    rank's base is two funnel shifts; occ4's edges (k < 0, k == seq_len)
//    are one rare branch behind the common path;
//  * in the backward loop of smem1a the intervals of `prev` are independent
//    extensions: thread j takes the j-th, so a round over up to 32 intervals
//    is one step of the chain where the scalar code makes one an interval.
//    The order-dependent part needs no serial loop either: within a round
//    only the first interval can be emitted (the rule asks for an empty
//    `curr` and, once a seed was emitted in the round, `last` equals the
//    round's start), and an extended interval is appended iff it is the
//    round's first or differs in size from the extended one before it, which
//    two ballots and one shuffle decide; the place in `curr` is a popcount;
//  * in the forward phase, which is strictly serial, every thread computes
//    the same extension (the loads are one transaction a warp), so the
//    answer needs no broadcast;
//  * the prev/curr interval lists live in shared memory, sized from L at
//    launch (2 * (L+1) intervals of 16 or 32 bytes a lane; a forward pass
//    pushes at most one interval a base), warps a block chosen so that the
//    most warps are resident. Only when one lane's lists exceed the shared
//    memory of an SM does the wrapper hand in device memory for them; no
//    read length is refused;
//  * the final sort is done by the warp: the rows are staged in the lists'
//    memory, each thread ranks its rows (rows with a smaller key, ties by
//    index: the stable order) and writes them to their place.
//
// What must match smem.collect_intv bit for bit: occ4's edges and the
// cut-off bases read as A; extend's `crosses` term and the b3..b0 order;
// L2[3 - c] of the other strand for the complement; smem1a's "shrank: keep
// the one before" and the reversal; the emit rule with `emitted`/`last`, in
// which seeds shorter than min_seed_len take part unseen;
// ns != curr[nc-1].s; pass 2's middle and size + 1; pass 3's ns > 0 store;
// start_width; codes > 3 ambiguous wherever they are tested. Narrow indexes
// (strands < 2^31) use int32 ranks and 8-column rows; wide ones int64 ranks
// and 12-column rows with split counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// intervals of `prev` a warp extends at once in smem1a's backward loop, one
// a thread; a longer list goes in chunks, its state carried over
constexpr int CHUNK = 32;
// shared memory an SM has for blocks, and what each block reserves besides
constexpr int64_t SM_SHARED = 233472, BLOCK_RESERVE = 1024;

template <typename R>
struct Intv {
  R x0, x1, s, end;
};

// nq the queried-axis rank, no the cumulative other axis (b3, b2, b1, b0 by
// class), ns the size
template <typename R>
struct Res {
  R nq, no, ns;
};

template <typename R, int W>
struct Index {
  const uint32_t* tab;  // both strands' fused rows, [2, n64, W]
  int64_t n64;
  R seq_len;
  const R (*L2)[5];  // [2][5], shared memory
  const R* prim;     // [2], shared memory
};

// What an extension by class c needs of K5's occ4 (seed_batch.occ4_sel) at
// rank k of strand `which`, k in [-1, seq_len], by one thread: eq, the count
// of class c in bwt[0..k], and gt, the count of the classes above c. The '$'
// row (rank primary) is not stored. pat is c in each of a word's 16 bases;
// m2, m3, m45 pick the bases above c (below). Threads of a warp that ask for
// the same row share one transaction.
template <typename R, int W>
__device__ __forceinline__ void occ_class(const Index<R, W>& ix, int which,
                                          R k, int c, uint32_t pat,
                                          uint32_t m2, uint32_t m3,
                                          uint32_t m45, R& eq, R& gt) {
  R kc = k < 0 ? (R)0 : k;
  if (kc > ix.seq_len - 1) kc = ix.seq_len - 1;
  const R kk = kc - (kc >= ix.prim[which] ? 1 : 0);
  const uint4* row = reinterpret_cast<const uint4*>(
      ix.tab + ((int64_t)which * ix.n64 + (int64_t)(kk >> 6)) * W);
  const uint4 r0 = __ldg(row), r1 = __ldg(row + 1);
  R cnt[4];
  uint32_t bw[4];
  if constexpr (W == 8) {
    cnt[0] = (R)r0.x, cnt[1] = (R)r0.y, cnt[2] = (R)r0.z, cnt[3] = (R)r0.w;
    bw[0] = r1.x, bw[1] = r1.y, bw[2] = r1.z, bw[3] = r1.w;
  } else {  // split counts: the low words, then the high words
    const uint4 r2 = __ldg(row + 2);
    cnt[0] = (R)((uint64_t)r0.x | ((uint64_t)r1.x << 32));
    cnt[1] = (R)((uint64_t)r0.y | ((uint64_t)r1.y << 32));
    cnt[2] = (R)((uint64_t)r0.z | ((uint64_t)r1.z << 32));
    cnt[3] = (R)((uint64_t)r0.w | ((uint64_t)r1.w << 32));
    bw[0] = r2.x, bw[1] = r2.y, bw[2] = r2.z, bw[3] = r2.w;
  }
  // the bases 0 .. pos of the row's 64, 16 a word from the top bits down;
  // the bases past pos are cut off: shifted out and back in as zeros
  const int pos = (int)(kk & 63);
  int n_eq = 0, n_gt = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned sh = (unsigned)max(32 * q + 30 - 2 * pos, 0);  // 32: none kept
    const uint32_t wm =
        __funnelshift_lc(0u, __funnelshift_rc(bw[q], 0u, sh), sh);
    const uint32_t x = wm ^ pat;  // a base of class c: both bits 0
    n_eq += __popc(~(x | (x >> 1)) & 0x55555555u);
    // above c: c = 0: hi | lo; 1: hi; 2: hi & lo; 3: none
    n_gt += __popc(((wm >> 1) | (wm & m2)) & (wm | m3) & m45);
  }
  // the cut-off bases read as A (class 0): they are not counted
  if (c == 0) n_eq -= 63 - pos;
  const R above3 = cnt[3], above2 = above3 + cnt[2], above1 = above2 + cnt[1];
  eq = (c == 0 ? cnt[0] : c == 1 ? cnt[1] : c == 2 ? cnt[2] : cnt[3]) + (R)n_eq;
  gt = (c == 0 ? above1 : c == 1 ? above2 : c == 2 ? above3 : (R)0) + (R)n_gt;
  if (k < 0 || k == ix.seq_len) {  // the edges: nothing, or the whole strand
    const R(*L2)[5] = ix.L2;
    eq = k < 0 ? (R)0 : L2[which][c + 1] - L2[which][c];
    gt = k < 0 ? (R)0 : L2[which][4] - L2[which][c + 1];
  }
}

// K5, seed_batch.extend_sel (bwt_extend), by one thread: class c of the
// interval (xq on strand `which`, xo on the other, size s). Of occ4's four
// counts at either end it needs class c and the sum of the classes above.
template <typename R, int W>
__device__ __forceinline__ Res<R> extend(const Index<R, W>& ix, int which,
                                         R xq, R xo, R s, int c) {
  const uint32_t pat = 0x55555555u * (uint32_t)c;
  const uint32_t m2 = c == 0 ? ~0u : 0u, m3 = c <= 1 ? ~0u : 0u,
                 m45 = c == 3 ? 0u : 0x55555555u;
  R tk, tk_gt, tl, tl_gt;
  occ_class(ix, which, xq - 1, c, pat, m2, m3, m45, tk, tk_gt);
  occ_class(ix, which, xq - 1 + s, c, pat, m2, m3, m45, tl, tl_gt);
  const R prim = ix.prim[which];
  Res<R> r;
  r.nq = ix.L2[which][c] + 1 + tk;
  r.no = xo + ((xq <= prim && xq + s - 1 >= prim) ? 1 : 0) + (tl_gt - tk_gt);
  r.ns = tl - tk;
  return r;
}

// the lane's state, alike in every thread of its warp
template <typename R, int W>
struct Lane {
  Index<R, W> ix;
  int lane;    // the thread in the warp
  int parent;  // strand `parent` answers backward extension, the other forward
  const int32_t* q;
  int len;
  Intv<R>* buf0;
  Intv<R>* buf1;
  R* rows;
  int n, S, msl;
  bool ov;
};

template <typename R, int W>
__device__ bool store(Lane<R, W>& ln, R start, R end, R x0, R x1, R s) {
  if (ln.n >= ln.S) {
    ln.ov = true;
    return false;
  }
  if (ln.lane < 5) {
    const int t = ln.lane;
    ln.rows[(int64_t)ln.n * 5 + t] =
        t == 0 ? start : t == 1 ? end : t == 2 ? x0 : t == 3 ? x1 : s;
  }
  ++ln.n;
  return true;
}

// bwt_smem1a with max_intv == 0 (smem.py:27-82); stores the seeds at least
// msl long and returns the end of the longest match from x.
template <typename R, int W>
__device__ int smem1a(Lane<R, W>& ln, int x, R min_intv) {
  const int32_t* q = ln.q;
  const int len = ln.len, lane = ln.lane;
  if (q[x] > 3) return x + 1;
  if (min_intv < 1) min_intv = 1;
  const int bwd = ln.parent, fwd = 1 - ln.parent;
  const R(*L2)[5] = ln.ix.L2;
  __syncwarp();  // the lists of the call before are read no more
  Intv<R>* curr = ln.buf0;
  int nc = 0;
  const int c0 = q[x];
  Intv<R> ik{L2[bwd][c0] + 1, L2[fwd][3 - c0] + 1,
             L2[bwd][c0 + 1] - L2[bwd][c0], (R)(x + 1)};
  int ret = x + 1;  // the end of the last interval pushed: the longest match
  int i = x + 1;
  // forward, strictly serial: every thread computes the same extension
  for (; i < len; ++i) {
    const int qi = q[i];
    if (qi > 3) {
      if (lane == 0) curr[nc] = ik;
      ++nc;
      ret = (int)ik.end;
      break;
    }
    const Res<R> r = extend(ln.ix, fwd, ik.x1, ik.x0, ik.s, 3 - qi);
    if (r.ns != ik.s) {  // the interval shrank: keep the one before
      if (lane == 0) curr[nc] = ik;
      ++nc;
      ret = (int)ik.end;
      if (r.ns < min_intv) break;
    }
    ik = Intv<R>{r.no, r.nq, r.ns, (R)(i + 1)};
  }
  if (i == len) {
    if (lane == 0) curr[nc] = ik;
    ++nc;
    ret = (int)ik.end;
  }
  __syncwarp();
  // backward: thread j extends the j-th interval of `prev`. The list is
  // read back to front in the first round (longest match first)
  Intv<R>* prev = curr;
  int np = nc;
  bool rev = true;
  curr = ln.buf1;
  bool emitted = false;
  int last = 0;  // start of the call's last emitted seed
  for (i = x - 1; i >= -1; --i) {
    const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
    nc = 0;
    R last_s = 0;  // the size of the round's last extended interval
    for (int base = 0; base < np; base += CHUNK) {
      const int j = base + lane;
      const bool valid = lane < CHUNK && j < np;
      const Intv<R> p = prev[valid ? (rev ? np - 1 - j : j) : 0];
      Res<R> r{0, 0, 0};
      if (c >= 0) r = extend(ln.ix, bwd, p.x0, p.x1, p.s, c);
      const bool ok = valid && c >= 0 && r.ns >= min_intv;  // it extends
      const unsigned okm = __ballot_sync(FULL, ok);
      // Emitted only with `curr` empty and left of the last seed: within a
      // round that can be the first interval alone (after it either `curr`
      // holds one, or `last` is this round's start, or the rule's second
      // half was false and stays so). Seeds shorter than msl take part in
      // the rule but are not stored
      if (base == 0 && !(okm & 1u) && (!emitted || i + 1 < last)) {
        emitted = true;
        last = i + 1;
        const Intv<R> p0 = prev[rev ? np - 1 : 0];
        if ((int)p0.end - (i + 1) >= ln.msl &&
            !store(ln, (R)(i + 1), p0.end, p0.x0, p0.x1, p0.s))
          return ret;
      }
      // appended iff the round's first to extend, or its size differs from
      // the one that extended before it (ns != curr[nc-1].s: an interval
      // that is not appended has the size of the last one that was)
      const unsigned below = okm & ((1u << lane) - 1u);
      const R before = __shfl_sync(FULL, r.ns, below ? 31 - __clz(below) : lane);
      const bool first = below == 0 && nc == 0;
      const bool app = ok && (first || r.ns != (below ? before : last_s));
      const unsigned appm = __ballot_sync(FULL, app);
      if (app)
        curr[nc + __popc(appm & ((1u << lane) - 1u))] =
            Intv<R>{r.nq, r.no, r.ns, p.end};
      if (okm) last_s = __shfl_sync(FULL, r.ns, 31 - __clz(okm));
      nc += __popc(appm);
    }
    if (nc == 0) break;
    __syncwarp();
    Intv<R>* t = prev;
    prev = curr;
    curr = t;
    np = nc;
    rev = false;
  }
  return ret;
}

// bwt_seed_strategy1 (smem.py:85-104); stores a seed with a nonzero interval
template <typename R, int W>
__device__ int strategy1(Lane<R, W>& ln, int x, R max_intv) {
  const int32_t* q = ln.q;
  const int bwd = ln.parent, fwd = 1 - ln.parent;
  const R(*L2)[5] = ln.ix.L2;
  const int c0 = q[x];
  R x0 = L2[bwd][c0] + 1, x1 = L2[fwd][3 - c0] + 1,
    s = L2[bwd][c0 + 1] - L2[bwd][c0];
  for (int i = x + 1; i < ln.len; ++i) {
    const int qi = q[i];
    if (qi > 3) return i + 1;
    const Res<R> r = extend(ln.ix, fwd, x1, x0, s, 3 - qi);
    if (r.ns < max_intv && i - x >= ln.msl) {
      if (r.ns > 0) store(ln, (R)x, (R)(i + 1), r.no, r.nq, r.ns);
      return i + 1;
    }
    x0 = r.no;
    x1 = r.nq;
    s = r.ns;
  }
  return ln.len;
}

template <typename R, int W>
__global__ void smem_seed_kernel(const uint32_t* __restrict__ tab,
                                 const int64_t* __restrict__ L2,
                                 const int64_t* __restrict__ primary,
                                 int64_t n64, int64_t seq_len,
                                 const int32_t* __restrict__ reads,
                                 const int32_t* __restrict__ lens,
                                 const int32_t* __restrict__ parents,
                                 int64_t B, int L, int msl, int split_len,
                                 int split_width, int max_mem_intv,
                                 int start_width, int S,
                                 unsigned char* scratch, int64_t work_bytes,
                                 R* rows, int32_t* __restrict__ n_out,
                                 bool* __restrict__ ov_out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ R sL2[2][5];
  __shared__ R sprim[2];
  if (threadIdx.x < 10) sL2[threadIdx.x / 5][threadIdx.x % 5] = (R)L2[threadIdx.x];
  if (threadIdx.x < 2) sprim[threadIdx.x] = (R)primary[threadIdx.x];
  __syncthreads();
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;  // a whole warp; no block-wide barrier from here on
  // the lane's lists and, after the passes, its sort's staging: in shared
  // memory, or in device memory where the wrapper had to hand it in
  unsigned char* work =
      scratch ? scratch + b * work_bytes : dyn + (size_t)wid * work_bytes;
  Lane<R, W> ln;
  ln.ix = Index<R, W>{tab, n64, (R)seq_len, sL2, sprim};
  ln.lane = lane;
  ln.parent = parents[b];
  ln.q = reads + b * L;
  ln.len = lens[b];
  ln.buf0 = reinterpret_cast<Intv<R>*>(work);
  ln.buf1 = ln.buf0 + (L + 1);
  ln.rows = rows + b * S * 5;
  ln.n = 0;
  ln.S = S;
  ln.msl = msl;
  ln.ov = false;
  const int32_t* q = ln.q;
  const int len = ln.len;

  // pass 1: all SMEMs
  for (int x = 0; x < len && !ln.ov;) {
    if (q[x] < 4) x = smem1a(ln, x, (R)start_width);
    else ++x;
  }
  // pass 2: re-seed inside long SMEMs with few occurrences; the rows were
  // written by threads 0-4 and are read through L2
  const int n1 = ln.n;
  __syncwarp();
  for (int k = 0; k < n1 && !ln.ov; ++k) {
    const R* r = ln.rows + (int64_t)k * 5;
    const R start = __ldcg(r), end = __ldcg(r + 1), size = __ldcg(r + 4);
    if (end - start < split_len || size > split_width) continue;
    smem1a(ln, (int)((start + end) >> 1), size + 1);
  }
  // pass 3: forward-only seeds
  if (max_mem_intv > 0) {
    for (int x = 0; x < len && !ln.ov;) {
      if (q[x] < 4) x = strategy1(ln, x, (R)max_mem_intv);
      else ++x;
    }
  }
  __syncwarp();
  if (!ln.ov) {
    // the stable sort by (start, end), smem.py:150: the rows are staged in
    // the lists' memory, each thread ranks its rows and writes them in place
    R* stage = reinterpret_cast<R*>(work);
    const int n = ln.n;
    for (int idx = lane; idx < n * 5; idx += 32) stage[idx] = __ldcg(ln.rows + idx);
    __syncwarp();
    for (int r = lane; r < n; r += 32) {
      const R ks = stage[r * 5], ke = stage[r * 5 + 1];
      int rank = 0;
      for (int o = 0; o < n; ++o) {
        const R os = stage[o * 5], oe = stage[o * 5 + 1];
        rank += (os < ks || (os == ks && (oe < ke || (oe == ke && o < r)))) ? 1 : 0;
      }
      for (int t = 0; t < 5; ++t) ln.rows[(int64_t)rank * 5 + t] = stage[r * 5 + t];
    }
  }
  if (lane == 0) {
    n_out[b] = ln.ov ? 0 : ln.n;
    ov_out[b] = ln.ov;
  }
}

// bytes of work memory a lane: its two lists, or its rows staged for the sort
template <typename R>
int64_t work_bytes(int L, int S) {
  const int64_t lists = 2 * ((int64_t)L + 1) * (int64_t)sizeof(Intv<R>);
  const int64_t stage = (int64_t)S * 5 * (int64_t)sizeof(R);
  const int64_t m = lists > stage ? lists : stage;
  return (m + 15) / 16 * 16;
}

// warps a block (4, 2 or 1) that keeps the most warps resident by shared
// memory; 0 when one lane's work memory does not fit an SM's
template <typename R>
int block_warps(int L, int S) {
  const int64_t wb = work_bytes<R>(L, S);
  int best = 0;
  int64_t best_warps = 0;
  for (int wpb = 4; wpb >= 1; wpb >>= 1) {
    const int64_t block = wpb * wb + BLOCK_RESERVE;
    if (block > SM_SHARED) continue;
    int64_t blocks = SM_SHARED / block;
    if (blocks > 32) blocks = 32;
    if (blocks * wpb > best_warps) {
      best_warps = blocks * wpb;
      best = wpb;
    }
  }
  return best;
}

template <typename R, int W>
int raise_shared(int64_t bytes) {
  static int64_t raised = 48 * 1024;  // above it shared memory is asked for
  if (bytes <= raised) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      smem_seed_kernel<R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (rc == cudaSuccess) raised = bytes;
  return (int)rc;
}

template <typename R, int W>
int launch(const void* tab, const void* L2, const void* primary, int64_t n64,
           int64_t seq_len, const void* reads, const void* lens,
           const void* parents, int64_t B, int L, int msl, int split_len,
           int split_width, int max_mem_intv, int start_width, int S,
           void* scratch, void* rows, void* n, void* ov, cudaStream_t stream) {
  const int64_t wb = work_bytes<R>(L, S);
  int wpb = block_warps<R>(L, S);
  int64_t shared = 0;
  if (wpb == 0) {  // the lists in device memory
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    wpb = 4;
  } else {
    scratch = nullptr;
    shared = wpb * wb;
    const int rc = raise_shared<R, W>(shared);
    if (rc != 0) return rc;
  }
  const int64_t blocks = (B + wpb - 1) / wpb;
  smem_seed_kernel<R, W><<<(unsigned)blocks, wpb * 32, (size_t)shared, stream>>>(
      (const uint32_t*)tab, (const int64_t*)L2, (const int64_t*)primary, n64,
      seq_len, (const int32_t*)reads, (const int32_t*)lens,
      (const int32_t*)parents, B, L, msl, split_len, split_width,
      max_mem_intv, start_width, S, (unsigned char*)scratch, wb, (R*)rows,
      (int32_t*)n, (bool*)ov);
  return (int)cudaGetLastError();
}

template <typename R, int W>
int resident(int L, int S) {
  const int wpb = block_warps<R>(L, S);
  const int64_t shared = wpb ? wpb * work_bytes<R>(L, S) : 0;
  int blocks = 0;
  if (raise_shared<R, W>(shared) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, smem_seed_kernel<R, W>, (wpb ? wpb : 4) * 32,
          (size_t)shared) != cudaSuccess)
    return -1;
  return blocks * (wpb ? wpb : 4);
}

}  // namespace

// `scratch` is read only when smem_seed_scratch_bytes says the lists of a
// lane need device memory: then it holds that many bytes a lane
extern "C" int smem_seed_narrow(const void* tab, const void* L2,
                                const void* primary, int64_t n64,
                                int64_t seq_len, const void* reads,
                                const void* lens, const void* parents,
                                int64_t B, int L, int msl, int split_len,
                                int split_width, int max_mem_intv,
                                int start_width, int S, void* scratch,
                                void* rows, void* n, void* ov, void* stream) {
  return launch<int32_t, 8>(tab, L2, primary, n64, seq_len, reads, lens,
                            parents, B, L, msl, split_len, split_width,
                            max_mem_intv, start_width, S, scratch, rows, n, ov,
                            (cudaStream_t)stream);
}

extern "C" int smem_seed_wide(const void* tab, const void* L2,
                              const void* primary, int64_t n64,
                              int64_t seq_len, const void* reads,
                              const void* lens, const void* parents, int64_t B,
                              int L, int msl, int split_len, int split_width,
                              int max_mem_intv, int start_width, int S,
                              void* scratch, void* rows, void* n, void* ov,
                              void* stream) {
  return launch<int64_t, 12>(tab, L2, primary, n64, seq_len, reads, lens,
                             parents, B, L, msl, split_len, split_width,
                             max_mem_intv, start_width, S, scratch, rows, n,
                             ov, (cudaStream_t)stream);
}

// device memory a lane needs for its lists: 0 while they fit shared memory
extern "C" int64_t smem_seed_scratch_bytes(int L, int S, int wide) {
  if (wide) return block_warps<int64_t>(L, S) ? 0 : work_bytes<int64_t>(L, S);
  return block_warps<int32_t>(L, S) ? 0 : work_bytes<int32_t>(L, S);
}

// shared memory a lane's lists take at read length L and S rows
extern "C" int64_t smem_seed_lane_bytes(int L, int S, int wide) {
  return wide ? work_bytes<int64_t>(L, S) : work_bytes<int32_t>(L, S);
}

// warps (lanes of the batch) that one SM holds at once at read length L and
// S rows, from the CUDA occupancy calculator
extern "C" int smem_seed_resident_warps(int L, int S, int wide) {
  return wide ? resident<int64_t, 12>(L, S) : resident<int32_t, 8>(L, S);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
