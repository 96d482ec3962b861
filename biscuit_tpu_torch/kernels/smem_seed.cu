// K3 smem_seed: mem_collect_intv for a batch of lanes, one thread per lane,
// with K5 (occ4 and the bidirectional extend) as device functions.
//
// Replaces the XLA log machine of the JAX device engine
// (biscuit_tpu/ops/seed_batch.py, `_collect_sm_log` over `smem4_pool_batch`)
// and its primitives `occ4_sel` and `extend_sel`. The TPU machine advances
// every lane of a pool by one extension per while_loop step, refills lanes
// from the pool, and streams seeds into an iteration-indexed log with caps
// (W stores per step, T2 pass-2 tasks, LOG_LEN steps) that exist only for
// XLA's fixed shapes. Here each thread runs the scalar mem_collect_intv of
// biscuit_tpu/align/smem.py (and native/align_host.cpp:1029-1400) for its
// own lane: pass 1 (smem1a from every restart), pass 2 (smem1a at the middle
// of each long pass-1 SMEM of at most split_width occurrences, with one
// occurrence more), pass 3 (seed_strategy1), then a stable insertion sort
// of its rows by (start, end). The only capacity is S rows per lane: a lane
// that would store row S+1 stops, reports n = 0 and is flagged, which
// happens iff smem.collect_intv gives it more than S rows. The prev/curr
// interval lists live in a [B, 2, L+1, 4] scratch; a forward pass pushes at
// most one interval per base, so L+1 slots never overflow.
//
// What bounds it on an H100: every extension step is two dependent loads of
// a 32-byte (narrow) or 48-byte (wide) row of the fused occ+BWT table
// (seed_batch._fused_tab), at x-1 and x-1+s, and the next step's ranks
// depend on them. A 5 Mbp index (two 10 MB strand tables together) sits in
// the 50 MB L2, a 50 Mbp one does not. The design keeps each lane's chain
// free of the other lanes (no lockstep, no refill): a warp waits only for
// its own 32 lanes, and 32-thread blocks spread a batch of 8192 lanes over
// all SMs. Narrow indexes (strands < 2^31) use int32 ranks and 8-column
// rows; wide ones int64 ranks and 12-column rows with split counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename R>
struct Intv {
  R x0, x1, s, end;
};

template <typename R, int W>
struct Strand {
  const uint32_t* tab;  // this strand's fused rows, n64 x W
  R prim, seq_len;
  R L2[5];
};

// K5 occ4 (seed_batch.occ4_sel): counts of each class in bwt[0..k],
// k in [-1, seq_len]; the '$' row (rank primary) is not stored.
template <typename R, int W>
__device__ __forceinline__ void occ4(const Strand<R, W>& f, R k, R out[4]) {
  if (k < 0) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  if (k == f.seq_len) {
    for (int c = 0; c < 4; ++c) out[c] = f.L2[c + 1] - f.L2[c];
    return;
  }
  if (k > f.seq_len - 1) k = f.seq_len - 1;
  const R kk = k - (k >= f.prim ? 1 : 0);
  const uint32_t* row = f.tab + (int64_t)(kk >> 6) * W;
  const int wi = (int)((kk >> 4) & 3);
  const int tl = (int)(~kk & 15);  // bases of word wi after position kk
  int cnt[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q > wi) break;
    uint32_t wm = row[W - 4 + q];
    if (q == wi) wm = (wm >> (tl << 1)) << (tl << 1);
    const uint32_t inv = ~wm;
    cnt[0] += __popc((inv >> 1) & inv & 0x55555555u);
    cnt[1] += __popc((inv >> 1) & wm & 0x55555555u);
    cnt[2] += __popc((wm >> 1) & inv & 0x55555555u);
    cnt[3] += __popc((wm >> 1) & wm & 0x55555555u);
  }
  cnt[0] -= tl;  // the cut-off bases read as A (code 0)
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    R acc;
    if constexpr (W == 12) {
      acc = (R)((uint64_t)row[c] | ((uint64_t)row[4 + c] << 32));
    } else {
      acc = (R)row[c];
    }
    out[c] = acc + cnt[c];
  }
}

// K5 extend (seed_batch.extend_sel, bwt_extend) for class c alone: xq is
// the rank on strand f, xo the other one. nq is the queried-axis rank, no
// the cumulative other axis (b3, b2, b1, b0 by class), ns the size.
template <typename R, int W>
__device__ __forceinline__ void extend(const Strand<R, W>& f, R xq, R xo,
                                       R s, int c, R& nq, R& no, R& ns) {
  R tk[4], tl[4];
  occ4(f, xq - 1, tk);
  occ4(f, xq - 1 + s, tl);
  nq = f.L2[c] + 1 + tk[c];
  R b = xo + ((xq <= f.prim && xq + s - 1 >= f.prim) ? 1 : 0);
  for (int d = 3; d > c; --d) b += tl[d] - tk[d];
  no = b;
  ns = tl[c] - tk[c];
}

template <typename R, int W>
struct Lane {
  Strand<R, W> fm;   // bwt[parent]: backward extension
  Strand<R, W> fmc;  // bwt[1 - parent]: forward extension
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
  R* r = ln.rows + (int64_t)ln.n * 5;
  r[0] = start;
  r[1] = end;
  r[2] = x0;
  r[3] = x1;
  r[4] = s;
  ++ln.n;
  return true;
}

// bwt_smem1a with max_intv == 0 (smem.py:27-82); stores the seeds at least
// msl long and returns the end of the longest match from x.
template <typename R, int W>
__device__ int smem1a(Lane<R, W>& ln, int x, R min_intv) {
  const int32_t* q = ln.q;
  const int len = ln.len;
  if (q[x] > 3) return x + 1;
  if (min_intv < 1) min_intv = 1;
  Intv<R>* curr = ln.buf0;
  int nc = 0;
  const int c0 = q[x];
  Intv<R> ik{ln.fm.L2[c0] + 1, ln.fmc.L2[3 - c0] + 1,
             ln.fm.L2[c0 + 1] - ln.fm.L2[c0], (R)(x + 1)};
  int i = x + 1;
  for (; i < len; ++i) {
    const int qi = q[i];
    if (qi > 3) {
      curr[nc++] = ik;
      break;
    }
    R nq, no, ns;
    extend(ln.fmc, ik.x1, ik.x0, ik.s, 3 - qi, nq, no, ns);
    if (ns != ik.s) {  // the interval shrank: keep the one before
      curr[nc++] = ik;
      if (ns < min_intv) break;
    }
    ik = Intv<R>{no, nq, ns, (R)(i + 1)};
  }
  if (i == len) curr[nc++] = ik;
  for (int a = 0, b = nc - 1; a < b; ++a, --b) {  // longest match first
    const Intv<R> t = curr[a];
    curr[a] = curr[b];
    curr[b] = t;
  }
  const int ret = (int)curr[0].end;
  Intv<R>* prev = curr;
  int np = nc;
  curr = ln.buf1;
  bool emitted = false;
  int last = 0;  // start of the call's last emitted seed
  for (i = x - 1; i >= -1; --i) {
    const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
    nc = 0;
    for (int j = 0; j < np; ++j) {
      const Intv<R> p = prev[j];
      R nq = 0, no = 0, ns = 0;
      bool dies = true;
      if (c >= 0) {
        extend(ln.fm, p.x0, p.x1, p.s, c, nq, no, ns);
        dies = ns < min_intv;
      }
      if (dies) {
        // emitted only with curr empty and left of the last seed; seeds
        // shorter than msl take part in this rule but are not stored
        if (nc == 0 && (!emitted || i + 1 < last)) {
          emitted = true;
          last = i + 1;
          if ((int)p.end - (i + 1) >= ln.msl &&
              !store(ln, (R)(i + 1), p.end, p.x0, p.x1, p.s))
            return ret;
        }
      } else if (nc == 0 || ns != curr[nc - 1].s) {
        curr[nc++] = Intv<R>{nq, no, ns, p.end};
      }
    }
    if (nc == 0) break;
    Intv<R>* t = prev;
    prev = curr;
    curr = t;
    np = nc;
  }
  return ret;
}

// bwt_seed_strategy1 (smem.py:85-104); stores a seed with a nonzero interval
template <typename R, int W>
__device__ int strategy1(Lane<R, W>& ln, int x, R max_intv) {
  const int32_t* q = ln.q;
  const int c0 = q[x];
  R x0 = ln.fm.L2[c0] + 1, x1 = ln.fmc.L2[3 - c0] + 1,
    s = ln.fm.L2[c0 + 1] - ln.fm.L2[c0];
  for (int i = x + 1; i < ln.len; ++i) {
    const int qi = q[i];
    if (qi > 3) return i + 1;
    R nq, no, ns;
    extend(ln.fmc, x1, x0, s, 3 - qi, nq, no, ns);
    if (ns < max_intv && i - x >= ln.msl) {
      if (ns > 0) store(ln, (R)x, (R)(i + 1), no, nq, ns);
      return i + 1;
    }
    x0 = no;
    x1 = nq;
    s = ns;
  }
  return ln.len;
}

template <typename R, int W>
__device__ Strand<R, W> strand(const uint32_t* tab, const int64_t* L2,
                               const int64_t* primary, int64_t n64,
                               int64_t seq_len, int which) {
  Strand<R, W> f;
  f.tab = tab + (int64_t)which * n64 * W;
  f.prim = (R)primary[which];
  f.seq_len = (R)seq_len;
  for (int c = 0; c < 5; ++c) f.L2[c] = (R)L2[which * 5 + c];
  return f;
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
                                 int start_width, int S, R* scratch, R* rows,
                                 int32_t* n_out, bool* ov_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int parent = parents[b];
  Lane<R, W> ln;
  ln.fm = strand<R, W>(tab, L2, primary, n64, seq_len, parent);
  ln.fmc = strand<R, W>(tab, L2, primary, n64, seq_len, 1 - parent);
  ln.q = reads + b * L;
  ln.len = lens[b];
  ln.buf0 = reinterpret_cast<Intv<R>*>(scratch + b * 2 * (L + 1) * 4);
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
  // pass 2: re-seed inside long SMEMs with few occurrences
  const int n1 = ln.n;
  for (int k = 0; k < n1 && !ln.ov; ++k) {
    const R* r = ln.rows + (int64_t)k * 5;
    const R start = r[0], end = r[1], size = r[4];
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
  if (!ln.ov) {  // stable insertion sort by (start, end), smem.py:150
    for (int a = 1; a < ln.n; ++a) {
      R cur[5];
      for (int t = 0; t < 5; ++t) cur[t] = ln.rows[(int64_t)a * 5 + t];
      int j = a - 1;
      while (j >= 0) {
        const R* r = ln.rows + (int64_t)j * 5;
        if (r[0] < cur[0] || (r[0] == cur[0] && r[1] <= cur[1])) break;
        for (int t = 0; t < 5; ++t) ln.rows[(int64_t)(j + 1) * 5 + t] = r[t];
        --j;
      }
      for (int t = 0; t < 5; ++t) ln.rows[(int64_t)(j + 1) * 5 + t] = cur[t];
    }
  }
  n_out[b] = ln.ov ? 0 : ln.n;
  ov_out[b] = ln.ov;
}

template <typename R, int W>
int launch(const void* tab, const void* L2, const void* primary, int64_t n64,
           int64_t seq_len, const void* reads, const void* lens,
           const void* parents, int64_t B, int L, int msl, int split_len,
           int split_width, int max_mem_intv, int start_width, int S,
           void* scratch, void* rows, void* n, void* ov, cudaStream_t stream) {
  const int threads = 32;  // one warp a block: a small batch still spreads
  const int64_t blocks = (B + threads - 1) / threads;
  smem_seed_kernel<R, W><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint32_t*)tab, (const int64_t*)L2, (const int64_t*)primary, n64,
      seq_len, (const int32_t*)reads, (const int32_t*)lens,
      (const int32_t*)parents, B, L, msl, split_len, split_width,
      max_mem_intv, start_width, S, (R*)scratch, (R*)rows, (int32_t*)n,
      (bool*)ov);
  return (int)cudaGetLastError();
}

}  // namespace

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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
