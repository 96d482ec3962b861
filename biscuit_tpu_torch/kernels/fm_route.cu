// K10's routed walks: the seeder (mem_collect_intv, K3's function) and the
// bwt_sa walk (K4's) over FM tables sharded row-contiguously across the
// ranks of an `idx` process group, one kernel launch and one collective a
// step.
//
// Replaces the index-sharded route of the JAX device engine:
// `_collect_flat_index_sharded` (biscuit_tpu/ops/seed_batch.py:2097) and the
// routed gather of `_tab_row` (:265-289) that every row read of its machines
// goes through inside a shard_map. There each row read is a masked local
// gather followed by a psum over `idx`, in the middle of an XLA while_loop.
// A CUDA kernel cannot make a collective call in the middle of a walk, so
// the walk is cut at its row reads:
//
//  * smem_route_step / sa_route_step advance every lane by one step on the
//    rows it asked for at the step before, run on until the lane needs
//    rows again, and in the same launch write the rows of that next ask
//    which this shard owns into the lane's slots of the step buffer, zeros
//    for the rows another shard owns (the source's masked gather), with the
//    count of rows asked a lane;
//  * between launches the wrapper (seed_batch._step_loop) sums the asked
//    slots of the buffer over the idx group, the source's psum: exactly one
//    shard owns each row, so every rank of the group gets every row, and
//    the ranks, which hold the same lanes, stay in lockstep.
//
// What bounds it on an H100: not the card. A step moves a few table rows
// (32 or 48 bytes each) a lane and does a few hundred integer operations a
// row; the collective between steps takes the step's time. So the design
// cuts the number of steps and what a step costs besides its collective:
//
//  * the seeder gives a warp a lane (K3's layout, kernels/smem_seed.cu):
//    a step is a base, not an extension. In smem1a's backward phase a base
//    extends every interval of the list at once: thread j of the warp
//    answers interval j (j + 32, ... beyond 32, in the same step), and the
//    ask of the next base is the two rows of every live interval, 2 (L + 1)
//    slots a lane at most. The forward phase, passes 2 and 3 take one
//    extension a base, as the read dictates;
//  * the machine itself (the control flow between asks) runs in thread 0
//    with the lane's state in registers, loaded from and stored to device
//    memory once a launch; the answers, and the gather of the next ask's
//    rows, are spread over the warp's threads;
//  * no separate gather launch: the step kernels write the owned rows
//    themselves (route_gather stays for the SA samples at a walk's end);
//  * no host read of a live count after every launch: a lane's count of
//    rows asked lies beside the buffer, with its running total over the
//    walk's steps (read once, at the walk's end); the gloo path, which
//    crosses the host every step anyway, reads the counts there, and the
//    nccl path reads them once every few steps (seed_batch.ROUTE_SYNC_EVERY),
//    a finished lane's step being a no-op.
//
// The lane's machine is smem.collect_intv written as a state machine: pass
// 1 (smem1a from every restart), pass 2 (smem1a in the middle of each long
// pass-1 SMEM of at most split_width occurrences, asking for one occurrence
// more), pass 3 (seed_strategy1), then a stable sort of the lane's rows by
// (start, end). Its arithmetic is the plain machine's (seed_batch._occ4,
// _extend, _inv_psi_plain) in int64, whatever the rank dtype: occ4's edges
// (k < 0, k == seq_len) and the cut-off bases read as A; extend's `crosses`
// term and the b3..b0 order; smem1a's "shrank: keep the one before", the
// reversal, and the emit rule with `emitted`/`last`, in which seeds shorter
// than min_seed_len take part unseen; ns != curr[nc-1].s; pass 3's ns > 0
// store. A lane that would store row S+1 stops and is flagged, as in K3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t M55 = 0x55555555u;
constexpr int THREADS = 128;             // a block: 4 warps, so 4 lanes of the seeder
constexpr int LANES = THREADS / 32;

struct Intv {
  int64_t x0, x1, s, end;
};

// the tables' constants: L2 [2][5], primary [2], seq_len, rows a strand
struct Consts {
  const int64_t* L2;
  const int64_t* prim;
  int64_t seq_len, n64;
};

// this rank's shard: rows [lo, lo + rows) of the [2 * n64, W] flattened table
struct Shard {
  const uint32_t* tab;
  int64_t lo, rows;
};

// The fused row of rank k on strand `which` (seed_batch._occ4's kk >> 6),
// as a global row id of the [2 * n64, W] flattened table.
__device__ __forceinline__ int64_t occ_row_id(const Consts& cx, int which,
                                              int64_t k) {
  int64_t ks = k < 0 ? 0 : k;
  if (ks > cx.seq_len - 1) ks = cx.seq_len - 1;
  const int64_t kk = ks - (ks >= cx.prim[which] ? 1 : 0);
  return (int64_t)which * cx.n64 + (kk >> 6);
}

// word w of global row id g where this shard owns it, else 0
template <int W>
__device__ __forceinline__ uint32_t owned_word(const Shard& sh, int64_t g,
                                               int w) {
  const int64_t r = g - sh.lo;
  return (r >= 0 && r < sh.rows) ? sh.tab[r * W + w] : 0u;
}

// seed_batch._occ4 of rank k on strand `which`, from its fused row: the
// counts of each class in bwt[0..k].
template <int W>
__device__ void occ4(const Consts& cx, const uint32_t* row, int which,
                     int64_t k, int64_t out[4]) {
  int64_t ks = k < 0 ? 0 : k;
  if (ks > cx.seq_len - 1) ks = cx.seq_len - 1;
  const int64_t kk = ks - (ks >= cx.prim[which] ? 1 : 0);
  for (int c = 0; c < 4; ++c) {
    out[c] = (int64_t)row[c];
    if (W == 12) out[c] |= (int64_t)row[4 + c] << 32;
  }
  const int wi = (int)((kk >> 4) & 3);
  const int tl = (int)((~kk) & 15);
  const int sh = tl << 1;
  for (int q = 0; q <= wi; ++q) {
    const uint32_t w4 = row[W - 4 + q];
    const uint32_t wm = q == wi ? (w4 >> sh) << sh : w4;  // cut after kk
    const uint32_t inv = ~wm, lo = wm & M55;
    out[0] += __popc((inv >> 1) & inv & M55) - (q == wi ? tl : 0);
    out[1] += __popc((inv >> 1) & lo);
    out[2] += __popc((wm >> 1) & inv & M55);
    out[3] += __popc((wm >> 1) & lo);
  }
  const int64_t* L2 = cx.L2 + which * 5;
  for (int c = 0; c < 4; ++c) {
    if (k == cx.seq_len) out[c] = L2[c + 1] - L2[c];
    if (k < 0) out[c] = 0;
  }
}

// ---------------------------------------------------------------------------
// the seeder
// ---------------------------------------------------------------------------

// an extension's answer: the new rank on the queried strand, on the other,
// and the size
struct Ext {
  int64_t nq, no, ns;
};

// bwt_extend's class c of the interval (xq on strand `which`, xo on the
// other, size s), seed_batch._extend, from the rows at ranks xq - 1 and
// xq - 1 + s
template <int W>
__device__ Ext extend(const Consts& cx, const uint32_t* rows, int which,
                      int64_t xq, int64_t xo, int64_t s, int c) {
  int64_t tk[4], tl[4];
  occ4<W>(cx, rows, which, xq - 1, tk);
  occ4<W>(cx, rows + W, which, xq - 1 + s, tl);
  const int64_t prim = cx.prim[which];
  const int64_t b3 = xo + ((xq <= prim && xq + s - 1 >= prim) ? 1 : 0);
  const int64_t b2 = b3 + (tl[3] - tk[3]);
  const int64_t b1 = b2 + (tl[2] - tk[2]);
  const int64_t b0 = b1 + (tl[1] - tk[1]);
  return Ext{cx.L2[which * 5 + c] + 1 + tk[c],
             c == 0 ? b0 : c == 1 ? b1 : c == 2 ? b2 : b3, tl[c] - tk[c]};
}

// the lane's state; all zero is the start of pass 1
enum : int {
  P1 = 0,     // pass 1: the next restart
  P2,         // pass 2: the next pass-1 row
  P3,         // pass 3: the next start of seed_strategy1
  SMEM,       // smem1a: its start at sx
  FWD,        //   ... the next forward extension
  FWD_R,      //   ... its answer
  BACK,       //   ... the backward pass's start
  ROUND,      //   ... a backward round at base i: ask for every interval
  ROUND_R,    //   ... the round's answers, every interval of prev
  RET,        //   ... returned ret to its caller
  STR,        // seed_strategy1: the next extension
  STR_R,      //   ... its answer
  FINISH,     // sort and write
  DONE
};

struct SeedLane {
  int state, wait, m, caller;
  int x, k, n1, n, ov;
  // smem1a
  int sx, i, c, nc, np, rev, emitted, last, ret, cur;
  int64_t min_intv;
  Intv ik;
  // seed_strategy1
  int64_t x0, x1, s;
  // a single extension asked (wait with m == 1 outside ROUND_R): strand,
  // ranks, class; and its answer
  int ew, ec;
  int64_t exq, exo, es;
  Ext e;
};

struct SeedArgs {
  Consts cx;
  Shard sh;
  const int32_t* reads;
  const int32_t* lens;
  const int32_t* parents;
  int64_t B;
  int L, msl, split_len, split_width, max_intv, start_width, S;
};

__device__ __forceinline__ void ask(SeedLane& st, int which, int64_t xq,
                                    int64_t xo, int64_t s, int c, int next) {
  st.ew = which;
  st.exq = xq;
  st.exo = xo;
  st.es = s;
  st.ec = c;
  st.state = next;
  st.m = 1;
  st.wait = 1;
}

template <typename R>
__device__ bool store(SeedLane& st, R* rows, int S, int64_t start,
                      int64_t end, int64_t x0, int64_t x1, int64_t s) {
  if (st.n >= S) {
    st.ov = 1;
    return false;
  }
  R* r = rows + (int64_t)st.n * 5;
  r[0] = (R)start, r[1] = (R)end, r[2] = (R)x0, r[3] = (R)x1, r[4] = (R)s;
  ++st.n;
  return true;
}

// Thread 0's part of a step: the lane's machine from its answers (in
// st.e, or in the first words of each slot pair of `slots` for a round) to
// its next ask or its end.
template <typename R, int W>
__device__ void seed_lane(const SeedArgs& a, SeedLane& st, int64_t b,
                          const uint32_t* slots, Intv* lists, R* rows,
                          int32_t* n_out, bool* ov_out) {
  const int32_t* q = a.reads + b * a.L;
  const int len = a.lens[b];
  const int bwd = a.parents[b], fwd = 1 - bwd;
  const int64_t* L2 = a.cx.L2;
  Intv* buf[2] = {lists, lists + (a.L + 1)};
  st.wait = 0;
  st.m = 0;
  while (!st.wait && st.state != DONE) {
    switch (st.state) {
      case P1:
        if (st.ov) {
          st.state = FINISH;
        } else if (st.x >= len) {
          st.n1 = st.n;
          st.k = 0;
          st.state = P2;
        } else if (q[st.x] > 3) {
          ++st.x;
        } else {
          st.caller = P1;
          st.sx = st.x;
          st.min_intv = a.start_width;
          st.state = SMEM;
        }
        break;
      case P2:
        if (st.ov) {
          st.state = FINISH;
        } else if (st.k >= st.n1) {
          st.x = 0;
          st.state = a.max_intv > 0 ? P3 : FINISH;
        } else {
          const R* r = rows + (int64_t)st.k * 5;
          const int64_t start = r[0], end = r[1], size = r[4];
          if (end - start < a.split_len || size > a.split_width) {
            ++st.k;
          } else {
            st.caller = P2;
            st.sx = (int)((start + end) >> 1);
            st.min_intv = size + 1;
            st.state = SMEM;
          }
        }
        break;
      case SMEM: {  // bwt_smem1a from sx (smem.py:22-82)
        const int x = st.sx;
        if (q[x] > 3) {  // returns x + 1 with no seed
          st.ret = x + 1;
          st.state = RET;
          break;
        }
        if (st.min_intv < 1) st.min_intv = 1;
        const int c0 = q[x];
        st.ik = Intv{L2[bwd * 5 + c0] + 1, L2[fwd * 5 + 3 - c0] + 1,
                     L2[bwd * 5 + c0 + 1] - L2[bwd * 5 + c0], (int64_t)(x + 1)};
        st.nc = 0;
        st.i = x + 1;
        st.state = FWD;
        break;
      }
      case FWD:  // forward: record the interval at every size change
        if (st.i < len && q[st.i] < 4) {
          ask(st, fwd, st.ik.x1, st.ik.x0, st.ik.s, 3 - q[st.i], FWD_R);
        } else {  // an ambiguous base or the read's end: keep ik, go back
          buf[st.cur][st.nc++] = st.ik;
          st.ret = (int)st.ik.end;
          st.state = BACK;
        }
        break;
      case FWD_R:
        if (st.e.ns != st.ik.s) {  // the interval shrank: keep the one before
          buf[st.cur][st.nc++] = st.ik;
          st.ret = (int)st.ik.end;
          if (st.e.ns < st.min_intv) {
            st.state = BACK;
            break;
          }
        }
        st.ik = Intv{st.e.no, st.e.nq, st.e.ns, (int64_t)(st.i + 1)};
        ++st.i;
        st.state = FWD;
        break;
      case BACK:  // backward: prev is the forward list, longest first
        st.np = st.nc;
        st.rev = 1;
        st.cur ^= 1;
        st.emitted = 0;
        st.last = 0;
        st.i = st.sx - 1;
        st.state = ROUND;
        break;
      case ROUND:  // base i extends every interval of prev: one ask for all
        if (st.i < -1) {
          st.state = RET;
          break;
        }
        st.c = (st.i < 0 || q[st.i] > 3) ? -1 : q[st.i];
        st.nc = 0;
        st.state = ROUND_R;
        if (st.c >= 0) {
          st.m = st.np;
          st.wait = 1;
        }
        break;
      case ROUND_R: {  // prev's intervals in order, each with its answer
        const Intv* prev = buf[st.cur ^ 1];
        Intv* curr = buf[st.cur];
        bool over = false;
        for (int j = 0; j < st.np && !over; ++j) {
          const Intv p = prev[st.rev ? st.np - 1 - j : j];
          Ext e{0, 0, 0};
          bool keep = st.c < 0;
          if (!keep) {
            const int64_t* ans = (const int64_t*)(slots + (int64_t)2 * j * W);
            e = Ext{ans[0], ans[1], ans[2]};
            keep = e.ns < st.min_intv;
          }
          if (keep) {
            // emitted only with curr empty, left of the last seed
            if (st.nc == 0 && (!st.emitted || st.i + 1 < st.last)) {
              st.emitted = 1;
              st.last = st.i + 1;
              if (p.end - (st.i + 1) >= a.msl &&
                  !store<R>(st, rows, a.S, st.i + 1, p.end, p.x0, p.x1, p.s))
                over = true;
            }
          } else if (st.nc == 0 || e.ns != curr[st.nc - 1].s) {
            curr[st.nc++] = Intv{e.nq, e.no, e.ns, p.end};
          }
        }
        if (over) {
          st.state = FINISH;
        } else if (st.nc == 0) {  // the round's end
          st.state = RET;
        } else {
          st.cur ^= 1;  // prev = curr
          st.np = st.nc;
          st.rev = 0;
          --st.i;
          st.state = ROUND;
        }
        break;
      }
      case RET:  // smem1a returned ret
        if (st.caller == P1) st.x = st.ret;
        else ++st.k;
        st.state = st.caller;
        break;
      case P3:
        if (st.ov || st.x >= len) {
          st.state = FINISH;
        } else if (q[st.x] > 3) {
          ++st.x;
        } else {  // bwt_seed_strategy1 from x (smem.py:85-104)
          const int c0 = q[st.x];
          st.x0 = L2[bwd * 5 + c0] + 1;
          st.x1 = L2[fwd * 5 + 3 - c0] + 1;
          st.s = L2[bwd * 5 + c0 + 1] - L2[bwd * 5 + c0];
          st.sx = st.x;
          st.i = st.x + 1;
          st.state = STR;
        }
        break;
      case STR:
        if (st.i >= len) {
          st.x = len;
          st.state = P3;
        } else if (q[st.i] > 3) {
          st.x = st.i + 1;
          st.state = P3;
        } else {
          ask(st, fwd, st.x1, st.x0, st.s, 3 - q[st.i], STR_R);
        }
        break;
      case STR_R:
        if (st.e.ns < a.max_intv && st.i - st.sx >= a.msl) {
          if (st.e.ns > 0)
            store<R>(st, rows, a.S, st.sx, st.i + 1, st.e.no, st.e.nq,
                     st.e.ns);
          st.x = st.i + 1;
          st.state = P3;
        } else {
          st.x0 = st.e.no;
          st.x1 = st.e.nq;
          st.s = st.e.ns;
          ++st.i;
          st.state = STR;
        }
        break;
      case FINISH: {
        // the stable sort by (start, end), smem.py:150: insertion
        const int n = st.ov ? 0 : st.n;
        for (int r = 1; r < n; ++r) {
          R t[5];
          for (int u = 0; u < 5; ++u) t[u] = rows[(int64_t)r * 5 + u];
          int o = r;
          while (o > 0 && (rows[(int64_t)(o - 1) * 5] > t[0] ||
                           (rows[(int64_t)(o - 1) * 5] == t[0] &&
                            rows[(int64_t)(o - 1) * 5 + 1] > t[1]))) {
            for (int u = 0; u < 5; ++u)
              rows[(int64_t)o * 5 + u] = rows[(int64_t)(o - 1) * 5 + u];
            --o;
          }
          for (int u = 0; u < 5; ++u) rows[(int64_t)o * 5 + u] = t[u];
        }
        n_out[b] = n;
        ov_out[b] = st.ov != 0;
        st.state = DONE;
        break;
      }
      default:
        st.state = DONE;
    }
  }
}

// One step of every lane, a warp a lane. `slots`: the lane's 2 (L + 1) rows
// of W words in the step buffer, holding on entry the rows it asked for,
// summed over the group, and on return the owned rows of its next ask;
// cnt[b]: the rows asked (0: the lane is done), added to cnt[B + b], the
// lane's rows asked over the walk.
template <typename R, int W>
__global__ void __launch_bounds__(THREADS)
smem_route_step_kernel(SeedArgs a, SeedLane* states, uint32_t* buf,
                       int32_t* cnt, Intv* lists, R* rows, int32_t* n_out,
                       bool* ov_out) {
  const int t = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * LANES + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp
  SeedLane* sp = states + b;
  uint32_t* slots = buf + b * 2 * (int64_t)(a.L + 1) * W;
  Intv* lb = lists + b * 2 * (int64_t)(a.L + 1);
  const int bwd = a.parents[b];
  // 1. a round's answers, a thread an interval, each into the first words
  // of its own slot pair (its rows are read first)
  if (sp->wait && sp->state == ROUND_R) {
    const int np = sp->np, rev = sp->rev, c = sp->c;
    const Intv* prev = lb + (sp->cur ^ 1) * (a.L + 1);
    for (int j = t; j < np; j += 32) {
      const Intv p = prev[rev ? np - 1 - j : j];
      uint32_t* pair = slots + (int64_t)2 * j * W;
      const Ext e = extend<W>(a.cx, pair, bwd, p.x0, p.x1, p.s, c);
      int64_t* ans = (int64_t*)pair;
      ans[0] = e.nq, ans[1] = e.no, ans[2] = e.ns;
    }
  }
  __syncwarp();
  // 2. the machine, thread 0, its state in registers for the step
  if (t == 0) {
    SeedLane st = *sp;
    if (st.state == DONE) {
      st.wait = 0;
    } else {
      if (st.wait && st.state != ROUND_R)
        st.e = extend<W>(a.cx, slots, st.ew, st.exq, st.exo, st.es, st.ec);
      seed_lane<R, W>(a, st, b, slots, lb, rows + b * a.S * 5, n_out, ov_out);
      *sp = st;
    }
    const int32_t c = st.wait ? 2 * st.m : 0;
    cnt[b] = c;
    cnt[a.B + b] += c;
  }
  __syncwarp();
  // 3. the next ask's rows this shard owns, a thread a word: extension e
  // takes slots 2e (rank xq - 1) and 2e + 1 (rank xq - 1 + s)
  if (!sp->wait) return;
  const int m = sp->m;
  const bool round = sp->state == ROUND_R;
  const int np = sp->np, rev = sp->rev, ew = sp->ew;
  const int64_t exq = sp->exq, es = sp->es;
  const Intv* prev = lb + (sp->cur ^ 1) * (a.L + 1);
  for (int u = t; u < m * 2 * W; u += 32) {
    const int e = u / (2 * W), h = (u / W) & 1, w = u % W;
    int which = ew;
    int64_t xq = exq, s = es;
    if (round) {
      const Intv p = prev[rev ? np - 1 - e : e];
      which = bwd, xq = p.x0, s = p.s;
    }
    slots[u] = owned_word<W>(a.sh, occ_row_id(a.cx, which, xq - 1 + (h ? s : 0)),
                             w);
  }
}

// ---------------------------------------------------------------------------
// the SA walk
// ---------------------------------------------------------------------------

// A thread a job. mode 0: start at k; 1: one inverse-Psi step from the two
// rows in the job's slots (the BWT character's row, the occ row), where the
// rank is not a multiple of sa_intv. Both then write the owned rows of the
// next step into the slots (cnt 2, added to the job's total cnt[n + i]), or
// ask for the SA sample (cnt 0).
// mode 2: the position, steps + sample.
template <typename R, int W>
__global__ void sa_route_step_kernel(Consts cx, Shard sh, const int32_t* which,
                                     const R* k, int64_t n, int shift,
                                     int64_t n_sa, int mode, int64_t* kk,
                                     int64_t* add, uint32_t* buf,
                                     int32_t* cnt,
                                     int64_t* __restrict__ sample_req,
                                     const uint32_t* __restrict__ samples,
                                     R* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = which[i];
  const int64_t mask = ((int64_t)1 << shift) - 1;
  if (mode == 2) {
    // int32 samples (narrow) are one word, int64 ones two
    const int64_t smp =
        W == 12 ? (int64_t)((uint64_t)samples[2 * i] |
                            ((uint64_t)samples[2 * i + 1] << 32))
                : (int64_t)(int32_t)samples[i];
    out[i] = (R)(add[i] + smp);
    return;
  }
  uint32_t* pair = buf + i * 2 * W;
  const int64_t prim = cx.prim[w];
  int64_t r = mode == 0 ? (int64_t)k[i] : kk[i];
  if (mode == 0) {
    add[i] = 0;
  } else if (r & mask) {  // _inv_psi_plain: the BWT character at r, then
    // L2[c] + occ(c, r)
    const int64_t j = r - (r >= prim ? 1 : 0);
    const uint32_t word = pair[W - 4 + ((j >> 4) & 3)];
    const int c = (int)((word >> (((~j) & 15) << 1)) & 3);
    int64_t occ[4];
    occ4<W>(cx, pair + W, w, r, occ);
    const int64_t nxt = cx.L2[w * 5 + c] + occ[c];
    r = r == prim ? 0 : nxt;
    ++add[i];
  }
  kk[i] = r;
  if (r & mask) {
    const int64_t g0 = (int64_t)w * cx.n64 + ((r - (r >= prim ? 1 : 0)) >> 6);
    const int64_t g1 = occ_row_id(cx, w, r);
    for (int u = 0; u < W; ++u) {
      pair[u] = owned_word<W>(sh, g0, u);
      pair[W + u] = owned_word<W>(sh, g1, u);
    }
    cnt[i] = 2;
    cnt[n + i] += 2;
    sample_req[i] = -1;
  } else {
    cnt[i] = 0;
    sample_req[i] = (int64_t)w * n_sa + (r >> shift);
  }
}

// ---------------------------------------------------------------------------
// the routed gather
// ---------------------------------------------------------------------------

// out[i] = the row of global id req[i] where this shard ([lo, lo + rows)) owns
// it, zero elsewhere (and for req[i] < 0); `words` 32-bit words a row
__global__ void route_gather_kernel(const uint32_t* __restrict__ local,
                                    int64_t rows, int64_t lo, int words,
                                    const int64_t* __restrict__ req,
                                    int64_t n, uint32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * words) return;
  const int64_t i = t / words, w = t % words;
  const int64_t g = req[i] - lo;
  out[t] = (g >= 0 && g < rows) ? local[g * words + w] : 0u;
}

unsigned blocks_of(int64_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

template <typename R, int W>
int seed_step(const SeedArgs& a, void* states, void* buf, void* cnt,
              void* lists, void* rows, void* n_out, void* ov_out,
              cudaStream_t stream) {
  smem_route_step_kernel<R, W><<<blocks_of(a.B, LANES), THREADS, 0, stream>>>(
      a, (SeedLane*)states, (uint32_t*)buf, (int32_t*)cnt, (Intv*)lists,
      (R*)rows, (int32_t*)n_out, (bool*)ov_out);
  return (int)cudaGetLastError();
}

template <typename R, int W>
int sa_step(const Consts& cx, const Shard& sh, const void* which,
            const void* k, int64_t n, int shift, int64_t n_sa, int mode,
            void* kk, void* add, void* buf, void* cnt, void* sample_req,
            const void* samples, void* out, cudaStream_t stream) {
  sa_route_step_kernel<R, W><<<blocks_of(n, THREADS), THREADS, 0, stream>>>(
      cx, sh, (const int32_t*)which, (const R*)k, n, shift, n_sa, mode,
      (int64_t*)kk, (int64_t*)add, (uint32_t*)buf, (int32_t*)cnt,
      (int64_t*)sample_req, (const uint32_t*)samples, (R*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of a lane's state, and of its two interval lists at read length L;
// rows a lane may ask for in one step at read length L
extern "C" int64_t smem_route_state_bytes() { return sizeof(SeedLane); }
extern "C" int64_t smem_route_list_bytes(int L) {
  return 2 * ((int64_t)L + 1) * (int64_t)sizeof(Intv);
}
extern "C" int64_t smem_route_slots(int L) { return 2 * ((int64_t)L + 1); }

// one step of every lane of the seeder; states zero before the first
extern "C" int smem_route_step(int wide, const void* L2, const void* primary,
                               int64_t seq_len, int64_t n64, const void* tab,
                               int64_t tab_rows, int64_t tab_lo,
                               const void* reads, const void* lens,
                               const void* parents, int64_t B, int L, int msl,
                               int split_len, int split_width, int max_intv,
                               int start_width, int S, void* states,
                               void* buf, void* cnt, void* lists, void* rows,
                               void* n_out, void* ov_out, void* stream) {
  SeedArgs a{Consts{(const int64_t*)L2, (const int64_t*)primary, seq_len, n64},
             Shard{(const uint32_t*)tab, tab_lo, tab_rows},
             (const int32_t*)reads, (const int32_t*)lens,
             (const int32_t*)parents, B, L, msl, split_len, split_width,
             max_intv, start_width, S};
  if (wide)
    return seed_step<int64_t, 12>(a, states, buf, cnt, lists, rows, n_out,
                                  ov_out, (cudaStream_t)stream);
  return seed_step<int32_t, 8>(a, states, buf, cnt, lists, rows, n_out,
                               ov_out, (cudaStream_t)stream);
}

extern "C" int sa_route_step(int wide, const void* L2, const void* primary,
                             int64_t seq_len, int64_t n64, const void* tab,
                             int64_t tab_rows, int64_t tab_lo,
                             const void* which, const void* k, int64_t n,
                             int shift, int64_t n_sa, int mode, void* kk,
                             void* add, void* buf, void* cnt,
                             void* sample_req, const void* samples, void* out,
                             void* stream) {
  Consts cx{(const int64_t*)L2, (const int64_t*)primary, seq_len, n64};
  Shard sh{(const uint32_t*)tab, tab_lo, tab_rows};
  if (wide)
    return sa_step<int64_t, 12>(cx, sh, which, k, n, shift, n_sa, mode, kk,
                                add, buf, cnt, sample_req, samples, out,
                                (cudaStream_t)stream);
  return sa_step<int32_t, 8>(cx, sh, which, k, n, shift, n_sa, mode, kk, add,
                             buf, cnt, sample_req, samples, out,
                             (cudaStream_t)stream);
}

extern "C" int route_gather(const void* local, int64_t rows, int64_t lo,
                            int words, const void* req, int64_t n, void* out,
                            void* stream) {
  if (n > 0)
    route_gather_kernel<<<blocks_of(n * words, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)local, rows, lo, words, (const int64_t*)req, n,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
