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
//  * smem_route_step / sa_route_step advance every lane (a seeding lane, or
//    an SA job) by one extension or one inverse-Psi step: each consumes the
//    two table rows it asked for at the step before, runs on until it needs
//    the next two, writes their global row ids and counts itself live;
//  * route_gather copies the rows this shard owns for those ids and zeros
//    the others (the source's masked gather);
//  * between launches the wrapper (seed_batch._routed_seed, _routed_sa) sums
//    the gathered rows over the idx group, the source's psum: exactly one
//    shard owns each row, so every rank of the group gets every row, and the
//    ranks, which hold the same lanes, stay in lockstep.
//
// What bounds it on an H100: not the card. A step moves two rows (32 or 48
// bytes each) a lane and does a few hundred integer operations a lane; the
// collective between steps, and the host round trip that reads the live
// count, take the step's time. The design keeps each step to one launch of
// each kernel and one collective of 2 x W words a lane, and the lanes' whole
// state in device memory between launches, so that nothing but the rows and
// one live count crosses to the host side.
//
// The lane's machine is smem.collect_intv written as a state machine (one
// thread a lane, its state in a struct in device memory): pass 1 (smem1a
// from every restart), pass 2 (smem1a in the middle of each long pass-1
// SMEM of at most split_width occurrences, asking for one occurrence more),
// pass 3 (seed_strategy1), then a stable sort of the lane's rows by (start,
// end). Its arithmetic is the plain machine's (seed_batch._occ4, _extend,
// _inv_psi_plain) in int64, whatever the rank dtype: occ4's edges (k < 0,
// k == seq_len) and the cut-off bases read as A; extend's `crosses` term
// and the b3..b0 order; smem1a's "shrank: keep the one before", the
// reversal, and the emit rule with `emitted`/`last`, in which seeds shorter
// than min_seed_len take part unseen; ns != curr[nc-1].s; pass 3's ns > 0
// store. A lane that would store row S+1 stops and is flagged, as in K3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t M55 = 0x55555555u;

struct Intv {
  int64_t x0, x1, s, end;
};

// the tables' constants: L2 [2][5], primary [2], seq_len, rows a strand
struct Consts {
  const int64_t* L2;
  const int64_t* prim;
  int64_t seq_len, n64;
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

// the lane's state; all zero is the start of pass 1
enum : int {
  P1 = 0,     // pass 1: the next restart
  P2,         // pass 2: the next pass-1 row
  P3,         // pass 3: the next start of seed_strategy1
  SMEM,       // smem1a: its start at sx
  FWD,        //   ... the next forward extension
  FWD_R,      //   ... its answer
  BACK,       //   ... the backward pass's start
  ROUND,      //   ... a backward round at i
  BWD,        //   ... the next interval of prev
  BWD_R,      //   ... its answer
  RET,        //   ... returned ret to its caller
  STR,        // seed_strategy1: the next extension
  STR_R,      //   ... its answer
  FINISH,     // sort and write
  DONE
};

struct SeedLane {
  int state, wait, caller;
  int x, k, n1, n, ov;
  // smem1a
  int sx, i, c, nc, np, j, rev, emitted, last, ret, cur;
  int64_t min_intv;
  Intv ik;
  // seed_strategy1
  int64_t x0, x1, s;
  // the extension asked for: strand, ranks, class; and its answer
  int ew, ec;
  int64_t exq, exo, es;
  int64_t nq, no, ns;
};

struct SeedArgs {
  Consts cx;
  const int32_t* reads;
  const int32_t* lens;
  const int32_t* parents;
  int64_t B;
  int L, msl, split_len, split_width, max_intv, start_width, S;
};

// bwt_extend's class ec of the asked interval (seed_batch._extend), from the
// rows at ranks exq - 1 and exq - 1 + es
template <int W>
__device__ void answer(const Consts& cx, SeedLane& st, const uint32_t* rows) {
  int64_t tk[4], tl[4];
  occ4<W>(cx, rows, st.ew, st.exq - 1, tk);
  occ4<W>(cx, rows + W, st.ew, st.exq - 1 + st.es, tl);
  const int64_t prim = cx.prim[st.ew];
  const int64_t b3 =
      st.exo + ((st.exq <= prim && st.exq + st.es - 1 >= prim) ? 1 : 0);
  const int64_t b2 = b3 + (tl[3] - tk[3]);
  const int64_t b1 = b2 + (tl[2] - tk[2]);
  const int64_t b0 = b1 + (tl[1] - tk[1]);
  const int c = st.ec;
  st.nq = cx.L2[st.ew * 5 + c] + 1 + tk[c];
  st.no = c == 0 ? b0 : c == 1 ? b1 : c == 2 ? b2 : b3;
  st.ns = tl[c] - tk[c];
}

__device__ __forceinline__ void ask(SeedLane& st, int which, int64_t xq,
                                    int64_t xo, int64_t s, int c, int next) {
  st.ew = which;
  st.exq = xq;
  st.exo = xo;
  st.es = s;
  st.ec = c;
  st.state = next;
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

template <typename R, int W>
__device__ void seed_lane(const SeedArgs& a, SeedLane& st, int64_t b,
                          const uint32_t* rows_in, int64_t* req,
                          Intv* lists, R* rows, int32_t* n_out,
                          bool* ov_out) {
  const Consts& cx = a.cx;
  const int32_t* q = a.reads + b * a.L;
  const int len = a.lens[b];
  const int bwd = a.parents[b], fwd = 1 - bwd;
  const int64_t* L2 = cx.L2;
  Intv* buf[2] = {lists, lists + (a.L + 1)};
  if (st.wait) {
    answer<W>(cx, st, rows_in);
    st.wait = 0;
  }
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
        if (st.ns != st.ik.s) {  // the interval shrank: keep the one before
          buf[st.cur][st.nc++] = st.ik;
          st.ret = (int)st.ik.end;
          if (st.ns < st.min_intv) {
            st.state = BACK;
            break;
          }
        }
        st.ik = Intv{st.no, st.nq, st.ns, (int64_t)(st.i + 1)};
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
      case ROUND:
        if (st.i < -1) {
          st.state = RET;
          break;
        }
        st.c = (st.i < 0 || q[st.i] > 3) ? -1 : q[st.i];
        st.nc = 0;
        st.j = 0;
        st.state = BWD;
        break;
      case BWD:
      case BWD_R: {
        if (st.state == BWD && st.j >= st.np) {  // the round's end
          if (st.nc == 0) {
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
        const Intv p = buf[st.cur ^ 1][st.rev ? st.np - 1 - st.j : st.j];
        if (st.state == BWD && st.c >= 0) {
          ask(st, bwd, p.x0, p.x1, p.s, st.c, BWD_R);
          break;
        }
        if (st.c < 0 || st.ns < st.min_intv) {
          // emitted only with curr empty, left of the last seed
          if (st.nc == 0 && (!st.emitted || st.i + 1 < st.last)) {
            st.emitted = 1;
            st.last = st.i + 1;
            if (p.end - (st.i + 1) >= a.msl &&
                !store<R>(st, rows, a.S, st.i + 1, p.end, p.x0, p.x1, p.s)) {
              st.state = FINISH;
              break;
            }
          }
        } else if (st.nc == 0 || st.ns != buf[st.cur][st.nc - 1].s) {
          buf[st.cur][st.nc++] = Intv{st.nq, st.no, st.ns, p.end};
        }
        ++st.j;
        st.state = BWD;
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
        if (st.ns < a.max_intv && st.i - st.sx >= a.msl) {
          if (st.ns > 0)
            store<R>(st, rows, a.S, st.sx, st.i + 1, st.no, st.nq, st.ns);
          st.x = st.i + 1;
          st.state = P3;
        } else {
          st.x0 = st.no;
          st.x1 = st.nq;
          st.s = st.ns;
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
  if (st.wait) {
    req[2 * b] = occ_row_id(cx, st.ew, st.exq - 1);
    req[2 * b + 1] = occ_row_id(cx, st.ew, st.exq - 1 + st.es);
  } else {
    req[2 * b] = req[2 * b + 1] = -1;
  }
}

template <typename R, int W>
__global__ void smem_route_step_kernel(SeedArgs a, SeedLane* states,
                                       const uint32_t* __restrict__ rows_in,
                                       int64_t* __restrict__ req,
                                       Intv* lists, R* rows, int32_t* n_out,
                                       bool* ov_out, int* live) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  SeedLane st = states[b];
  if (st.state == DONE) {
    req[2 * b] = req[2 * b + 1] = -1;
    return;
  }
  seed_lane<R, W>(a, st, b, rows_in + b * 2 * W, req,
                  lists + b * 2 * (a.L + 1), rows + b * a.S * 5, n_out,
                  ov_out);
  states[b] = st;
  if (st.wait) atomicAdd(live, 1);
}

// ---------------------------------------------------------------------------
// the SA walk
// ---------------------------------------------------------------------------

// mode 0: start at k; 1: one inverse-Psi step from the rows asked for; each
// asks for the rows of its next step while its rank is not a multiple of
// sa_intv, else for its SA sample. mode 2: the position, steps + sample.
template <typename R, int W>
__global__ void sa_route_step_kernel(Consts cx, const int32_t* which,
                                     const R* k, int64_t n, int shift,
                                     int64_t n_sa, int mode, int64_t* kk,
                                     int64_t* add,
                                     const uint32_t* __restrict__ rows_in,
                                     int64_t* __restrict__ req,
                                     int64_t* __restrict__ sample_req,
                                     const uint32_t* __restrict__ samples,
                                     R* out, int* live) {
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
  int64_t r = mode == 0 ? (int64_t)k[i] : kk[i];
  if (mode == 0) {
    add[i] = 0;
  } else if (r & mask) {  // _inv_psi_plain: the BWT character at r, then
    // L2[c] + occ(c, r)
    const uint32_t* row = rows_in + i * 2 * W;
    const int64_t prim = cx.prim[w];
    const int64_t j = r - (r >= prim ? 1 : 0);
    const uint32_t word = row[W - 4 + ((j >> 4) & 3)];
    const int c = (int)((word >> (((~j) & 15) << 1)) & 3);
    int64_t occ[4];
    occ4<W>(cx, row + W, w, r, occ);
    const int64_t nxt = cx.L2[w * 5 + c] + occ[c];
    r = r == prim ? 0 : nxt;
    ++add[i];
  }
  kk[i] = r;
  if (r & mask) {
    const int64_t prim = cx.prim[w];
    req[2 * i] = (int64_t)w * cx.n64 + ((r - (r >= prim ? 1 : 0)) >> 6);
    req[2 * i + 1] = occ_row_id(cx, w, r);
    sample_req[i] = -1;
    atomicAdd(live, 1);
  } else {
    req[2 * i] = req[2 * i + 1] = -1;
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

constexpr int THREADS = 128;

unsigned blocks_of(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <typename R, int W>
int seed_step(const SeedArgs& a, void* states, const void* rows_in, void* req,
              void* lists, void* rows, void* n_out, void* ov_out, void* live,
              cudaStream_t stream) {
  smem_route_step_kernel<R, W><<<blocks_of(a.B), THREADS, 0, stream>>>(
      a, (SeedLane*)states, (const uint32_t*)rows_in, (int64_t*)req,
      (Intv*)lists, (R*)rows, (int32_t*)n_out, (bool*)ov_out, (int*)live);
  return (int)cudaGetLastError();
}

template <typename R, int W>
int sa_step(const Consts& cx, const void* which, const void* k, int64_t n,
            int shift, int64_t n_sa, int mode, void* kk, void* add,
            const void* rows_in, void* req, void* sample_req,
            const void* samples, void* out, void* live, cudaStream_t stream) {
  sa_route_step_kernel<R, W><<<blocks_of(n), THREADS, 0, stream>>>(
      cx, (const int32_t*)which, (const R*)k, n, shift, n_sa, mode,
      (int64_t*)kk, (int64_t*)add, (const uint32_t*)rows_in, (int64_t*)req,
      (int64_t*)sample_req, (const uint32_t*)samples, (R*)out, (int*)live);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of a lane's state, and of its two interval lists at read length L
extern "C" int64_t smem_route_state_bytes() { return sizeof(SeedLane); }
extern "C" int64_t smem_route_list_bytes(int L) {
  return 2 * ((int64_t)L + 1) * (int64_t)sizeof(Intv);
}

// one step of every lane of the seeder; states zero before the first
extern "C" int smem_route_step(int wide, const void* L2, const void* primary,
                               int64_t seq_len, int64_t n64, const void* reads,
                               const void* lens, const void* parents,
                               int64_t B, int L, int msl, int split_len,
                               int split_width, int max_intv, int start_width,
                               int S, void* states, const void* rows_in,
                               void* req, void* lists, void* rows, void* n_out,
                               void* ov_out, void* live, void* stream) {
  SeedArgs a{Consts{(const int64_t*)L2, (const int64_t*)primary, seq_len, n64},
             (const int32_t*)reads, (const int32_t*)lens,
             (const int32_t*)parents, B, L, msl, split_len, split_width,
             max_intv, start_width, S};
  if (wide)
    return seed_step<int64_t, 12>(a, states, rows_in, req, lists, rows, n_out,
                                  ov_out, live, (cudaStream_t)stream);
  return seed_step<int32_t, 8>(a, states, rows_in, req, lists, rows, n_out,
                               ov_out, live, (cudaStream_t)stream);
}

extern "C" int sa_route_step(int wide, const void* L2, const void* primary,
                             int64_t seq_len, int64_t n64, const void* which,
                             const void* k, int64_t n, int shift, int64_t n_sa,
                             int mode, void* kk, void* add,
                             const void* rows_in, void* req, void* sample_req,
                             const void* samples, void* out, void* live,
                             void* stream) {
  Consts cx{(const int64_t*)L2, (const int64_t*)primary, seq_len, n64};
  if (wide)
    return sa_step<int64_t, 12>(cx, which, k, n, shift, n_sa, mode, kk, add,
                                rows_in, req, sample_req, samples, out, live,
                                (cudaStream_t)stream);
  return sa_step<int32_t, 8>(cx, which, k, n, shift, n_sa, mode, kk, add,
                             rows_in, req, sample_req, samples, out, live,
                             (cudaStream_t)stream);
}

extern "C" int route_gather(const void* local, int64_t rows, int64_t lo,
                            int words, const void* req, int64_t n, void* out,
                            void* stream) {
  if (n > 0)
    route_gather_kernel<<<blocks_of(n * words), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)local, rows, lo, words, (const int64_t*)req, n,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
