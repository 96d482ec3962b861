// K4 sa_walk: the bwt_sa walk for a batch of ranks, or for the ranks of a
// list of seed intervals.
//
// Replaces the XLA while_loop sa_batch (biscuit_tpu/ops/seed_batch.py,
// `sa_batch`), which walked every job of a batch in lockstep until the last
// one reached a sampled rank. A job walks rank k by inverse Psi until k is a
// multiple of sa_intv, then adds its step count to that rank's SA sample.
//
// What bounds it on the H100: memory latency. A step is one dependent random
// read of a 32-byte (narrow) or 48-byte (wide) row of the fused occ+BWT
// table (seed_batch._fused_tab), which holds both the BWT character at the
// rank and its occurrence count; a finished walk reads one SA sample. The
// bytes a batch needs are (sum of its steps) x the row size plus a sample, a
// rank and an output a job. On the card (PERF.md), tables in the L2 run at
// about twice that bound: each 16-byte load of a warp touches 32 lines; on
// tables twice the L2 a walk runs at the rate of random 32-byte reads from
// device memory, as the kernel it replaced did. The design:
//
// - One memory round trip a step. A row is read whole, by two (narrow) or
//   three (wide) 16-byte non-coherent vector loads; the character, the
//   popcount of its occurrences and the checkpoint count come from those
//   registers. L2 and the primary rows come by value in the parameter
//   struct (constant bank), so they cost no load. The narrow instance
//   computes its row index in 32 bits (a narrow strand has < 2^31 bases).
// - RS walks in flight a thread. Each thread keeps RS independent walks
//   ("slots") and issues the read of every live slot before it uses any,
//   so RS reads are outstanding a thread.
// - No slot waits for another walk. The grid is persistent (as many blocks
//   as fit an SM); a warp takes chunks of 32 job rows from a counter (one
//   atomicAdd a warp, by lane 0) and hands their jobs out to its idle slots
//   with ballots and shuffles, so a slot whose walk ends takes the next job
//   at once and a long walk holds one slot, not a warp. Threads idle only at
//   the end of the job list. Each job writes only its own output, so the
//   order in which jobs are handed out changes no output. (Chunks of 128
//   rows, four a lane, cost registers and were slower on the card.)
// - Two entries, one body. Ranks: job i is (which[i], k[i]) and writes
//   out[i]. Intervals: row r asks for ranks x0[r] .. x0[r] + kmax[r] - 1 of
//   strand which[r] and writes their positions at out[off[r] + i]; a chunk
//   holds 32 rows, lane l the l-th, and a slot finds its job's row by a
//   binary search of the chunk's prefix sums of kmax over the lanes (five
//   shuffles), so a row of one rank costs a lane of one chunk, not a warp.
//
// Narrow indexes (strands < 2^31) use int32 ranks and 8-column rows [c0..c3,
// w0..w3]; wide ones int64 ranks and 12-column rows [lo0..lo3, hi0..hi3,
// w0..w3]. The counters (chunks handed out, blocks finished) must be zero at
// launch; the last block to finish sets them to zero again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// The launch configuration, chosen by measurement on the H100 (PERF.md):
// 2 walks a thread and blocks of 128 threads, as many as fit an SM. 4 and 8
// walks a thread held more registers and fewer warps and lost at every step
// length. The launch bounds ask for 4 blocks an SM, a cap of 128 registers
// a thread; ptxas takes 61 to 80.
constexpr int THREADS = 128;
constexpr int RS = 2;

struct Params {
  const uint32_t* tab;   // [2, n64, W] fused occ+BWT rows, 16-byte aligned
  const void* sa;        // [2, n_sa] SA samples, rank dtype
  const int32_t* which;  // strand of each job (ranks) or each row (intervals)
  const void* x0;        // rank of each job, or the first rank of each row
  const int32_t* kmax;   // intervals: ranks each row asks for
  const int64_t* off;    // intervals: where each row's positions go in out
  void* out;             // [total] rank dtype
  unsigned* counter;     // [2]: chunks handed out, blocks finished
  int64_t n64, n_sa, n_rows, total;
  int64_t L2[2][4];      // L2[strand][c] for the four bases
  int64_t primary[2];
  int sa_shift;
};

template <bool WIDE> struct RankOf { using T = int32_t; };
template <> struct RankOf<true> { using T = int64_t; };

__device__ __forceinline__ uint32_t pick(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <bool WIDE, bool INTV>
__global__ void __launch_bounds__(THREADS, 4)
sa_walk_kernel(const Params p) {
  using R = typename RankOf<WIDE>::T;
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const R mask = ((R)1 << p.sa_shift) - 1;
  const R* __restrict__ sa = (const R*)p.sa;
  R* __restrict__ out = (R*)p.out;
  const int64_t n_chunks = (p.n_rows + 31) >> 5;

  // this lane's row of the warp's current chunk; cur and ctot (jobs of the
  // chunk handed out, jobs in it) are the same in every lane
  int c_wh = 0;
  R c_x0 = 0;
  int64_t c_off = 0, c_excl = 0, c_incl = 0, cur = 0, ctot = 0;
  bool more = true;

  R kk[RS];
  int add[RS], wh[RS];
  int64_t g[RS];
  bool live[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    kk[r] = 0;
    add[r] = wh[r] = 0;
    g[r] = 0;
    live[r] = false;
  }

  while (true) {
    // hand the next jobs to the idle slots: slot r of lane l is the
    // (idle slots of lanes < l in r + idle slots of every lane in r' < r)-th
    unsigned idle[RS];
    int rank_of[RS], n_idle = 0;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      idle[r] = __ballot_sync(FULL, !live[r]);
      rank_of[r] = n_idle + __popc(idle[r] & lanes_below);
      n_idle += __popc(idle[r]);
    }
    int served = 0;
    while (served < n_idle && more) {
      if (cur == ctot) {  // the chunk is used up: take the next one
        unsigned ch = 0;
        if (lane == 0) ch = atomicAdd(p.counter, 1u);
        ch = __shfl_sync(FULL, ch, 0);
        if ((int64_t)ch >= n_chunks) {
          more = false;
          break;
        }
        const int64_t row = ((int64_t)ch << 5) + lane;
        int64_t k = 0;
        if (row < p.n_rows) {
          c_wh = __ldg(p.which + row);
          c_x0 = __ldg((const R*)p.x0 + row);
          if (INTV) {
            k = __ldg(p.kmax + row);
            c_off = __ldg(p.off + row);
          } else {
            k = 1;
            c_off = row;
          }
        }
        c_incl = k;  // inclusive prefix sum of k over the lanes
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int64_t v = __shfl_up_sync(FULL, c_incl, s);
          if (lane >= s) c_incl += v;
        }
        c_excl = c_incl - k;
        ctot = __shfl_sync(FULL, c_incl, 31);
        cur = 0;
        continue;
      }
      const int64_t left = ctot - cur;
      const int take = left < n_idle - served ? (int)left : n_idle - served;
      // jobs of the chunk up to this lane's row not yet handed out, clamped
      // to [-1, 2^30] (a slot's t is below 32 x RS)
      const int64_t ahead = c_incl - cur;
      const int rel = ahead < 0 ? -1 : ahead > (1 << 30) ? 1 << 30 : (int)ahead;
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        if (idle[r] == 0) continue;  // the same in every lane
        const int t = rank_of[r] - served;
        const bool mine = !live[r] && t >= 0 && t < take;
        int src;
        if (INTV) {  // the first lane whose row holds job cur + t
          src = 0;
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) {
            const int v = __shfl_sync(FULL, rel, src + s - 1);
            if (v <= t) src += s;
          }
        } else {  // a rank a lane
          src = (int)(cur + t) & 31;
        }
        const int w = __shfl_sync(FULL, c_wh, src);
        const R x = __shfl_sync(FULL, c_x0, src);
        const int64_t o = __shfl_sync(FULL, c_off, src);
        const int64_t e = INTV ? __shfl_sync(FULL, c_excl, src) : 0;
        if (mine) {
          const int64_t within = INTV ? cur + t - e : 0;
          live[r] = true;
          wh[r] = w;
          kk[r] = x + (R)within;
          g[r] = o + within;
          add[r] = 0;
        }
      }
      cur += take;
      served += take;
    }
    bool any = false;
#pragma unroll
    for (int r = 0; r < RS; ++r) any |= live[r];
    if (!__any_sync(FULL, any)) break;

    // one memory round trip for every live slot: the row of its next step,
    // or, once its rank is sampled, the sample
    uint4 A[RS], B[RS], C[RS];
    R smp[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      if (!live[r]) continue;
      if ((kk[r] & mask) == 0) {
        smp[r] = __ldg(sa + (int64_t)wh[r] * p.n_sa + (int64_t)(kk[r] >> p.sa_shift));
        continue;
      }
      const R prim = (R)(wh[r] ? p.primary[1] : p.primary[0]);
      const R j = kk[r] - (kk[r] >= prim ? 1 : 0);
      const uint4* rp;
      if (WIDE) {
        rp = reinterpret_cast<const uint4*>(
            p.tab + ((int64_t)wh[r] * p.n64 + (int64_t)(j >> 6)) * 12);
      } else {
        rp = reinterpret_cast<const uint4*>(
            p.tab + ((uint32_t)wh[r] * (uint32_t)p.n64 + ((uint32_t)j >> 6)) * 8u);
      }
      A[r] = __ldg(rp);
      B[r] = __ldg(rp + 1);
      if (WIDE) C[r] = __ldg(rp + 2);
    }
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      if (!live[r]) continue;
      if ((kk[r] & mask) == 0) {
        if (g[r] >= 0 && g[r] < p.total) out[g[r]] = (R)add[r] + smp[r];
        live[r] = false;
        continue;
      }
      // inverse Psi; the '$' row (rank == primary) maps to rank 0
      const int w = wh[r];
      const R prim = (R)(w ? p.primary[1] : p.primary[0]);
      const R j = kk[r] - (kk[r] >= prim ? 1 : 0);
      const uint4 words = WIDE ? C[r] : B[r];
      const int wi = (int)((j >> 4) & 3);
      const int sh = (int)((~j & 15) << 1);  // 2 x bases of word wi after j
      const int c = (int)((pick(words, wi) >> sh) & 3u);
      const uint32_t rep = (uint32_t)c * 0x55555555u;
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t wm = pick(words, q);
        if (q == wi) wm = (wm >> sh) << sh;  // cut after j
        const uint32_t x = wm ^ rep;         // a 2-bit field is 0 iff it is c
        const int pc = __popc(~(x | (x >> 1)) & 0x55555555u);
        cnt += q <= wi ? pc : 0;
      }
      if (c == 0) cnt -= sh >> 1;  // the cut-off bases read as A (code 0)
      R acc;
      if (WIDE) {
        acc = (R)(((uint64_t)pick(B[r], c) << 32) | pick(A[r], c));
      } else {
        acc = (R)pick(A[r], c);
      }
      // selects of parameters, not an indexed array: no local copy
      const R l2c = w ? (c == 0 ? (R)p.L2[1][0] : c == 1 ? (R)p.L2[1][1]
                         : c == 2 ? (R)p.L2[1][2] : (R)p.L2[1][3])
                      : (c == 0 ? (R)p.L2[0][0] : c == 1 ? (R)p.L2[0][1]
                         : c == 2 ? (R)p.L2[0][2] : (R)p.L2[0][3]);
      kk[r] = kk[r] == prim ? (R)0 : (R)(l2c + acc + cnt);
      ++add[r];
    }
  }

  // the last block to finish leaves the counters at zero for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(p.counter + 1, 1u) == gridDim.x - 1) {
      p.counter[0] = 0;
      p.counter[1] = 0;
    }
  }
}

template <bool WIDE, bool INTV>
int launch_one(const Params& p, cudaStream_t stream) {
  auto kern = sa_walk_kernel<WIDE, INTV>;
  int occ = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                                THREADS, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  // as many blocks as fit, and no more than there are chunks for their
  // warps' first fetch
  const int64_t warps = THREADS / 32;
  const int64_t need = ((p.n_rows + 31) / 32 + warps - 1) / warps;
  int64_t blocks = (int64_t)sms * occ;
  if (need < blocks) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: L2[0][0..3], L2[1][0..3], primary[0], primary[1] (host memory).
// kmax and off are null for the rank entry (intervals == 0), where
// n_rows == total is the number of ranks.
extern "C" int sa_walk_launch(int wide, int intervals, const void* tab,
                              const void* sa, const int64_t* consts,
                              int64_t n64, int64_t n_sa, int sa_shift,
                              const void* which, const void* x0,
                              const void* kmax, const void* off,
                              int64_t n_rows, void* out, int64_t total,
                              void* counter, void* stream) {
  if (((uintptr_t)tab & 15) != 0 || (intervals && (!kmax || !off)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tab = (const uint32_t*)tab;
  p.sa = sa;
  p.which = (const int32_t*)which;
  p.x0 = x0;
  p.kmax = (const int32_t*)kmax;
  p.off = (const int64_t*)off;
  p.out = out;
  p.counter = (unsigned*)counter;
  p.n64 = n64;
  p.n_sa = n_sa;
  p.n_rows = n_rows;
  p.total = total;
  for (int s = 0; s < 2; ++s)
    for (int c = 0; c < 4; ++c) p.L2[s][c] = consts[4 * s + c];
  p.primary[0] = consts[8];
  p.primary[1] = consts[9];
  p.sa_shift = sa_shift;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return intervals ? launch_one<true, true>(p, st)
                     : launch_one<true, false>(p, st);
  return intervals ? launch_one<false, true>(p, st)
                   : launch_one<false, false>(p, st);
}

// warps one SM holds at once (occupancy calculator) and walks in flight an
// SM (warps x 32 x RS) of one instance
extern "C" int sa_walk_occupancy(int wide, int intervals, int* warps,
                                 int* walks) {
  const void* k = wide ? (intervals ? (const void*)sa_walk_kernel<true, true>
                                    : (const void*)sa_walk_kernel<true, false>)
                       : (intervals ? (const void*)sa_walk_kernel<false, true>
                                    : (const void*)sa_walk_kernel<false, false>);
  int occ = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, THREADS, 0);
  *warps = occ * (THREADS / 32);
  *walks = occ * THREADS * RS;
  return (int)e;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
