// K6 chain_scan: mem_chain's B-tree scan for a batch of lanes, a warp a
// lane.
//
// Replaces the XLA while_loop chain_scan_batch
// (biscuit_tpu/ops/chain_batch.py), which advances every lane by one
// occurrence per step over [NC, B] chain planes held sorted by position.
// Outputs are the JAX ones: the action log [J, B] (chain_id << 2 | kind, 0
// where nothing happened, at every step up to J) and the capacity flag
// ov [B] of a lane that would need more than NC chains. The `allow` rule
// replays memchain.c:326, and the containment, `pacrej` and `apnd` tests
// run in the rank dtype as the JAX machine does.
//
// Design: the plane machine, with the planes in registers. Slot s of a
// lane's sorted chains lives in register s / 32 of thread s % 32 of the
// lane's warp (NC_MAX / 32 registers a field; a chain's first reference
// position is its sort key, so no separate key is kept). A step:
//  - the lower neighbour: ins = popc(ballot(s < n && fr[s] <= rb)) over
//    the warp's slots (the chains are sorted, so that is bisect_right), as
//    the plane machine's ((slots < n) & (pos <= rb)).sum(0); jn = ins - 1;
//  - the merge test (memchain.c:227-256, in its exact order) runs on each
//    thread's register jn / 32, picked by selects, so every thread tests a
//    chain of its own in the same instructions; the thread that holds slot
//    jn has chain jn, applies an append, and its verdict reaches the warp
//    in one shuffle (one shuffle, where broadcasting chain jn's fields to
//    test it once would take one a field);
//  - a new chain is inserted at ins: every field moves up one slot, one
//    shuffle a register (slot s takes slot s - 1: thread t - 1's register,
//    or for thread 0 thread 31's register below), and slot ins takes the
//    new chain.
// A block stages its lanes' occurrence planes into shared memory in chunks
// of JC columns with loads that run along b, and writes its log back the
// same way, so any J (CHAIN_JMAX = 1024) streams through.
//
// What bounds it on an H100: each lane is a serial chain of J steps (a step
// reads the chains the last one wrote), about a hundred instructions a
// step; the bytes (six words an occurrence in, one out) are far below.
// Lanes are the parallelism, a lane's chain of steps the latency: the
// card holds 24 lanes an SM (80 registers, three blocks of 8 lanes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC_MAX = 64;
constexpr int K_NEW = 1, K_APPEND = 2, K_EXTRA = 3;
constexpr int THREADS = 256;
constexpr int JC = 32;  // columns staged at a time
constexpr int K = NC_MAX / 32;  // slots a thread
constexpr int LB = THREADS / 32;  // lanes a block
constexpr unsigned FULL = 0xffffffffu;

// a[r] for a runtime r: a chain of selects, so that `a` stays in registers
template <int N, typename V>
__device__ __forceinline__ V pick(const V (&a)[N], int r) {
  V v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = k == r ? a[k] : v;
  return v;
}

// The warp's slots of one field (slot k * 32 + t in a[k] of thread t) from
// `ins` on move up by one and slot ins takes v: slot s takes slot s - 1,
// thread t - 1's register k, or for t == 0 (then k >= 1) thread 31's
// register k - 1. One shuffle a register.
template <typename V>
__device__ __forceinline__ void shift_in(V (&a)[K], V v, int ins, int t) {
  const int from = (t + 31) & 31;
  V x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = __shfl_sync(FULL, a[k], from);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + t;
    const V prev = t > 0 ? x[k] : x[k > 0 ? k - 1 : 0];
    a[k] = s > ins ? prev : (s == ins ? v : a[k]);
  }
}

// held to 80 registers, three blocks (24 warps) an SM
template <typename R>
__global__ void __launch_bounds__(THREADS, 3)
chain_scan_kernel(const int32_t* __restrict__ qbeg,
                  const int32_t* __restrict__ slen, const R* __restrict__ rbeg,
                  const int32_t* __restrict__ valid,
                  const int32_t* __restrict__ rid,
                  const int32_t* __restrict__ kocc,
                  const int32_t* __restrict__ n_occ, int64_t J, int64_t B,
                  R l_pac, int w, int max_gap, int max_occ, int NC,
                  int32_t* __restrict__ log, bool* __restrict__ ov_out) {
  __shared__ int32_t s_qb[JC][LB], s_ln[JC][LB], s_vd[JC][LB], s_rid[JC][LB],
      s_k[JC][LB], s_log[JC][LB];
  __shared__ R s_rb[JC][LB];
  __shared__ int s_jmax;

  const int t = threadIdx.x & 31;
  const int l = threadIdx.x / 32;  // the lane within the block, its warp
  const int64_t b0 = (int64_t)blockIdx.x * LB;
  const int64_t b = b0 + l;
  const bool live = b < B;
  const int no = live ? n_occ[b] : 0;
  if (threadIdx.x == 0) s_jmax = 0;
  __syncthreads();
  if (t == 0 && no > 0) atomicMax(&s_jmax, no);
  __syncthreads();
  const int64_t jmax = s_jmax;

  // the lane's chains, slot k * 32 + t in register k; fr is the sort key
  R fr[K], lr[K];
  int32_t cid[K], crid[K], fq[K], lq[K], ll[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fr[k] = lr[k] = 0;
    cid[k] = crid[k] = fq[k] = lq[k] = ll[k] = 0;
  }
  int n = 0, cnt = 0;
  bool ov = false;

  for (int64_t c0 = 0; c0 < J; c0 += JC) {
    const int cols = (int)(J - c0 < JC ? J - c0 : JC);
    // columns some lane of the block has: those are staged
    const int busy = (int)(jmax - c0 < cols ? (jmax > c0 ? jmax - c0 : 0) : cols);
    if (busy) {  // uniform over the block
      for (int i = threadIdx.x; i < busy * LB; i += THREADS) {
        const int j = i / LB, lb = i % LB;
        if (b0 + lb >= B) continue;
        const int64_t o = (c0 + j) * B + b0 + lb;
        s_qb[j][lb] = qbeg[o];
        s_ln[j][lb] = slen[o];
        s_rb[j][lb] = rbeg[o];
        s_vd[j][lb] = valid[o];
        s_rid[j][lb] = rid[o];
        s_k[j][lb] = kocc[o];
      }
      __syncthreads();
    }
    for (int j = 0; j < cols; ++j) {
      const int64_t col = c0 + j;
      int32_t entry = 0;
      if (col < no) {  // uniform over the warp
        const int32_t qb = s_qb[j][l], ln = s_ln[j][l], ro = s_rid[j][l],
                      kk = s_k[j][l];
        const R rb = s_rb[j][l];
        const int cnt0 = kk == 0 ? 0 : cnt;
        const bool allow = cnt0 < max_occ && (cnt0 <= 5 || kk < max_occ);
        bool do_new = false;
        if (s_vd[j][l] != 0 && !ov && allow) {
          int ins = 0;
#pragma unroll
          for (int k = 0; k < K; ++k)
            ins += __popc(__ballot_sync(FULL, k * 32 + t < n && fr[k] <= rb));
          const int jn = ins - 1, owner = jn & 31, r = jn / 32;
          // merge_seed_to_chain (memchain.c:227-256), in its exact order, on
          // each thread's register r: the owner's is chain jn. Its verdict
          // (cid << 2 | kind, 0 where it does not merge) is the warp's.
          const R c_fr = pick(fr, r), c_lr = pick(lr, r);
          const int32_t c_fq = pick(fq, r), c_lq = pick(lq, r),
                        c_ll = pick(ll, r);
          int verdict = 0;
          bool app = false;
          if (jn >= 0 && pick(crid, r) == ro) {
            const R lnr = (R)ln, cllr = (R)c_ll;
            if (qb >= c_fq && qb + ln <= c_lq + c_ll && rb >= c_fr &&
                rb + lnr <= c_lr + cllr) {
              verdict = (pick(cid, r) << 2) | K_EXTRA;
            } else {
              const bool pacrej = (c_lr < l_pac || c_fr < l_pac) && rb >= l_pac;
              const R qd = (R)(qb - c_lq), rd = rb - c_lr;
              app = !pacrej && rd >= 0 && qd - rd <= w && rd - qd <= w &&
                    qd - cllr < max_gap && rd - cllr < max_gap;
              if (app) verdict = (pick(cid, r) << 2) | K_APPEND;
            }
          }
          verdict = __shfl_sync(FULL, verdict, owner);
          if (verdict != 0) {
            entry = verdict;
            if (app && t == owner) {  // the chain's last seed becomes this one
#pragma unroll
              for (int k = 0; k < K; ++k) {
                if (k == r) {
                  lq[k] = qb;
                  lr[k] = rb;
                  ll[k] = ln;
                }
              }
            }
          } else if (n < NC) {
            // slots >= ins move up by one, the new chain lands at ins
            shift_in(fr, rb, ins, t);
            shift_in(lr, rb, ins, t);
            shift_in(cid, n, ins, t);
            shift_in(crid, ro, ins, t);
            shift_in(fq, qb, ins, t);
            shift_in(lq, qb, ins, t);
            shift_in(ll, ln, ins, t);
            entry = (n << 2) | K_NEW;
            ++n;
            do_new = true;
          } else {
            ov = true;
          }
        }
        cnt = cnt0 + (do_new ? 1 : 0);
      }
      if (t == 0) s_log[j][l] = entry;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cols * LB; i += THREADS) {
      const int j = i / LB, lb = i % LB;
      if (b0 + lb < B) log[(c0 + j) * B + b0 + lb] = s_log[j][lb];
    }
    __syncthreads();
  }
  if (live && t == 0) ov_out[b] = ov;
}

template <typename R>
int launch(const void* qbeg, const void* slen, const void* rbeg,
           const void* valid, const void* rid, const void* kocc,
           const void* n_occ, int64_t J, int64_t B, int64_t l_pac, int w,
           int max_gap, int max_occ, int NC, void* log, void* ov,
           cudaStream_t stream) {
  const int64_t blocks = (B + LB - 1) / LB;
  chain_scan_kernel<R><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const int32_t*)qbeg, (const int32_t*)slen, (const R*)rbeg,
      (const int32_t*)valid, (const int32_t*)rid, (const int32_t*)kocc,
      (const int32_t*)n_occ, J, B, (R)l_pac, w, max_gap, max_occ, NC,
      (int32_t*)log, (bool*)ov);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chain_scan_narrow(const void* qbeg, const void* slen,
                                 const void* rbeg, const void* valid,
                                 const void* rid, const void* kocc,
                                 const void* n_occ, int64_t J, int64_t B,
                                 int64_t l_pac, int w, int max_gap,
                                 int max_occ, int NC, void* log, void* ov,
                                 void* stream) {
  return launch<int32_t>(qbeg, slen, rbeg, valid, rid, kocc, n_occ, J, B,
                         l_pac, w, max_gap, max_occ, NC, log, ov,
                         (cudaStream_t)stream);
}

extern "C" int chain_scan_wide(const void* qbeg, const void* slen,
                               const void* rbeg, const void* valid,
                               const void* rid, const void* kocc,
                               const void* n_occ, int64_t J, int64_t B,
                               int64_t l_pac, int w, int max_gap, int max_occ,
                               int NC, void* log, void* ov, void* stream) {
  return launch<int64_t>(qbeg, slen, rbeg, valid, rid, kocc, n_occ, J, B,
                         l_pac, w, max_gap, max_occ, NC, log, ov,
                         (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
