// K6 chain_scan: mem_chain's B-tree scan for a batch of lanes, one thread
// per lane.
//
// Replaces the XLA while_loop chain_scan_batch
// (biscuit_tpu/ops/chain_batch.py), which advanced every lane by one
// occurrence per step over [NC, B] chain planes, with one-hot selects for
// every lookup and a full shift of all planes for every insert. Here each
// thread walks its own lane's occurrences in order and keeps its chains
// sorted by position in local arrays (NC <= 64 slots of pos, cid, crid, fq,
// fr, lq, lr, ll): the lower neighbour (bisect_right - 1) is a binary search
// and an insert moves only the slots after it. Outputs are the JAX ones: the
// action log [J, B] (chain_id << 2 | kind, 0 where nothing happened, at
// every step up to J) and the capacity flag ov [B] of a lane that would
// need more than NC chains. The `allow` rule replays memchain.c:326, and
// the containment, `pacrej` and `apnd` tests run in the rank dtype as the
// JAX machine does.
//
// What bounds it on an H100: one pass over the J-major occurrence planes,
// 6 words per occurrence, each read once; thread b reading plane[j, b]
// makes a warp's loads of one step contiguous. The chain slots spill to
// local memory (about 2.8 KB a thread for int64 ranks), which the L1 holds
// for the few warps a batch of a few thousand lanes puts on an SM. The
// per-lane work is a serial dependence (each step reads the chains the
// previous one wrote), so lanes are the only parallelism.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC_MAX = 64;
constexpr int K_NEW = 1, K_APPEND = 2, K_EXTRA = 3;

template <typename R>
__global__ void chain_scan_kernel(const int32_t* __restrict__ qbeg,
                                  const int32_t* __restrict__ slen,
                                  const R* __restrict__ rbeg,
                                  const int32_t* __restrict__ valid,
                                  const int32_t* __restrict__ rid,
                                  const int32_t* __restrict__ kocc,
                                  const int32_t* __restrict__ n_occ, int64_t J,
                                  int64_t B, R l_pac, int w, int max_gap,
                                  int max_occ, int NC,
                                  int32_t* __restrict__ log,
                                  bool* __restrict__ ov_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  R pos[NC_MAX], fr[NC_MAX], lr[NC_MAX];
  int32_t cid[NC_MAX], crid[NC_MAX], fq[NC_MAX], lq[NC_MAX], ll[NC_MAX];
  int n = 0, cnt = 0;
  bool ov = false;
  const int64_t no = n_occ[b];
  for (int64_t col = 0; col < J; ++col) {
    const int64_t o = col * B + b;
    int32_t entry = 0;
    if (col < no) {
      const int32_t qb = qbeg[o], ln = slen[o], ro = rid[o], kk = kocc[o];
      const R rb = rbeg[o];
      const int cnt0 = kk == 0 ? 0 : cnt;
      const bool allow = cnt0 < max_occ && (cnt0 <= 5 || kk < max_occ);
      bool do_new = false;
      if (valid[o] != 0 && !ov && allow) {
        int lo = 0, hi = n;  // ins = number of chains with pos <= rb
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (pos[mid] <= rb) lo = mid + 1;
          else hi = mid;
        }
        const int ins = lo, jn = lo - 1;
        bool merged = false;
        if (jn >= 0 && crid[jn] == ro) {
          // merge_seed_to_chain (memchain.c:227-256), in its exact order
          const R lnr = (R)ln, cllr = (R)ll[jn];
          if (qb >= fq[jn] && qb + ln <= lq[jn] + ll[jn] && rb >= fr[jn] &&
              rb + lnr <= lr[jn] + cllr) {
            entry = (cid[jn] << 2) | K_EXTRA;
            merged = true;
          } else {
            const bool pacrej = (lr[jn] < l_pac || fr[jn] < l_pac) &&
                                rb >= l_pac;
            const R qd = (R)(qb - lq[jn]), rd = rb - lr[jn];
            if (!pacrej && rd >= 0 && qd - rd <= w && rd - qd <= w &&
                qd - cllr < max_gap && rd - cllr < max_gap) {
              lq[jn] = qb;
              lr[jn] = rb;
              ll[jn] = ln;
              entry = (cid[jn] << 2) | K_APPEND;
              merged = true;
            }
          }
        }
        if (!merged) {
          if (n < NC) {
            for (int s = n; s > ins; --s) {
              pos[s] = pos[s - 1];
              fr[s] = fr[s - 1];
              lr[s] = lr[s - 1];
              cid[s] = cid[s - 1];
              crid[s] = crid[s - 1];
              fq[s] = fq[s - 1];
              lq[s] = lq[s - 1];
              ll[s] = ll[s - 1];
            }
            pos[ins] = rb;
            fr[ins] = rb;
            lr[ins] = rb;
            cid[ins] = n;
            crid[ins] = ro;
            fq[ins] = qb;
            lq[ins] = qb;
            ll[ins] = ln;
            entry = (n << 2) | K_NEW;
            ++n;
            do_new = true;
          } else {
            ov = true;
          }
        }
      }
      cnt = cnt0 + (do_new ? 1 : 0);
    }
    log[o] = entry;
  }
  ov_out[b] = ov;
}

template <typename R>
int launch(const void* qbeg, const void* slen, const void* rbeg,
           const void* valid, const void* rid, const void* kocc,
           const void* n_occ, int64_t J, int64_t B, int64_t l_pac, int w,
           int max_gap, int max_occ, int NC, void* log, void* ov,
           cudaStream_t stream) {
  const int threads = 64;
  const int64_t blocks = (B + threads - 1) / threads;
  chain_scan_kernel<R><<<(unsigned)blocks, threads, 0, stream>>>(
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
