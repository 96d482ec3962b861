// K2 sw_global: banded global alignment with traceback, exact ksw_global2
// (reference lib/aln/ksw.c:504-606), for a batch of lanes.
//
// Replaces the Pallas kernel _glob_kernel of biscuit_tpu/ops/pallas_global.py
// (sw_global_batch_pallas) and its XLA companion global_traceback. On the
// TPU the DP walked target rows as the sequential grid axis with H/E rows
// held in VMEM scratch, 128 lanes per tile, and the traceback ran as a
// lockstep while_loop over the whole batch. Here:
//
//  * sw_global_kernel: one thread per lane runs that lane's rows 0..tlen-1
//    and only the cells of its band. H/E rows live in device memory in a
//    lane-minor layout ([Lq+1, B] and [Lq, B]; L2-resident at the engine's
//    shapes). Each in-band cell ORs its direction byte into z, which the
//    wrapper zeroes first, in the JAX layout [ceil(Lt/4), Lq, B] int32 with
//    target row i at bits 8*(i&3). The DP is bound by the serial F chain of
//    a row and by the z and H/E traffic (about 17 bytes per cell).
//  * global_traceback_kernel: one thread per lane follows the direction
//    bytes from (tlen-1, min(tlen+w, qlen)-1) and emits run-length ops in
//    the order of the JAX traceback: the `which` state, pushes M, D, I, the
//    tail pushes D then I, the flush, the max_ops overflow flag, and the
//    reversal of the emitted prefix. The per-lane op list (max_ops <= 64)
//    stays in local memory.
//
// MINUS_INF is ramped (f0 - j*e_ins, h1_first) and its exact value reaches
// the direction bits of in-band sentinel cells (pallas_global.py:35-39), so
// the kernel uses the same constant. F is computed by its serial recurrence
// F(beg) = MINUS_INF, F(j+1) = max(F(j) - e_ins, M(j) - oe_ins), which is
// the closed form the JAX kernel evaluates with a VERYNEG-seeded prefix max.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MINUS_INF = -0x40000000;
constexpr int MAX_OPS = 64;

__global__ void sw_global_kernel(
    const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
    const int32_t* __restrict__ matb, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ wv,
    int32_t* __restrict__ hbuf, int32_t* __restrict__ ebuf,
    int32_t* __restrict__ score, int32_t* __restrict__ z, int B, int Lq,
    int Lt, int o_del, int e_del, int o_ins, int e_ins) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  int32_t* h = hbuf + b;
  int32_t* e = ebuf + b;
  int32_t* zl = z + b;
  const size_t zrow = (size_t)Lq * sB;  // stride of one packed word row
  // tlens and w arrive clamped to >= 1 (pallas_global.py:218-219)
  const int qlen = qlens[b], tlen = tlens[b], w = wv[b];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int32_t* mat = matb + (size_t)b * 25;

  h[0] = 0;
  for (int j = 1; j <= Lq; ++j)
    h[j * sB] = (j <= w && j <= qlen) ? -(o_ins + e_ins * j) : MINUS_INF;
  for (int j = 0; j < Lq; ++j) e[j * sB] = MINUS_INF;

  const int n_rows = min(tlen, Lt);
  for (int i = 0; i < n_rows; ++i) {
    const int beg = max(i - w, 0);
    const int end = min(min(i + w + 1, qlen), Lq);
    const int h1_first = beg == 0 ? -(o_del + e_del * (i + 1)) : MINUS_INF;
    const int tb = tT[(size_t)i * sB + b];
    const int s0 = mat[tb * 5 + 0], s1 = mat[tb * 5 + 1],
              s2 = mat[tb * 5 + 2], s3 = mat[tb * 5 + 3],
              s4 = mat[tb * 5 + 4];
    const int sh = (i & 3) << 3;
    int32_t* zi = zl + (size_t)(i >> 2) * zrow;
    int hd = 0;
    if (beg <= Lq) {
      hd = h[beg * sB];
      h[beg * sB] = h1_first;
    }
    int f = MINUS_INF;
    for (int j = beg; j < end; ++j) {
      const int qc = qT[(size_t)j * sB + b];
      const int s = qc == 0 ? s0 : qc == 1 ? s1 : qc == 2 ? s2
                  : qc == 3 ? s3 : s4;
      const int M = hd + s;
      const int E = e[j * sB];
      hd = h[(j + 1) * sB];
      const int me = max(M, E);
      const int H = max(me, f);
      int d = M >= E ? 0 : 1;
      if (H > me) d = 2;
      d |= ((E - e_del) > (M - oe_del)) << 2;
      d |= ((f - e_ins) > (M - oe_ins)) << 5;
      if (d) zi[j * sB] |= d << sh;
      h[(j + 1) * sB] = H;
      e[j * sB] = max(E - e_del, M - oe_del);
      f = max(f - e_ins, M - oe_ins);
    }
    if (end < Lq) e[end * sB] = MINUS_INF;
  }
  score[b] = h[qlen * sB];
}

struct Runs {
  int ops[MAX_OPS];
  int n = 0, last_op = -1, last_len = 0, max_ops;
  bool ov = false;
  __device__ explicit Runs(int m) : max_ops(m) {}
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

__global__ void global_traceback_kernel(
    const int32_t* __restrict__ z, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ wv,
    int32_t* __restrict__ ops, int32_t* __restrict__ n_ops,
    uint8_t* __restrict__ ov, int B, int Lq, int Lt4, int max_ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  int i = tlens[b] - 1;
  int k = min(i + wv[b] + 1, qlens[b]) - 1;
  int which = 0;
  Runs r(max_ops);
  while (i >= 0 && k >= 0) {
    const uint32_t word = (uint32_t)z[((size_t)(i >> 2) * Lq + k) * sB + b];
    const int byte = (int)((word >> ((i & 3) << 3)) & 0xFFu);
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
  for (int idx = 0; idx < max_ops; ++idx) {
    const int src = min(max(r.n - 1 - idx, 0), max_ops - 1);
    ops[(size_t)idx * sB + b] = idx < r.n ? r.ops[src] : 0;
  }
  n_ops[b] = r.n;
  ov[b] = r.ov ? 1 : 0;
}

}  // namespace

extern "C" int sw_global(const void* qT, const void* tT, const void* matb,
                         const void* qlens, const void* tlens, const void* w,
                         void* hbuf, void* ebuf, void* score, void* z, int B,
                         int Lq, int Lt, int o_del, int e_del, int o_ins,
                         int e_ins, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  sw_global_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qT, (const uint8_t*)tT, (const int32_t*)matb,
      (const int32_t*)qlens, (const int32_t*)tlens, (const int32_t*)w,
      (int32_t*)hbuf, (int32_t*)ebuf, (int32_t*)score, (int32_t*)z, B, Lq,
      Lt, o_del, e_del, o_ins, e_ins);
  return (int)cudaGetLastError();
}

extern "C" int global_traceback(const void* z, const void* qlens,
                                const void* tlens, const void* w, void* ops,
                                void* n_ops, void* ov, int B, int Lq, int Lt4,
                                int max_ops, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  global_traceback_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)qlens, (const int32_t*)tlens,
      (const int32_t*)w, (int32_t*)ops, (int32_t*)n_ops, (uint8_t*)ov, B, Lq,
      Lt4, max_ops);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
