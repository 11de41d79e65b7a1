// K3 uf_scan: Kruskal union-find over a lexsorted edge list, emitting the
// union event stream (ra[e], rb[e]); step e merged two trees iff ra != rb.
//
// Counterpart of the lax.scan in hdbscan_tpu/core/mst_device.py _uf_scan
// (not a Pallas kernel: PyTorch has no device scan, and a Python loop over
// the edges would be one launch per union-find operation). The outputs are
// the two roots before each union, and a union always hangs root rb under
// root ra (par[rb] = ra, no union by size), as in the reference. Which node
// is a root depends only on those links, never on path compression, so the
// finds here halve paths as they walk (par[x] = par[par[x]]): the event
// stream is the reference's, without its long find chains. The reference's
// compression at the edge's endpoints (par[u] = ra, par[v] = rb) is kept.
//
// Design: the scan is sequential by nature (each union depends on every
// earlier one), so one thread runs it; par (initialised to 0..n-1 by the
// caller) lives in device memory, where the (n,) int32 array stays resident
// in L2 on this card.
//
// Bound on this card: latency, not bytes or operations. Every step is a
// short chain of dependent L2 reads; the bytes moved (read 2m ids, write 2m
// event ids) would take microseconds at the memory rate.
#include <cstdint>

#include <cuda_runtime.h>

__global__ void uf_scan_kernel(const int32_t* __restrict__ su,
                               const int32_t* __restrict__ sv, int m, int n,
                               int32_t* __restrict__ par,
                               int32_t* __restrict__ ra_out,
                               int32_t* __restrict__ rb_out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int e = 0; e < m; ++e) {
    const int32_t ue = su[e];
    const int32_t ve = sv[e];
    int32_t a = ue;
    while (par[a] != a) {
      par[a] = par[par[a]];
      a = par[a];
    }
    int32_t b = ve;
    while (par[b] != b) {
      par[b] = par[par[b]];
      b = par[b];
    }
    par[ue] = a;
    par[ve] = b;
    par[b] = a;
    ra_out[e] = a;
    rb_out[e] = b;
  }
}

extern "C" int uf_scan_launch(const void* su, const void* sv, int m, int n,
                              void* par, void* ra, void* rb, void* stream) {
  if (m <= 0) return 0;
  uf_scan_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int32_t*)su, (const int32_t*)sv, m, n, (int32_t*)par,
      (int32_t*)ra, (int32_t*)rb);
  return cudaGetLastError();
}
