// The pack scan as one device program for NVIDIA Hopper (sm_90a): B scans
// in one launch, one thread block of 512 threads per scan.
//
// Replaces the host-stepped eager scan of ops/pack.py (make_pack_kernel.
// pack), the port of the reference's jitted scan (karpenter_core_tpu/ops/
// pack.py make_pack_kernel: a lax.scan over the FFD items with a
// lax.while_loop per item, vmapped over the segmented lanes), for every
// scan under the prescreen that writes a commit log, topology groups
// included. The scan's logic is csrc/pack_scan_body.h; this file gives it
// the block primitives of a CUDA thread block and the launch.
//
// Design. A scan is a sequence of small decisions, each over one axis of
// one scan's state (the N slots, the T types, the C class columns, the J
// templates), and each depends on the one before; so a scan is one block,
// the block's threads split each axis (strided loops), and every decision
// is a block-wide reduction that every thread receives (warp shuffles,
// then the warps' partials through shared memory). The slot state, the
// [N, C] verdict tensor and the per-scan scratch stay in global memory:
// at N in the thousands they do not fit in shared memory, and a block
// touches one slot row per commit. The reductions that feed decisions
// are order-independent (float min and max, the first index, integer
// sums), so every thread takes the same branch and the result equals the
// serial build's (csrc/pack_scan_host.cpp) bit for bit. No atomics.
//
// What bounds it: the scan is a chain of dependent steps (a few barriers
// each), so its time is the steps times a block's barrier and global
// latency, not the card's bandwidth or arithmetic; a segmented solve's
// lanes run as concurrent blocks. chip_smoke.py computes the bytes-bound
// from the state the run's commits read and write.
//
// Plain C interface (built with nvcc, -fmad=false, into a shared library
// and bound with ctypes); the launch goes on the caller's stream and the
// function returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "pack_scan_body.h"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// TOPO: the build with the topology lanes (pack_scan_body.h, Blk::topo)
template <bool TOPO>
struct CudaBlock {
  static constexpr bool topo = TOPO;
  int tid;
  int nt;
  int lane;
  int warp;
  long long* red;  // [WARPS] shared: one partial per warp
  unsigned* part;  // [WARPS] shared: the prefix scan's warp totals

  __device__ void sync() { __syncthreads(); }

  // a block-wide reduction of v by op, the result in every thread
  template <class T, class Op>
  __device__ T reduce(T v, Op op) {
    for (int m = 16; m > 0; m >>= 1) v = op(v, __shfl_xor_sync(FULL, v, m));
    __syncthreads();  // the previous reduction's readers are done
    if (lane == 0) *reinterpret_cast<T*>(red + warp) = v;
    __syncthreads();
    T r = *reinterpret_cast<const T*>(red);
    for (int w = 1; w < WARPS; ++w) r = op(r, *reinterpret_cast<const T*>(red + w));
    return r;
  }

  __device__ float max_f(float v) {
    return reduce(v, [](float a, float b) { return a < b ? b : a; });
  }
  __device__ int max_i(int v) {
    return reduce(v, [](int a, int b) { return a < b ? b : a; });
  }
  __device__ bool any(bool v) { return __syncthreads_or(v) != 0; }
  __device__ long long sum_ll(long long v) {
    return reduce(v, [](long long a, long long b) { return a + b; });
  }

  // the index of the least value, the first index winning ties; i < 0
  // (no candidate) loses to every index
  __device__ int argmin_f(float v, int i) {
    unsigned u = static_cast<unsigned>(i);  // -1 -> the largest
    for (int m = 16; m > 0; m >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, m);
      const unsigned ou = __shfl_xor_sync(FULL, u, m);
      if (ov < v || (ov == v && ou < u)) {
        v = ov;
        u = ou;
      }
    }
    __syncthreads();
    if (lane == 0) {
      red[warp] = static_cast<long long>(u);
      reinterpret_cast<float*>(part)[warp] = v;
    }
    __syncthreads();
    float bv = reinterpret_cast<const float*>(part)[0];
    unsigned bu = static_cast<unsigned>(red[0]);
    for (int w = 1; w < WARPS; ++w) {
      const float wv = reinterpret_cast<const float*>(part)[w];
      const unsigned wu = static_cast<unsigned>(red[w]);
      if (wv < bv || (wv == bv && wu < bu)) {
        bv = wv;
        bu = wu;
      }
    }
    return static_cast<int>(bu);
  }

  // the exclusive prefix of v in thread order, and the block's total
  __device__ unsigned scan_u(unsigned v, unsigned* total) {
    unsigned inc = v;
    for (int m = 1; m < 32; m <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, inc, m);
      if (lane >= m) inc += o;
    }
    __syncthreads();
    if (lane == 31) part[warp] = inc;
    __syncthreads();
    unsigned before = 0u, all = 0u;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += part[w];
      all += part[w];
    }
    *total = all;
    return before + inc - v;
  }
};

template <bool TOPO>
__global__ void __launch_bounds__(THREADS, 1) pack_scan_kernel(pack_scan::Args a) {
  __shared__ long long red[WARPS];
  __shared__ unsigned part[WARPS];
  CudaBlock<TOPO> blk;
  blk.tid = threadIdx.x;
  blk.nt = THREADS;
  blk.lane = threadIdx.x & 31;
  blk.warp = threadIdx.x >> 5;
  blk.red = red;
  blk.part = part;
  pack_scan::scan(blk, a, blockIdx.x);
}

}  // namespace

// B = args->B scans, one block each, on `stream`. `threads` must be 512
// (the wrapper states its block size). args->progress, when set, is pinned
// host memory: the launch maps it for the card, or drops it when the
// platform cannot map it (the scan then reports no progress while it runs).
extern "C" int pack_scan_launch(const pack_scan::Args* args, int threads, void* stream) {
  pack_scan::Args a = *args;
  if (a.B <= 0) return 0;
  if (threads != THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (a.progress != nullptr) {
    void* dev = nullptr;
    if (cudaHostGetDevicePointer(&dev, a.progress, 0) == cudaSuccess) {
      a.progress = static_cast<int32_t*>(dev);
    } else {
      (void)cudaGetLastError();  // clear it: the launch does not depend on it
      a.progress = nullptr;
    }
  }
  // a batch without topology groups runs the build without their lanes
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.G > 0) {
    pack_scan_kernel<true><<<static_cast<unsigned>(a.B), THREADS, 0, st>>>(a);
  } else {
    pack_scan_kernel<false><<<static_cast<unsigned>(a.B), THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
