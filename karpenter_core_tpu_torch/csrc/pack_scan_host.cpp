// The pack scan's CPU build: pack_scan_body.h with the block primitives as
// serial loops (one thread, so every reduction is its own operand and a
// barrier does nothing). Only the tests load it, to hold the scan's logic
// against the reference on the CPU; the solver never does.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o csrc/build/libpack_scan_host.so csrc/pack_scan_host.cpp
//
// (ops/pack_scan.py builds it at first use.) -ffp-contract=off keeps every
// multiply and add a separate float32 operation, as on the card.

#include "pack_scan_body.h"

namespace {

template <bool TOPO>
struct SerialBlock {
  static constexpr bool topo = TOPO;  // the build with the topology lanes
  int tid = 0;
  int nt = 1;
  void sync() {}
  float max_f(float v) { return v; }
  int max_i(int v) { return v; }
  bool any(bool v) { return v; }
  long long sum_ll(long long v) { return v; }
  int argmin_f(float, int i) { return i; }
  uint32_t scan_u(uint32_t v, uint32_t* total) {
    *total = v;
    return 0u;
  }
};

}  // namespace

// Every scan of the launch, one after another. Returns 0.
extern "C" int pack_scan_host_run(const pack_scan::Args* args) {
  for (long long b = 0; b < args->B; ++b) {
    // a batch without topology groups runs the build without their lanes
    if (args->G > 0) {
      SerialBlock<true> blk;
      pack_scan::scan(blk, *args, b);
    } else {
      SerialBlock<false> blk;
      pack_scan::scan(blk, *args, b);
    }
  }
  return 0;
}
