// fast_pack: the host greedy FFD packer over dense arrays.
//
// The native fallback of the PyTorch port's solver: the same screen and
// verify greedy the device scan runs (ops/pack.py), over the precomputed
// pod x type static feasibility mask, on the topology-free path only
// (requirements, taints and offerings are all folded into f_static by
// ops/feasibility.feasibility_static). It replaces the per-pod loop of the
// host scheduler (scheduler.go:96-133) at C++ speed.
//
// Build: g++ -O3 -shared -fPIC fast_pack.cpp -o libfastpack.so
// ABI: plain C, loaded with ctypes (karpenter_core_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of pods assigned. Arrays are C-order.
//   pod_requests [P,R]  pod resource vectors, in FFD order
//   f_static     [P,T]  pod x type feasibility (compat, offerings, taints)
//   type_alloc   [T,R]  allocatable per type
//   daemon       [R]    daemon overhead of a fresh machine
//   assigned     [P]    out: slot or -1
//   slot_tmask   [N,T]  out: the types each slot may still be
//   slot_used    [N,R]  out: the requests each slot has taken
//   slot_pods    [N]    out: the pods on each slot
//   nopen_out    [1]    out: the slots opened
int fast_pack(int32_t P, int32_t T, int32_t R, int32_t N,
              const float* pod_requests, const uint8_t* f_static,
              const float* type_alloc, const float* daemon,
              int32_t* assigned, uint8_t* slot_tmask, float* slot_used,
              int32_t* slot_pods, int32_t* nopen_out) {
  std::memset(slot_tmask, 0, (size_t)N * T);
  std::memset(slot_used, 0, (size_t)N * R * sizeof(float));
  std::memset(slot_pods, 0, (size_t)N * sizeof(int32_t));
  int32_t nopen = 0;
  int assigned_count = 0;

  // per slot, the largest allocatable over its remaining types: the cheap
  // screen before the exact per-type check
  std::vector<float> slot_cap((size_t)N * R, 0.0f);

  auto recompute_cap = [&](int32_t n) {
    float* cap = &slot_cap[(size_t)n * R];
    for (int r = 0; r < R; r++) cap[r] = -1.0f;
    const uint8_t* tm = &slot_tmask[(size_t)n * T];
    for (int32_t t = 0; t < T; t++) {
      if (!tm[t]) continue;
      const float* alloc = &type_alloc[(size_t)t * R];
      for (int r = 0; r < R; r++)
        if (alloc[r] > cap[r]) cap[r] = alloc[r];
    }
  };

  for (int32_t p = 0; p < P; p++) {
    const float* req = &pod_requests[(size_t)p * R];
    const uint8_t* fs = &f_static[(size_t)p * T];
    assigned[p] = -1;

    // the open slots, fewest pods first (scheduler.go:186-193)
    int32_t best = -1;
    {
      std::vector<int32_t> idx;
      idx.reserve(nopen);
      for (int32_t n = 0; n < nopen; n++) idx.push_back(n);
      std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
        return slot_pods[a] < slot_pods[b];
      });
      for (int32_t n : idx) {
        const float* used = &slot_used[(size_t)n * R];
        const float* cap = &slot_cap[(size_t)n * R];
        bool screen = true;
        for (int r = 0; r < R; r++) {
          if (used[r] + req[r] > cap[r]) { screen = false; break; }
        }
        if (!screen) continue;
        // exact: a remaining type that the pod may use and that fits
        const uint8_t* tm = &slot_tmask[(size_t)n * T];
        bool any = false;
        for (int32_t t = 0; t < T && !any; t++) {
          if (!tm[t] || !fs[t]) continue;
          const float* alloc = &type_alloc[(size_t)t * R];
          bool fit = true;
          for (int r = 0; r < R; r++) {
            if (used[r] + req[r] > alloc[r] || alloc[r] < 0.0f) { fit = false; break; }
          }
          if (fit) any = true;
        }
        if (any) { best = n; break; }
      }
    }

    if (best >= 0) {
      // commit: take the requests, narrow the types
      float* used = &slot_used[(size_t)best * R];
      uint8_t* tm = &slot_tmask[(size_t)best * T];
      for (int r = 0; r < R; r++) used[r] += req[r];
      for (int32_t t = 0; t < T; t++) {
        if (!tm[t]) continue;
        if (!fs[t]) { tm[t] = 0; continue; }
        const float* alloc = &type_alloc[(size_t)t * R];
        for (int r = 0; r < R; r++) {
          if (used[r] > alloc[r] || alloc[r] < 0.0f) { tm[t] = 0; break; }
        }
      }
      recompute_cap(best);
      slot_pods[best]++;
      assigned[p] = best;
      assigned_count++;
      continue;
    }

    // open a new slot
    if (nopen >= N) continue;
    int32_t n = nopen;
    uint8_t* tm = &slot_tmask[(size_t)n * T];
    float* used = &slot_used[(size_t)n * R];
    bool any = false;
    for (int32_t t = 0; t < T; t++) {
      if (!fs[t]) continue;
      const float* alloc = &type_alloc[(size_t)t * R];
      bool fit = true;
      for (int r = 0; r < R; r++) {
        if (daemon[r] + req[r] > alloc[r] || alloc[r] < 0.0f) { fit = false; break; }
      }
      if (fit) { tm[t] = 1; any = true; }
    }
    if (!any) continue;
    for (int r = 0; r < R; r++) used[r] = daemon[r] + req[r];
    recompute_cap(n);
    slot_pods[n] = 1;
    assigned[p] = n;
    assigned_count++;
    nopen++;
  }
  *nopen_out = nopen;
  return assigned_count;
}

}  // extern "C"
