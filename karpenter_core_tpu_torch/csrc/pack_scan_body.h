// The greedy pack scan over FFD-ordered items, for every scan without
// topology groups: the logic of ops/pack.py's make_pack_kernel.pack
// (the reference's lax.scan over items with its lax.while_loop per item,
// karpenter_core_tpu/ops/pack.py make_pack_kernel) under the prescreen,
// with a commit log, written once against a few block primitives.
//
// A "block" runs one scan. Every thread of it executes this code; the
// scalar state (remaining replicas, nopen, the log's pointers) lives in
// registers and is the same in every thread, since each decision is taken
// from a block-wide reduction that every thread receives. Work over an
// index range is a strided loop, and a barrier separates a phase's writes
// from the next phase's reads. csrc/pack_scan.cu defines the primitives
// for a CUDA thread block (warp shuffles and shared memory),
// csrc/pack_scan_host.cpp as serial loops (the CPU build the tests hold
// against the reference). The primitives a block type Blk provides:
//
//   tid, nt          this thread's index and the block's thread count
//   sync()           a barrier (global and shared writes before it are
//                    visible to the block after it)
//   max_f, max_i, any, sum_ll
//                    block-wide reductions, the result in every thread
//   argmin_f(v, i)   the index of the least value, the first index
//                    winning ties (i < 0: no candidate)
//   scan_u(v, &tot)  the exclusive prefix of unsigned values in thread
//                    order, and their total
//
// Every reduction that feeds a decision is order-independent (a min or
// max of floats, the first index, 0/1 flags and integer sums), so the
// scan takes the same branches on the card and on the host. The float
// updates are single float32 operations in the eager scan's order (the
// CUDA build runs with -fmad=false, so no multiply-add is contracted),
// so the slot state matches bit for bit.

#pragma once

#include <cmath>
#include <cstdint>

#include "screen_dev.cuh"

#if defined(__CUDACC__)
#define PS_FN __device__ inline
#else
#define PS_FN inline
#endif

namespace pack_scan {

typedef long long ll;

constexpr float BIG = 1e30f;   // ops/pack.py BIG, as float32
constexpr int BIGK = 1 << 30;  // ops/pack.py BIGK
constexpr int HDR = 8;         // per scan: ptr, bulk_n, nopen, items, bulk, candidate, open, -

// The launch's arguments. Every field is 8 bytes (ops/pack_scan.py mirrors
// the order with ctypes). Planes are row-major and contiguous; bool planes
// are one byte per value. Per-scan tensors carry a leading [B] axis.
struct Args {
  // sizes
  ll B, N, V, K, R, T, J, I, M, C, Q, W, D, EV, E, L, LB, WSCR, zlo, zhi, clo, chi, NW, KW,
      TOLW;
  // items [I, ...] (the whole item axis; a scan reads the rows it lists)
  const uint8_t* i_allow;   // [I, V]
  const uint8_t* i_out;     // [I, K]
  const uint8_t* i_def;     // [I, K]
  const float* i_req;       // [I, R]
  const uint8_t* i_tol;     // [I, TOLW] toleration of templates then existing slots
  const uint8_t* i_valid;   // [I]
  const int32_t* i_count;   // [I]
  const int32_t* i_scls;    // [I] verdict-tensor column
  const uint8_t* i_ports;   // [I, Q]
  const uint8_t* i_conf;    // [I, Q]
  const uint8_t* i_vols;    // [I, W]
  const int32_t* item_sel;  // [B, M] item rows per scan, -1 pads; null: 0 .. M - 1
  const uint8_t* f_static;  // [J, I, T]
  const uint8_t* openable;  // [J, I]
  // templates
  const uint8_t* t_allow;   // [J, V]
  const uint8_t* t_out;     // [J, K]
  const uint8_t* t_def;     // [J, K]
  const float* t_daemon;    // [J, R]
  const uint8_t* t_tmask;   // [J, T]
  const uint8_t* t_rows;    // [J, C] each template's verdict row
  // instance types
  const uint8_t* y_allow;   // [T, V]
  const uint8_t* y_out;     // [T, K]
  const uint8_t* y_def;     // [T, K]
  const uint8_t* y_esc;     // [T, K]
  const float* y_alloc;     // [T, R]
  const float* y_cap;       // [T, R]
  const uint8_t* y_offer;   // [T, zhi - zlo, chi - clo]
  // volumes
  const float* vol_limits;  // [EV, D] (inf: no limit)
  const float* vol_driver;  // [W, D] claim -> driver one-hot
  // keys: segment [key_lo, key_hi) of the value axis; key_scr: lo < WSCR
  const int32_t* key_lo;
  const int32_t* key_hi;
  const uint8_t* key_scr;
  // the screen's packing (ops/screen.ScreenLayout) and the class planes
  const int32_t* bit_col;    // [32 NW]
  const int32_t* word_key;   // [NW]
  const uint32_t* word_valid;  // [NW] bits that map to a value
  const int32_t* key_w0;     // [K] first word of each key
  const int32_t* key_w1;     // [K] one past its last
  const int32_t* group_w0;   // [KW + 1] first word of each key group
  const uint32_t* on_row;    // [KW] every key (items_vs_row)
  const uint32_t* on_rows;   // [KW] keys inside the screen width (rows_vs_items)
  const uint32_t* c_words;   // [NW, C] class planes, word-major
  const uint32_t* c_flags;   // [4, KW, C] def, out, esc, deny
  // slot state [B, ...] (PackState), updated in place
  float* used;         // [B, N, R]
  uint8_t* open;       // [B, N]
  uint8_t* is_ex;      // [B, N]
  int32_t* tmpl;       // [B, N]
  int32_t* tol_idx;    // [B, N]
  int32_t* pods;       // [B, N]
  uint8_t* allow;      // [B, N, V]
  uint8_t* out;        // [B, N, K]
  uint8_t* def;        // [B, N, K]
  uint8_t* tmask;      // [B, N, T]
  float* cap;          // [B, N, R]
  float* remaining;    // [B, J, R]
  uint8_t* ports;      // [B, N, Q]
  uint8_t* vols;       // [B, EV, W]
  uint8_t* screen;     // [B, N, C] the verdict tensor, kept in step with the planes
  int32_t* nopen;      // [B]
  // results: per scan HDR words then the log's item, slot, ns, k, k_last [5, L]
  int32_t* hdr;        // [B, HDR + 5 L]
  int32_t* bulk_take;  // [B, LB, E]
  // scratch [B, ...]
  float* score;        // [B, N]
  int32_t* keff;       // [B, E]
  int32_t* take;       // [B, E]
  uint8_t* m_allow;    // [B, V] a merged row
  uint8_t* m_keys;     // [B, 3, K] its out, defined, escape
  uint8_t* ctm;        // [B, T] surviving types
  int32_t* kcap;       // [B, T] replicas per type
  uint32_t* sw;        // [B, NW] a slot row's words
  uint32_t* sflag;     // [B, 3 KW] its def, out, esc bitmasks
  float* rvec;         // [B, 3, R] per-resource scratch
  int32_t* progress;   // [B] items stepped, in host memory the card writes; or null
};

template <class T>
PS_FN T clampv(T x, T lo, T hi) {  // torch.clamp: a NaN passes through
  return x < lo ? lo : (x > hi ? hi : x);
}

template <class T>
PS_FN T mn(T a, T b) { return b < a ? b : a; }

template <class T>
PS_FN T mx(T a, T b) { return a < b ? b : a; }

// replica_cap (ops/pack.py): the most identical replicas of `req` that fit
// `alloc` on top of `used`, with the float floor corrected by one either
// way, BIGK for a resource the item does not request, 0 for an invalid row.
PS_FN int replica_cap(const float* alloc, const float* used, const float* req, ll R) {
  int kmin = BIGK;
  bool valid = true;
  for (ll r = 0; r < R; ++r) {
    const float room = alloc[r] - used[r];
    const bool safe = req[r] > 0.0f;
    const float denom = safe ? req[r] : 1.0f;
    float kf = clampv(floorf(room / denom), 0.0f, (float)BIGK);
    kf = (kf + 1.0f) * denom <= room ? kf + 1.0f : kf;
    kf = kf * denom > room ? kf - 1.0f : kf;
    const int k = safe ? (int)clampv(kf, 0.0f, (float)BIGK) : BIGK;
    kmin = mn(kmin, k);
    valid = valid && alloc[r] >= 0.0f && (room >= 0.0f || safe);
  }
  return valid ? kmin : 0;
}

// One scan's view of the arguments.
struct Scan {
  const Args* a;
  ll b;
  float* used;
  uint8_t* open;
  uint8_t* is_ex;
  int32_t* tmpl;
  int32_t* tol_idx;
  int32_t* pods;
  uint8_t* allow;
  uint8_t* out;
  uint8_t* def;
  uint8_t* tmask;
  float* cap;
  float* remaining;
  uint8_t* ports;
  uint8_t* vols;
  uint8_t* screen;
  int32_t* hdr;
  int32_t* bulk_take;
  float* score;
  int32_t* keff;
  int32_t* take;
  uint8_t* m_allow;
  uint8_t* m_out;
  uint8_t* m_def;
  uint8_t* m_esc;
  uint8_t* ctm;
  int32_t* kcap;
  uint32_t* sw;
  uint32_t* sflag;
  float* rvec;
  // the item being stepped
  ll gi;
  const uint8_t* allow_i;
  const uint8_t* out_i;
  const uint8_t* def_i;
  const float* req_i;
  const uint8_t* ports_i;
  const uint8_t* vols_i;
  bool plane_mut;
  bool writes_vols;
  ll pcap;  // the host-port replica cap (1) or BIGK
  // scalar scan state, the same in every thread
  ll nopen, ptr, bulk_n;
  ll n_items, n_bulk, n_cand, n_open;
};

PS_FN void log_write(Scan& s, int tid, ll item, ll slot, ll ns, ll k, ll k_last) {
  const ll L = s.a->L;
  if (tid == 0 && s.ptr < L) {
    int32_t* lg = s.hdr + HDR;
    lg[0 * L + s.ptr] = (int32_t)item;
    lg[1 * L + s.ptr] = (int32_t)slot;
    lg[2 * L + s.ptr] = (int32_t)ns;
    lg[3 * L + s.ptr] = (int32_t)k;
    lg[4 * L + s.ptr] = (int32_t)k_last;
  }
  s.ptr += 1;
}

// The merged row of a slot or template row with the item: allow and out
// intersect, defined unites (ops/pack.py do_candidate, open_commit), then
// the merged row's escape flags over each key's segment clipped to the
// screen width (compat.escape_flags_m on m_allow[:WSCR]).
template <class Blk>
PS_FN void merge_row(Blk& blk, Scan& s, const uint8_t* r_allow, const uint8_t* r_out,
                     const uint8_t* r_def) {
  const Args& a = *s.a;
  for (ll v = blk.tid; v < a.V; v += blk.nt) s.m_allow[v] = r_allow[v] & s.allow_i[v];
  for (ll k = blk.tid; k < a.K; k += blk.nt) {
    s.m_out[k] = r_out[k] & s.out_i[k];
    s.m_def[k] = r_def[k] | s.def_i[k];
  }
  blk.sync();
  for (ll k = blk.tid; k < a.K; k += blk.nt) {
    const ll lo = mn<ll>(a.key_lo[k], a.WSCR), hi = mn<ll>(a.key_hi[k], a.WSCR);
    bool has_a = false, has_x = false;
    for (ll v = lo; v < hi; ++v) {
      if (s.m_allow[v]) has_a = true; else has_x = true;
    }
    s.m_esc[k] = screen_dev::slot_escape(s.m_def[k] != 0, s.m_out[k] != 0, has_a, has_x);
  }
  blk.sync();
}

// merged_types_compat for type t, without the base mask: the merged row
// (merge_row) intersects the type's requirements (row_vs_rows_compat_m on
// the screen width) and some offering's zone and capacity type.
PS_FN bool type_compat(const Scan& s, ll t) {
  const Args& a = *s.a;
  const uint8_t* ya = a.y_allow + t * a.V;
  for (ll k = 0; k < a.K; ++k) {
    if (!(s.m_def[k] && a.y_def[t * a.K + k])) continue;
    if (s.m_out[k] && a.y_out[t * a.K + k]) continue;
    if (s.m_esc[k] && a.y_esc[t * a.K + k]) continue;
    const ll lo = mn<ll>(a.key_lo[k], a.WSCR), hi = mn<ll>(a.key_hi[k], a.WSCR);
    bool inter = false;
    for (ll v = lo; v < hi && !inter; ++v) inter = ya[v] && s.m_allow[v];
    if (!inter) return false;
  }
  const ll NZ = a.zhi - a.zlo, NC = a.chi - a.clo;
  const uint8_t* off = a.y_offer + t * NZ * NC;
  for (ll z = 0; z < NZ; ++z) {
    if (!s.m_allow[a.zlo + z]) continue;
    for (ll c = 0; c < NC; ++c) {
      if (s.m_allow[a.clo + c] && off[z * NC + c]) return true;
    }
  }
  return false;
}

// ops/pack.py _segment_max_alloc: out[r] = the largest allocatable of
// resource r over the types `mask` keeps, -BIG when it keeps none.
template <class Blk>
PS_FN void segment_max_alloc(Blk& blk, const Scan& s, const uint8_t* mask, ll kmin, float* out) {
  const Args& a = *s.a;
  for (ll r = 0; r < a.R; ++r) {
    float m = -BIG;
    for (ll t = blk.tid; t < a.T; t += blk.nt) {
      if (mask ? mask[t] != 0 : (s.ctm[t] && s.kcap[t] >= kmin)) m = mx(m, a.y_alloc[t * a.R + r]);
    }
    const float v = blk.max_f(m);
    if (blk.tid == 0) out[r] = v;
  }
  blk.sync();
}

// Re-screen one slot row (allow [V], out, defined [K]) against every class
// column into dst [C], with key rule `on` (ops/screen.py): the row's words
// and bitmasks as screen_prep derives them, then the row form's algebra.
template <class Blk>
PS_FN void screen_slot_row(Blk& blk, Scan& s, const uint8_t* r_allow, const uint8_t* r_out,
                           const uint8_t* r_def, const uint32_t* on, uint8_t* dst) {
  const Args& a = *s.a;
  for (ll w = blk.tid; w < a.NW; w += blk.nt) {
    s.sw[w] = screen_dev::pack_word(r_allow, a.bit_col, (int)w);
  }
  blk.sync();
  for (ll q = blk.tid; q < a.KW; q += blk.nt) {
    unsigned d = 0u, o = 0u, e = 0u;
    for (ll j = 0; j < 32 && 32 * q + j < a.K; ++j) {
      const ll k = 32 * q + j;
      bool has_a = false, has_x = false;
      for (ll w = a.key_w0[k]; w < a.key_w1[k]; ++w) {
        has_a = has_a || s.sw[w] != 0u;
        has_x = has_x || (~s.sw[w] & a.word_valid[w]) != 0u;
      }
      const bool dk = r_def[k] != 0, ok = r_out[k] != 0;
      if (dk) d |= 1u << j;
      if (ok) o |= 1u << j;
      if (screen_dev::slot_escape(dk, ok, has_a, has_x)) e |= 1u << j;
    }
    s.sflag[q] = d;
    s.sflag[a.KW + q] = o;
    s.sflag[2 * a.KW + q] = e;
  }
  blk.sync();
  const ll C = a.C, KW = a.KW;
  for (ll c = blk.tid; c < C; c += blk.nt) {
    bool fail = false;
    for (ll q = 0; q < KW && !fail; ++q) {
      const unsigned inter = screen_dev::row_inter(s.sw, a.c_words, (size_t)C, (size_t)c,
                                                   a.word_key, a.group_w0[q], a.group_w0[q + 1],
                                                   1);
      fail = !screen_dev::group_ok(s.sflag[q], s.sflag[KW + q], s.sflag[2 * KW + q],
                                   a.c_flags[(0 * KW + q) * C + c],
                                   a.c_flags[(1 * KW + q) * C + c],
                                   a.c_flags[(2 * KW + q) * C + c],
                                   a.c_flags[(3 * KW + q) * C + c], inter, on[q]);
    }
    dst[c] = fail ? 0 : 1;
  }
  blk.sync();
}

// do_candidate: verify and commit to the best-ranked slot.
template <class Blk>
PS_FN void do_candidate(Blk& blk, Scan& s, ll& remaining) {
  const Args& a = *s.a;
  const ll N = a.N, R = a.R, T = a.T, K = a.K, V = a.V;
  float best = BIG;
  ll bi = -1;
  for (ll n = blk.tid; n < N; n += blk.nt) {
    if (s.score[n] < best) {
      best = s.score[n];
      bi = n;
    }
  }
  // an all-BIG score takes slot 0 (torch.argmin's first index)
  ll n = blk.argmin_f(best, (int)bi);
  if (n < 0) n = 0;
  const bool is_ex = s.is_ex[n] != 0;
  merge_row(blk, s, s.allow + n * V, s.out + n * K, s.def + n * K);
  const float* used_n = s.used + n * R;
  ll kmax;
  if (is_ex) {
    kmax = replica_cap(s.cap + n * R, used_n, s.req_i, R);
    blk.sync();  // every thread has read used[n] before the commit writes it
  } else {
    const uint8_t* fs = a.f_static + ((ll)s.tmpl[n] * a.I + s.gi) * T;
    int km = 0;
    for (ll t = blk.tid; t < T; t += blk.nt) {
      const bool ok = s.tmask[n * T + t] && fs[t] && type_compat(s, t);
      const int kc = replica_cap(a.y_alloc + t * R, used_n, s.req_i, R);
      s.ctm[t] = ok;
      s.kcap[t] = kc;
      if (ok) km = mx(km, kc);
    }
    kmax = blk.max_i(km);
  }
  kmax = mn<ll>(mn<ll>(kmax, s.pcap), BIGK);
  const ll k = mn(remaining, kmax);
  const bool commit = kmax >= 1 && k >= 1 && s.ptr < a.L;
  if (commit) {
    for (ll r = blk.tid; r < R; r += blk.nt) {
      s.used[n * R + r] = s.used[n * R + r] + (float)k * s.req_i[r];
    }
    for (ll v = blk.tid; v < V; v += blk.nt) s.allow[n * V + v] = s.m_allow[v];
    for (ll kk = blk.tid; kk < K; kk += blk.nt) {
      s.out[n * K + kk] = s.m_out[kk];
      s.def[n * K + kk] = s.m_def[kk];
    }
    for (ll q = blk.tid; q < a.Q; q += blk.nt) s.ports[n * a.Q + q] |= s.ports_i[q];
    if (s.writes_vols && n < a.EV) {
      for (ll w = blk.tid; w < a.W; w += blk.nt) s.vols[n * a.W + w] |= s.vols_i[w];
    }
    if (!is_ex) {
      for (ll t = blk.tid; t < T; t += blk.nt) {
        s.tmask[n * T + t] = s.ctm[t] && s.kcap[t] >= k;
      }
      segment_max_alloc(blk, s, nullptr, k, s.rvec);
      for (ll r = blk.tid; r < R; r += blk.nt) s.cap[n * R + r] = s.rvec[r];
    }
    if (blk.tid == 0) s.pods[n] += (int32_t)k;
    log_write(s, blk.tid, s.gi, n, 1, k, k);
    remaining -= k;
    blk.sync();
    if (s.plane_mut) {
      screen_slot_row(blk, s, s.allow + n * V, s.out + n * K, s.def + n * K, a.on_row,
                      s.screen + n * a.C);
    }
  }
  // retire on failure or when filled to capacity
  if (!commit || k >= kmax) {
    if (blk.tid == 0) s.score[n] = BIG;
  }
  blk.sync();
}

// open_commit: bulk-open fresh slots from the first template that can host
// the item. Returns false when nothing can open (the item is exhausted).
template <class Blk>
PS_FN bool open_commit(Blk& blk, Scan& s, ll& remaining) {
  const Args& a = *s.a;
  const ll N = a.N, R = a.R, T = a.T, K = a.K, V = a.V, J = a.J, C = a.C;
  // the first template (weight order) with a type that survives, fits one
  // replica over its daemons and stays within the provisioner's limits
  ll jc = -1;
  for (ll j = 0; j < J && jc < 0; ++j) {
    if (!a.openable[j * a.I + s.gi]) continue;
    merge_row(blk, s, a.t_allow + j * V, a.t_out + j * K, a.t_def + j * K);
    const uint8_t* fs = a.f_static + (j * a.I + s.gi) * T;
    const float* rem = s.remaining + j * R;
    bool viable = false;
    for (ll t = blk.tid; t < T && !viable; t += blk.nt) {
      if (!(a.t_tmask[j * T + t] && fs[t])) continue;
      bool cap_ok = true;
      for (ll r = 0; r < R; ++r) cap_ok = cap_ok && a.y_cap[t * R + r] <= rem[r];
      viable = cap_ok && replica_cap(a.y_alloc + t * R, a.t_daemon + j * R, s.req_i, R) >= 1 &&
               type_compat(s, t);
    }
    if (blk.any(viable)) jc = j;
  }
  if (jc < 0) return false;
  merge_row(blk, s, a.t_allow + jc * V, a.t_out + jc * K, a.t_def + jc * K);
  const uint8_t* fs = a.f_static + (jc * a.I + s.gi) * T;
  const float* rem = s.remaining + jc * R;
  int m_eff = 0;
  for (ll t = blk.tid; t < T; t += blk.nt) {
    bool cap_ok = true;
    for (ll r = 0; r < R; ++r) cap_ok = cap_ok && a.y_cap[t * R + r] <= rem[r];
    const bool ok = a.t_tmask[jc * T + t] && cap_ok && fs[t] && type_compat(s, t);
    const int kc = replica_cap(a.y_alloc + t * R, a.t_daemon + jc * R, s.req_i, R);
    s.ctm[t] = ok;
    s.kcap[t] = kc;
    if (ok) m_eff = mx(m_eff, kc);
  }
  const ll meff = mn<ll>(blk.max_i(m_eff), mn<ll>(BIGK, s.pcap));
  // provisioner-limit slot budget: the pessimistic capacity over the
  // types that take one replica (scheduler.go:276-293)
  float* max_cap = s.rvec + 2 * R;
  ll s_limit = BIGK;
  {
    float s_min = (float)BIGK;
    for (ll r = 0; r < R; ++r) {
      float m = -BIG;
      for (ll t = blk.tid; t < T; t += blk.nt) {
        if (s.ctm[t] && s.kcap[t] >= 1) m = mx(m, a.y_cap[t * R + r]);
      }
      const float mc = mx(blk.max_f(m), 0.0f);
      if (blk.tid == 0) max_cap[r] = mc;
      const float sl = mc > 0.0f ? floorf(rem[r] / mc) : (float)BIGK;
      s_min = r == 0 ? sl : mn(s_min, sl);
    }
    s_limit = (ll)clampv(s_min, 0.0f, (float)BIGK);
  }
  const ll target = remaining;
  const ll per = mx<ll>(meff, 1);
  const ll s_need = (target + per - 1) / per;
  const ll ns = mn(mn(s_need, N - s.nopen), s_limit);
  if (!(meff >= 1 && ns >= 1 && s.ptr < a.L)) {
    blk.sync();
    return false;
  }
  const ll placed = mn(target, ns * meff);
  const ll k_last = placed - (ns - 1) * meff;
  const ll lo = s.nopen, hi = s.nopen + ns;
  // the full and the last slot's capacities
  segment_max_alloc(blk, s, nullptr, meff, s.rvec);
  segment_max_alloc(blk, s, nullptr, k_last, s.rvec + R);
  blk.sync();
  for (ll n = lo + blk.tid; n < hi; n += blk.nt) {
    const ll kr = n == hi - 1 ? k_last : meff;
    for (ll r = 0; r < R; ++r) {
      s.used[n * R + r] = a.t_daemon[jc * R + r] + (float)kr * s.req_i[r];
      s.cap[n * R + r] = s.rvec[(n == hi - 1 ? R : 0) + r];
    }
    s.open[n] = 1;
    s.is_ex[n] = 0;
    s.tmpl[n] = (int32_t)jc;
    s.tol_idx[n] = (int32_t)jc;
    s.pods[n] = (int32_t)kr;
    for (ll q = 0; q < a.Q; ++q) s.ports[n * a.Q + q] = s.ports_i[q];
    s.score[n] = ((float)N + (float)kr * (float)N) + (float)n;
  }
  for (ll e = blk.tid; e < ns * V; e += blk.nt) s.allow[lo * V + e] = s.m_allow[e % V];
  for (ll e = blk.tid; e < ns * K; e += blk.nt) {
    s.out[lo * K + e] = s.m_out[e % K];
    s.def[lo * K + e] = s.m_def[e % K];
  }
  for (ll e = blk.tid; e < ns * T; e += blk.nt) {
    const ll t = e % T;
    s.tmask[lo * T + e] = s.ctm[t] && s.kcap[t] >= (e / T == ns - 1 ? k_last : meff);
  }
  blk.sync();
  if (blk.tid == 0) {
    for (ll r = 0; r < R; ++r) s.remaining[jc * R + r] = rem[r] - (float)ns * max_cap[r];
  }
  log_write(s, blk.tid, s.gi, lo, ns, meff, k_last);
  remaining -= placed;
  s.nopen = hi;
  // the opened rows' verdicts: one row, the same for every opened slot
  uint8_t* row0 = s.screen + lo * C;
  if (ns > mn<ll>(64, N)) {
    screen_slot_row(blk, s, s.m_allow, s.m_out, s.m_def, a.on_rows, row0);
  } else if (s.plane_mut) {
    screen_slot_row(blk, s, s.m_allow, s.m_out, s.m_def, a.on_row, row0);
  } else {
    for (ll c = blk.tid; c < C; c += blk.nt) row0[c] = a.t_rows[jc * C + c];
    blk.sync();
  }
  for (ll e = blk.tid; e < (ns - 1) * C; e += blk.nt) row0[C + e] = row0[e % C];
  blk.sync();
  return true;
}

// do_bulk: every candidate of the existing prefix in one commit, filled
// in index order under per-slot caps. Returns false when the fused open
// found nothing to open (the item is exhausted).
template <class Blk>
PS_FN bool do_bulk(Blk& blk, Scan& s, ll& remaining) {
  const Args& a = *s.a;
  const ll E = a.E, R = a.R, V = a.V, K = a.K, N = a.N;
  for (ll n = blk.tid; n < E; n += blk.nt) {
    const bool cand = s.score[n] < BIG && s.is_ex[n];
    const int ks = replica_cap(s.cap + n * R, s.used + n * R, s.req_i, R);
    s.keff[n] = cand ? (int32_t)mn<ll>(ks, mn<ll>(BIGK, s.pcap)) : 0;
  }
  blk.sync();
  // take = min(max(budget - (csum - k_eff), 0), k_eff), the prefix sum in
  // int32 arithmetic as torch.cumsum(dtype=int32) computes it
  const uint32_t budget = (uint32_t)(int32_t)remaining;
  uint32_t carry = 0u;
  ll placed_part = 0;
  for (ll base = 0; base < E; base += blk.nt) {
    const ll n = base + blk.tid;
    const uint32_t v = n < E ? (uint32_t)s.keff[n] : 0u;
    uint32_t total = 0u;
    const uint32_t excl = blk.scan_u(v, &total);
    if (n < E) {
      const uint32_t before = carry + excl;  // csum - k_eff
      const int32_t left = (int32_t)(budget - before);
      const int32_t t = mn<int32_t>(mx<int32_t>(left, 0), (int32_t)v);
      s.take[n] = t;
      placed_part += t;
    }
    carry += total;
  }
  const ll placed = blk.sum_ll(placed_part);
  const bool commit = placed >= 1 && s.ptr < a.L && s.bulk_n < a.LB;
  blk.sync();
  if (commit) {
    int32_t* row = s.bulk_take + s.bulk_n * E;
    for (ll n = blk.tid; n < E; n += blk.nt) {
      const int32_t t = s.take[n];
      for (ll r = 0; r < R; ++r) {
        s.used[n * R + r] = s.used[n * R + r] + (float)t * s.req_i[r];
      }
      s.pods[n] += t;
      row[n] = t;
      if (t > 0) {
        for (ll q = 0; q < a.Q; ++q) s.ports[n * a.Q + q] |= s.ports_i[q];
        if (s.writes_vols && n < a.EV) {
          for (ll w = 0; w < a.W; ++w) s.vols[n * a.W + w] |= s.vols_i[w];
        }
      }
    }
    // the touched rows' planes, a thread per value across the rows
    for (ll e = blk.tid; e < E * V; e += blk.nt) {
      if (s.take[e / V] > 0) s.allow[e] = s.allow[e] & s.allow_i[e % V];
    }
    for (ll e = blk.tid; e < E * K; e += blk.nt) {
      if (s.take[e / K] > 0) {
        s.out[e] = s.out[e] & s.out_i[e % K];
        s.def[e] = s.def[e] | s.def_i[e % K];
      }
    }
    log_write(s, blk.tid, s.gi, 0, -1, s.bulk_n, placed);
    s.bulk_n += 1;
    remaining -= placed;
    blk.sync();
    if (s.plane_mut) {
      for (ll n = 0; n < E; ++n) {
        if (s.take[n] > 0) {
          screen_slot_row(blk, s, s.allow + n * V, s.out + n * K, s.def + n * K, a.on_rows,
                          s.screen + n * a.C);
        }
      }
    }
  }
  // retire the candidates that failed or were filled
  bool exist_left = false, mach_cand = false;
  for (ll n = blk.tid; n < N; n += blk.nt) {
    float sc = s.score[n];
    if (n < E && sc < BIG && s.is_ex[n]) {
      if (!commit || s.keff[n] == 0 || s.take[n] >= s.keff[n]) {
        sc = BIG;
        s.score[n] = BIG;
      }
    }
    if (sc < BIG) {
      if (s.is_ex[n]) exist_left = true; else mach_cand = true;
    }
  }
  exist_left = blk.any(exist_left);
  mach_cand = blk.any(mach_cand);
  // fused open: no candidate left at all -> open in the same iteration
  if (commit && !exist_left && !mach_cand && remaining > 0) return open_commit(blk, s, remaining);
  return true;
}

// The screen of every open slot against the item, into the score: existing
// slots rank by index, open machines by pods then index, BIG elsewhere.
template <class Blk>
PS_FN void screen_item(Blk& blk, Scan& s, const uint8_t* tol_i, const uint8_t* conf_i,
                       bool has_conf, ll cls) {
  const Args& a = *s.a;
  const ll N = a.N, R = a.R, Q = a.Q, W = a.W, D = a.D, C = a.C;
  for (ll n = blk.tid; n < N; n += blk.nt) {
    float sc = BIG;
    bool ok = n < s.nopen && s.open[n] && tol_i[s.tol_idx[n]] && s.screen[n * C + cls];
    for (ll r = 0; r < R && ok; ++r) {
      const float c = s.cap[n * R + r];
      ok = s.used[n * R + r] + s.req_i[r] <= c && c >= 0.0f;
    }
    if (ok && has_conf) {
      for (ll q = 0; q < Q && ok; ++q) ok = !(s.ports[n * Q + q] && conf_i[q]);
    }
    if (ok && W > 0 && n < a.EV) {
      // CSI attach limits: mounted claims per driver plus the item's new
      // ones (0/1 sums, exact in float32)
      const uint8_t* vn = s.vols + n * W;
      for (ll d = 0; d < D && ok; ++d) {
        float cnt = 0.0f;
        for (ll w = 0; w < W; ++w) {
          if (vn[w] || s.vols_i[w]) cnt += a.vol_driver[w * D + d];
        }
        ok = cnt <= a.vol_limits[n * D + d];
      }
    }
    if (ok) {
      sc = s.is_ex[n] ? (float)n : ((float)N + (float)s.pods[n] * (float)N) + (float)n;
    }
    s.score[n] = sc;
  }
  blk.sync();
}

// One scan: block b of the launch.
template <class Blk>
PS_FN void scan(Blk& blk, const Args& a, ll b) {
  const ll N = a.N, V = a.V, K = a.K, R = a.R, T = a.T, L = a.L;
  Scan s;
  s.a = &a;
  s.b = b;
  s.used = a.used + b * N * R;
  s.open = a.open + b * N;
  s.is_ex = a.is_ex + b * N;
  s.tmpl = a.tmpl + b * N;
  s.tol_idx = a.tol_idx + b * N;
  s.pods = a.pods + b * N;
  s.allow = a.allow + b * N * V;
  s.out = a.out + b * N * K;
  s.def = a.def + b * N * K;
  s.tmask = a.tmask + b * N * T;
  s.cap = a.cap + b * N * R;
  s.remaining = a.remaining + b * a.J * R;
  s.ports = a.ports + b * N * a.Q;
  s.vols = a.vols + b * a.EV * a.W;
  s.screen = a.screen + b * N * a.C;
  s.hdr = a.hdr + b * (HDR + 5 * L);
  s.bulk_take = a.bulk_take + b * a.LB * a.E;
  s.score = a.score + b * N;
  s.keff = a.keff + b * a.E;
  s.take = a.take + b * a.E;
  s.m_allow = a.m_allow + b * V;
  s.m_out = a.m_keys + b * 3 * K;
  s.m_def = s.m_out + K;
  s.m_esc = s.m_def + K;
  s.ctm = a.ctm + b * T;
  s.kcap = a.kcap + b * T;
  s.sw = a.sw + b * a.NW;
  s.sflag = a.sflag + b * 3 * a.KW;
  s.rvec = a.rvec + b * 3 * R;
  s.nopen = a.nopen[b];
  s.ptr = s.bulk_n = 0;
  s.n_items = s.n_bulk = s.n_cand = s.n_open = 0;

  int32_t* lg = s.hdr + HDR;
  for (ll e = blk.tid; e < 5 * L; e += blk.nt) lg[e] = e < L ? -1 : 0;
  for (ll e = blk.tid; e < a.LB * a.E; e += blk.nt) s.bulk_take[e] = 0;
  blk.sync();

  for (ll m = 0; m < a.M; ++m) {
    const ll gi = a.item_sel ? (ll)a.item_sel[b * a.M + m] : m;
    if (gi < 0 || !a.i_valid[gi] || a.i_count[gi] <= 0) continue;
    const ll count = a.i_count[gi];
    s.n_items += 1;
    if (a.progress && blk.tid == 0) {
      // the host's proof of life for the dispatch watchdogs
      *(volatile int32_t*)(a.progress + b) = (int32_t)s.n_items;
#if defined(__CUDA_ARCH__)
      __threadfence_system();
#endif
    }
    s.gi = gi;
    s.allow_i = a.i_allow + gi * V;
    s.out_i = a.i_out + gi * K;
    s.def_i = a.i_def + gi * K;
    s.req_i = a.i_req + gi * R;
    s.ports_i = a.i_ports + gi * a.Q;
    s.vols_i = a.i_vols + gi * a.W;
    const uint8_t* conf_i = a.i_conf + gi * a.Q;
    bool has_ports = false, has_conf = false, has_vols = false;
    for (ll q = 0; q < a.Q; ++q) {
      has_ports = has_ports || s.ports_i[q];
      has_conf = has_conf || conf_i[q];
    }
    for (ll w = 0; w < a.W; ++w) has_vols = has_vols || s.vols_i[w];
    bool mut = false;
    for (ll k = 0; k < K; ++k) mut = mut || (s.def_i[k] && a.key_scr[k]);
    s.plane_mut = mut;
    s.writes_vols = has_vols;
    // a pod with host ports never runs two replicas on one node
    s.pcap = has_ports ? 1 : BIGK;

    screen_item(blk, s, a.i_tol + gi * a.TOLW, conf_i, has_conf, a.i_scls[gi]);

    ll remaining = count;
    bool exhausted = false;
    ll tries = 0;
    // backstop only: commits consume count, failed verifies retire slots
    while (remaining > 0 && !exhausted && tries < count + N + V + 64) {
      tries += 1;
      bool hc = false, ec = false;
      for (ll n = blk.tid; n < N; n += blk.nt) {
        if (s.score[n] < BIG) {
          hc = true;
          if (s.is_ex[n]) ec = true;
        }
      }
      const bool has_cand = blk.any(hc);
      const bool exist_cand = blk.any(ec);
      if (a.E > 0 && exist_cand && s.bulk_n < a.LB) {
        s.n_bulk += 1;
        exhausted = !do_bulk(blk, s, remaining);
      } else if (has_cand) {
        s.n_cand += 1;
        do_candidate(blk, s, remaining);
      } else {
        s.n_open += 1;
        exhausted = !open_commit(blk, s, remaining);
      }
    }
  }
  blk.sync();
  if (blk.tid == 0) {
    s.hdr[0] = (int32_t)s.ptr;
    s.hdr[1] = (int32_t)s.bulk_n;
    s.hdr[2] = (int32_t)s.nopen;
    s.hdr[3] = (int32_t)s.n_items;
    s.hdr[4] = (int32_t)s.n_bulk;
    s.hdr[5] = (int32_t)s.n_cand;
    s.hdr[6] = (int32_t)s.n_open;
    s.hdr[7] = 0;
    a.nopen[b] = (int32_t)s.nopen;
  }
}

}  // namespace pack_scan
