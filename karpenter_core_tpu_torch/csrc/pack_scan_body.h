// The greedy pack scan over FFD-ordered items, topology groups included:
// the logic of ops/pack.py's make_pack_kernel.pack (the reference's
// lax.scan over items with its lax.while_loop per item,
// karpenter_core_tpu/ops/pack.py make_pack_kernel) under the prescreen,
// with a commit log, written once against a few block primitives. The
// topology lanes are ops/topology.py's functions on the scan's state:
// the per-slot viability (topo_screen), the candidate's and the open's
// narrowing (topo_narrow_single), the value-key spread's water-fill
// (spread_plan), the record after each commit with its node filter
// (topo_record, topo_node_filter_ok) and the bulk fill's narrowing,
// headroom and record (topo_bulk_*, topo_record_bulk), over the whole
// slot axis when the batch has hostname anti-affinity.
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
//   topo             (static) whether this build of the scan has the
//                    topology lanes: a launch whose batch has no group
//                    runs the build without them, which keeps fewer
//                    values live
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

// ops/topology.py's group types, and the columns of a group's metadata row
constexpr int TOPO_SPREAD = 0, TOPO_AFFINITY = 1, TOPO_ANTI = 2;
enum { G_TYPE, G_LO, G_HI, G_KEY, G_SKEW, G_HOST, G_INV, G_TRIV, GMETA };

// The launch's arguments. Every field is 8 bytes (ops/pack_scan.py mirrors
// the order with ctypes). Planes are row-major and contiguous; bool planes
// are one byte per value. Per-scan tensors carry a leading [B] axis.
struct Args {
  // sizes (BR: the bulk region, E or, with MACH, the whole slot axis N)
  ll B, N, V, K, R, T, J, I, M, C, Q, W, D, EV, E, L, LB, WSCR, zlo, zhi, clo, chi, NW, KW,
      TOLW, G, GT, BR, MACH;
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
  const int32_t* i_vptr;    // [I + 1] each item's claims i_vidx[i_vptr[i] .. i_vptr[i + 1])
  const int32_t* i_vidx;    // the claim columns, row by row
  const int32_t* item_sel;  // [B, M] item rows per scan, -1 pads; null: 0 .. M - 1
  const uint8_t* f_static;  // [J, I, T]
  const uint8_t* openable;  // [J, I]
  const uint8_t* i_own;     // [I, G] the item carries the group's constraint
  const uint8_t* i_sel;     // [I, G] the group's selector matches the item
  // topology groups: metadata rows (G_* columns; G_TRIV: the node filter
  // matches every row), each group's node-filter term rows g_trows[g_tptr[g]
  // .. g_tptr[g + 1]) into the term planes, and the well-known keys
  const int32_t* g_meta;    // [G, GMETA]
  const int32_t* g_tptr;    // [G + 1]
  const int32_t* g_trows;
  const uint8_t* term_allow;  // [GT, V]
  const uint8_t* term_out;    // [GT, K]
  const uint8_t* term_def;    // [GT, K]
  const uint8_t* term_esc;    // [GT, K]
  const uint8_t* well_known;  // [K]
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
  float* tcounts;      // [B, G, V] domain counts of the value-key groups
  float* thost;        // [B, G, N] hostname groups' counts per slot
  uint8_t* tdoms;      // [B, G, V] registered domains
  // results: per scan HDR words then the log's item, slot, ns, k, k_last [5, L]
  int32_t* hdr;        // [B, HDR + 5 L]
  int32_t* bulk_take;  // [B, LB, BR]
  // scratch [B, ...]
  float* score;        // [B, N]
  int32_t* keff;       // [B, BR]
  int32_t* take;       // [B, BR]
  uint8_t* m_allow;    // [B, V] a merged row
  uint8_t* m_keys;     // [B, 3, K] its out, defined, escape
  uint8_t* ctm;        // [B, T] surviving types
  int32_t* kcap;       // [B, T] replicas per type
  uint32_t* sw;        // [B, NW] a slot row's words
  uint32_t* sflag;     // [B, 3 KW] its def, out, esc bitmasks
  float* rvec;         // [B, 3, R] per-resource scratch
  float* vcnt;         // [B, EV, D] mounted claims per driver of each existing slot
  uint8_t* tv;         // [B, 6, V] narrow, force, dmark, dead, dom_open, dom_cand
  uint8_t* tk;         // [B, 2, K] applied keys, the merged row's full-width escape
  int32_t* tg;         // [B, 3, G] hostname positives, gate values, node-filter matches
  float* fkey;         // [B, N] the machine-region bulk's take order
  int32_t* rtmp;       // [B, N] per-row flags of the bulk fill
  int32_t* progress;   // [B] steps taken, in host memory the card writes; or null
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
  bool plane_mut;
  bool writes_vols;
  ll pcap;  // the host-port replica cap (1) or BIGK
  // the item's topology flags (ops/pack.py make_pack_kernel.pack)
  bool any_topo, any_own, not_provable, item_bulk_ok, mach_ok, own_hostaff, need_nf;
  ll n_owned_vk;
  // this iteration's water-fill plan: force applies, the gate's columns
  bool use_force;
  ll n_gate;
  // scalar scan state, the same in every thread
  ll nopen, ptr, bulk_n;
  ll n_items, n_bulk, n_cand, n_open, steps;

  // The volume and topology lanes' arrays, derived where they are used
  // (held in the scan's state across its loop, they spill more registers).
  PS_FN float* vcnt() const { return a->vcnt + b * a->EV * a->D; }  // [EV, D]
  PS_FN float* tcounts() const { return a->tcounts + b * a->G * a->V; }
  PS_FN float* thost() const { return a->thost + b * a->G * a->N; }
  PS_FN uint8_t* tdoms() const { return a->tdoms + b * a->G * a->V; }
  PS_FN uint8_t* tv(int i) const { return a->tv + (b * 6 + i) * a->V; }
  PS_FN uint8_t* narrow() const { return tv(0); }    // [V] the committed narrowing
  PS_FN uint8_t* force() const { return tv(1); }     // [V] the water-fill's domains
  PS_FN uint8_t* dmark() const { return tv(2); }     // [V]
  PS_FN uint8_t* dead() const { return tv(3); }      // [V] domains retired by a failed open
  PS_FN uint8_t* dom_open() const { return tv(4); }  // [V] domains a fresh machine could open in
  PS_FN uint8_t* dom_cand() const { return tv(5); }  // [V]
  PS_FN uint8_t* applied() const { return a->tk + b * 2 * a->K; }  // [K] keys narrowed
  PS_FN uint8_t* m_escf() const { return applied() + a->K; }  // [K] whole-segment escapes
  PS_FN int32_t* hany() const { return a->tg + b * 3 * a->G; }  // [G] hostname positives
  PS_FN int32_t* gatev() const { return hany() + a->G; }  // [G] the gate's value columns
  PS_FN int32_t* nf() const { return hany() + 2 * a->G; }  // [G] node-filter matches
  PS_FN float* fkey() const { return a->fkey + b * a->N; }
  PS_FN int32_t* rtmp() const { return a->rtmp + b * a->N; }
  PS_FN const uint8_t* own_i() const { return a->i_own + gi * a->G; }  // [G]
  PS_FN const uint8_t* sel_i() const { return a->i_sel + gi * a->G; }  // [G]
  PS_FN const int32_t* claims() const { return a->i_vidx + a->i_vptr[gi]; }
  PS_FN ll n_claims() const { return a->i_vptr[gi + 1] - a->i_vptr[gi]; }
};

PS_FN const int32_t* gmeta(const Args& a, ll g) { return a.g_meta + g * GMETA; }

// ops/topology._applies: a direct group applies to its owners, an inverse
// group to the pods it selects
PS_FN bool applies(const Scan& s, ll g) {
  return gmeta(*s.a, g)[G_INV] ? s.sel_i()[g] != 0 : s.own_i()[g] != 0;
}

// Requirements.Intersects on one key (requirements.go:189-206) of two
// rows: m the merged row, o a type or term row; [lo, hi) the key's value
// range to intersect over (clipped to the screen width for the types).
PS_FN bool key_intersects(bool md, bool mo, bool me, const uint8_t* ma, bool od, bool oo,
                          bool oe, const uint8_t* oa, ll lo, ll hi) {
  if (!(md && od) || (mo && oo) || (me && oe)) return true;
  for (ll v = lo; v < hi; ++v) {
    if (ma[v] && oa[v]) return true;
  }
  return false;
}

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

// The item's claims mounted on existing slot n, by one thread: the slot's
// volume row and its claims per driver (0/1 sums, exact in float32), as
// the eager scan's vols |= vols_i and its recount vols @ vol_driver.
PS_FN void mount_claims(Scan& s, ll n) {
  const Args& a = *s.a;
  for (ll q = 0; q < s.n_claims(); ++q) {
    const ll w = s.claims()[q];
    if (s.vols[n * a.W + w]) continue;
    s.vols[n * a.W + w] = 1;
    for (ll d = 0; d < a.D; ++d) {
      s.vcnt()[n * a.D + d] = s.vcnt()[n * a.D + d] + a.vol_driver[w * a.D + d];
    }
  }
}

// The merged row of a slot or template row with the item: allow and out
// intersect, defined unites (ops/pack.py do_candidate, open_commit), with
// the topology narrowing when `topo` (s.narrow(), s.applied(): allow narrows,
// the applied keys become defined In-sets), then the merged row's escape
// flags over each key's segment clipped to the screen width
// (compat.escape_flags_m on m_allow[:WSCR]).
template <class Blk>
PS_FN void merge_row(Blk& blk, Scan& s, const uint8_t* r_allow, const uint8_t* r_out,
                     const uint8_t* r_def, bool topo) {
  const Args& a = *s.a;
  for (ll v = blk.tid; v < a.V; v += blk.nt) {
    s.m_allow[v] = r_allow[v] & s.allow_i[v] & (topo ? s.narrow()[v] : 1);
  }
  for (ll k = blk.tid; k < a.K; k += blk.nt) {
    const uint8_t ap = topo ? s.applied()[k] : 0;
    s.m_out[k] = r_out[k] & s.out_i[k] & (uint8_t)!ap;
    s.m_def[k] = r_def[k] | s.def_i[k] | ap;
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
// the screen width) and some offering's zone and capacity type. skip_tail
// leaves out the keys past the screen width, as the machine-region bulk's
// mach_rows_types_compat does (no type defines them).
PS_FN bool type_compat(const Scan& s, ll t, bool skip_tail = false) {
  const Args& a = *s.a;
  const uint8_t* ya = a.y_allow + t * a.V;
  for (ll k = 0; k < a.K; ++k) {
    if (skip_tail && a.key_lo[k] >= a.WSCR) continue;
    const ll lo = mn<ll>(a.key_lo[k], a.WSCR), hi = mn<ll>(a.key_hi[k], a.WSCR);
    const ll tk = t * a.K + k;
    if (!key_intersects(s.m_def[k], s.m_out[k], s.m_esc[k], s.m_allow, a.y_def[tk],
                        a.y_out[tk], a.y_esc[tk], ya, lo, hi)) {
      return false;
    }
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

// ---------------------------------------------------------------------------
// the topology lanes (ops/topology.py; counts are float32 integers, so a
// count's update is exact in any order)

// The item's group flags, read once per item as the eager scan reads its
// host booleans, and, for an owner of a value-key spread, the domains a
// fresh machine could open in (dom_open_one) with its retired domains
// cleared.
template <class Blk>
PS_FN void topo_item(Blk& blk, Scan& s) {
  const Args& a = *s.a;
  const ll G = a.G;
  bool bulk_ok = true, mach_ok = true, owns_nonspread = false;
  s.any_topo = s.any_own = s.own_hostaff = s.need_nf = s.not_provable = s.mach_ok = false;
  s.n_owned_vk = 0;
  s.item_bulk_ok = a.E > 0;
  if (!Blk::topo) return;
  for (ll g = 0; g < G; ++g) {
    const int32_t* m = gmeta(a, g);
    const bool own = s.own_i()[g] != 0, sel = s.sel_i()[g] != 0;
    const bool host = m[G_HOST] != 0, inv = m[G_INV] != 0;
    const bool terms = a.g_tptr[g + 1] > a.g_tptr[g];
    const int ty = m[G_TYPE];
    s.any_topo = s.any_topo || own || sel;
    s.any_own = s.any_own || own;
    // a group on a screened key narrows screened planes
    if ((own || sel) && m[G_LO] < a.WSCR) s.plane_mut = true;
    if (own) {
      if (ty == TOPO_SPREAD && !host) s.n_owned_vk += 1; else owns_nonspread = true;
    }
    if (sel && !inv && !m[G_TRIV]) s.need_nf = true;
    if (own && host && ty == TOPO_AFFINITY && !inv) s.own_hostaff = true;
    // topo_bulk_item_ok
    if (inv) {
      bulk_ok = bulk_ok && !own && !(terms && sel);
    } else {
      if (ty == TOPO_ANTI) bulk_ok = bulk_ok && !(own || sel);
      else if (ty == TOPO_AFFINITY && host) bulk_ok = bulk_ok && !own;
      if (terms) bulk_ok = bulk_ok && !(own || sel);
    }
    // topo_mach_bulk_item_ok
    if (terms) mach_ok = mach_ok && !(own || sel);
    else if (inv) mach_ok = mach_ok && (host || !own);
    else if (ty == TOPO_ANTI && !host) mach_ok = mach_ok && !(own || sel);
    else if (ty == TOPO_AFFINITY && host) mach_ok = mach_ok && !own;
  }
  s.not_provable = s.n_owned_vk > 1 || owns_nonspread;
  s.item_bulk_ok = a.E > 0 && bulk_ok;
  s.mach_ok = a.MACH != 0 && mach_ok;
  if (s.n_owned_vk == 0) return;
  for (ll v = blk.tid; v < a.V; v += blk.nt) {
    s.dom_open()[v] = 0;
    s.dead()[v] = 0;
  }
  blk.sync();
  const ll T = a.T, NC = a.chi - a.clo, NZ = a.zhi - a.zlo;
  for (ll g = 0; g < G; ++g) {
    const int32_t* m = gmeta(a, g);
    if (!s.own_i()[g] || m[G_TYPE] != TOPO_SPREAD || m[G_HOST]) continue;
    const ll lo = m[G_LO], hi = m[G_HI];
    const bool zone = lo == a.zlo && hi == a.zhi;
    for (ll e = blk.tid; e < (hi - lo) * T; e += blk.nt) {
      const ll v = lo + e / T, t = e % T;
      bool ok = false;
      for (ll j = 0; j < a.J && !ok; ++j) {
        if (!a.openable[j * a.I + s.gi] || !a.t_allow[j * a.V + v]) continue;
        if (!(a.f_static[(j * a.I + s.gi) * T + t] && a.t_tmask[j * T + t] &&
              a.y_allow[t * a.V + v])) {
          continue;
        }
        if (!zone) {
          ok = true;
          continue;
        }
        // an available offering in the zone, of a capacity type both allow
        const uint8_t* off = a.y_offer + (t * NZ + (v - a.zlo)) * NC;
        for (ll c = 0; c < NC && !ok; ++c) {
          ok = off[c] && a.t_allow[j * a.V + a.clo + c] && s.allow_i[a.clo + c];
        }
      }
      if (ok) s.dom_open()[v] = 1;  // every writer writes 1
    }
  }
  blk.sync();
}

// hany[g]: some slot of [0, range) counts a pod of hostname affinity group
// g, for the applying groups whose viability reads it.
template <class Blk>
PS_FN void topo_hany(Blk& blk, Scan& s, ll range) {
  const Args& a = *s.a;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    if (!applies(s, g) || !m[G_HOST] || m[G_TYPE] != TOPO_AFFINITY || !s.sel_i()[g]) continue;
    bool h = false;
    for (ll n = blk.tid; n < range; n += blk.nt) h = h || s.thost()[g * a.N + n] > 0.5f;
    h = blk.any(h);
    if (blk.tid == 0) s.hany()[g] = h;
  }
  blk.sync();
}

// topo_screen for slot n: the item's viability there under every group
// that applies (hany from topo_hany over the screened range).
PS_FN bool topo_slot_ok(const Scan& s, ll n) {
  const Args& a = *s.a;
  const uint8_t* sallow = s.allow + n * a.V;
  for (ll g = 0; g < a.G; ++g) {
    if (!applies(s, g)) continue;
    const int32_t* m = gmeta(a, g);
    const bool sel = s.sel_i()[g] != 0;
    const int ty = m[G_TYPE];
    bool ok = false;
    if (m[G_HOST]) {
      const float hc = s.thost()[g * a.N + n];
      if (ty == TOPO_SPREAD) {
        ok = (hc + (sel ? 1.0f : 0.0f)) - 0.0f <= (float)m[G_SKEW];
      } else if (ty == TOPO_AFFINITY) {
        ok = sel && !s.hany()[g] ? true : hc > 0.5f;
      } else {
        ok = hc < 0.5f;
      }
    } else {
      const float* cnt = s.tcounts() + g * a.V;
      const uint8_t* doms = s.tdoms() + g * a.V;
      bool has_pos = false;
      if (ty == TOPO_AFFINITY && sel) {
        for (ll v = m[G_LO]; v < m[G_HI] && !has_pos; ++v) {
          has_pos = s.allow_i[v] && doms[v] && cnt[v] > 0.5f;
        }
      }
      for (ll v = m[G_LO]; v < m[G_HI] && !ok; ++v) {
        bool opt = s.allow_i[v] && doms[v];
        if (ty == TOPO_AFFINITY) {
          // a selected pod seeds a domain where none has a pod yet
          if (!(sel && !has_pos)) opt = opt && cnt[v] > 0.5f;
        } else if (ty == TOPO_ANTI) {
          opt = opt && cnt[v] < 0.5f;
        }
        ok = opt && sallow[v];
      }
    }
    if (!ok) return false;
  }
  return true;
}

// topo_narrow_single for one slot row (its allow [V], its slot index for
// the hostname groups): s.narrow() and s.applied(), the viability, and into
// kcap the replicas the slot may take. force (the water-fill's domains)
// narrows the value-key spread groups, null: every registered domain.
template <class Blk>
PS_FN bool topo_narrow_single(Blk& blk, Scan& s, const uint8_t* sallow, ll slot_n,
                              const uint8_t* force, ll& kcap) {
  const Args& a = *s.a;
  for (ll v = blk.tid; v < a.V; v += blk.nt) s.narrow()[v] = 1;
  for (ll k = blk.tid; k < a.K; k += blk.nt) s.applied()[k] = 0;
  topo_hany(blk, s, a.N);  // (its barrier orders the writes above)
  bool viable = true;
  kcap = BIGK;
  for (ll g = 0; g < a.G; ++g) {
    if (!applies(s, g)) continue;
    const int32_t* m = gmeta(a, g);
    const bool sel = s.sel_i()[g] != 0, inv = m[G_INV] != 0;
    const int ty = m[G_TYPE];
    if (m[G_HOST]) {
      const float hc = s.thost()[g * a.N + slot_n];
      if (ty == TOPO_SPREAD) {
        viable = viable && hc + (sel ? 1.0f : 0.0f) <= (float)m[G_SKEW];
        if (sel) {
          float h = (float)m[G_SKEW] - hc;
          h = h < 0.0f ? 0.0f : h;
          kcap = mn<ll>(kcap, (ll)(int32_t)h);
        }
      } else if (ty == TOPO_AFFINITY) {
        viable = viable && (sel && !s.hany()[g] ? true : hc > 0.5f);
      } else {
        viable = viable && hc < 0.5f;
        // only the direct group caps replicas at one a slot
        if (!inv) kcap = mn<ll>(kcap, 1);
      }
      continue;
    }
    const ll lo = m[G_LO], hi = m[G_HI];
    const float* cnt = s.tcounts() + g * a.V;
    const uint8_t* doms = s.tdoms() + g * a.V;
    // the affinity seeds: the first domain of the item's that the slot
    // allows, and the first of the item's
    bool has_pos = false;
    ll seed1 = -1, seed2 = -1;
    if (ty == TOPO_AFFINITY) {
      for (ll v = lo; v < hi; ++v) {
        const bool pd = s.allow_i[v] && doms[v];
        has_pos = has_pos || (pd && cnt[v] > 0.5f);
        if (pd && seed2 < 0) seed2 = v;
        if (pd && sallow[v] && seed1 < 0) seed1 = v;
      }
    } else if (ty == TOPO_ANTI) {
      kcap = mn<ll>(kcap, 1);
    }
    bool reach = false;
    for (ll v = lo; v < hi; ++v) {
      bool gn;
      if (ty == TOPO_SPREAD) {
        gn = (force ? force[v] != 0 : doms[v] != 0) && doms[v];
      } else if (ty == TOPO_AFFINITY) {
        const bool pos = s.allow_i[v] && doms[v] && cnt[v] > 0.5f;
        gn = sel && !has_pos ? (v == seed1 || v == seed2) : pos;
      } else {
        gn = s.allow_i[v] && doms[v] && cnt[v] < 0.5f;
      }
      reach = reach || (gn && sallow[v]);
      // value v's narrowing is written by the thread that set it to 1
      if (!gn && v % blk.nt == blk.tid) s.narrow()[v] = 0;
    }
    viable = viable && reach;
    if (blk.tid == 0) s.applied()[m[G_KEY]] = 1;
  }
  blk.sync();
  return viable;
}

// topo_bulk_narrow: the bulk fill's one narrowing row (owned direct
// value-key spread and affinity groups) into s.narrow() and s.applied().
template <class Blk>
PS_FN void topo_bulk_narrow(Blk& blk, Scan& s) {
  const Args& a = *s.a;
  for (ll v = blk.tid; v < a.V; v += blk.nt) s.narrow()[v] = 1;
  for (ll k = blk.tid; k < a.K; k += blk.nt) s.applied()[k] = 0;
  blk.sync();
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    const int ty = m[G_TYPE];
    if (m[G_INV] || !s.own_i()[g] || m[G_HOST] || ty == TOPO_ANTI) continue;
    const float* cnt = s.tcounts() + g * a.V;
    const uint8_t* doms = s.tdoms() + g * a.V;
    for (ll v = m[G_LO] + blk.tid; v < m[G_HI]; v += blk.nt) {
      const bool gn = ty == TOPO_SPREAD ? doms[v] != 0
                                        : s.allow_i[v] && doms[v] && cnt[v] > 0.5f;
      if (!gn) s.narrow()[v] = 0;
    }
    if (blk.tid == 0) s.applied()[m[G_KEY]] = 1;
  }
  blk.sync();
}

// The bulk fill's per-slot parts: the replica headroom of owned hostname
// groups (spread skew, 1 under anti-affinity), and whether every owned
// narrowed value-key domain stays reachable from the slot.
PS_FN ll topo_bulk_kcap(const Scan& s, ll n) {
  const Args& a = *s.a;
  ll k = BIGK;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    if (m[G_INV] || !s.own_i()[g] || !m[G_HOST]) continue;
    if (m[G_TYPE] == TOPO_SPREAD && s.sel_i()[g]) {
      float h = (float)m[G_SKEW] - s.thost()[g * a.N + n];
      h = h < 0.0f ? 0.0f : h;
      k = mn<ll>(k, (ll)(int32_t)h);
    } else if (m[G_TYPE] == TOPO_ANTI) {
      k = mn<ll>(k, 1);
    }
  }
  return k;
}

PS_FN bool topo_bulk_reach(const Scan& s, ll n) {
  const Args& a = *s.a;
  const uint8_t* sallow = s.allow + n * a.V;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    if (m[G_HOST] || m[G_INV] || !s.own_i()[g] || m[G_TYPE] == TOPO_ANTI) continue;
    bool reach = false;
    for (ll v = m[G_LO]; v < m[G_HI] && !reach; ++v) reach = sallow[v] && s.narrow()[v];
    if (!reach) return false;
  }
  return true;
}

// topo_bulk_need_seed: an owned value-key affinity group with no positive
// domain yet sends the item to the single-slot path.
PS_FN bool topo_bulk_need_seed(const Scan& s) {
  const Args& a = *s.a;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    if (m[G_INV] || m[G_HOST] || m[G_TYPE] != TOPO_AFFINITY || !s.own_i()[g]) continue;
    bool has_pos = false;
    for (ll v = m[G_LO]; v < m[G_HI] && !has_pos; ++v) {
      has_pos = s.allow_i[v] && s.tdoms()[g * a.V + v] && s.tcounts()[g * a.V + v] > 0.5f;
    }
    if (!has_pos) return true;
  }
  return false;
}

// The water-fill for the owned value-key spread groups (ops/pack.py
// spread_plan): per group the argmin-count live domain and a commit cap up
// to the fill level, bounded by the frozen domains' minimum plus maxSkew
// (or, degraded, by the minimum over all the item's domains). Writes
// s.force() and s.dmark(), the gate's columns; cap takes the least group cap.
// Returns whether a group is blocked (the item ends).
template <class Blk>
PS_FN bool spread_plan(Blk& blk, Scan& s, ll remaining, ll& cap) {
  const Args& a = *s.a;
  const ll N = a.N, V = a.V;
  for (ll v = blk.tid; v < V; v += blk.nt) {
    s.force()[v] = 1;
    s.dmark()[v] = 0;
  }
  bool limits_finite = false;
  for (ll e = 0; e < a.J * a.R && !limits_finite; ++e) limits_finite = s.remaining[e] < 1e29f;
  const float inf = INFINITY;
  bool blocked = false;
  cap = BIGK;
  s.n_gate = 0;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    if (!s.own_i()[g] || m[G_TYPE] != TOPO_SPREAD || m[G_HOST]) continue;
    const ll lo = m[G_LO], hi = m[G_HI];
    if (hi == lo) {
      // a key nothing mentions: no domain at all, so blocked
      cap = 0;
      blocked = true;
      continue;
    }
    // the domains some candidate slot allows
    for (ll v = lo; v < hi; ++v) {
      bool dc = false;
      for (ll n = blk.tid; n < N && !dc; n += blk.nt) dc = s.score[n] < BIG && s.allow[n * V + v];
      dc = blk.any(dc);
      if (blk.tid == 0) s.dom_cand()[v] = dc;
    }
    blk.sync();
    const float* cnt = s.tcounts() + g * V;
    float sum_live = 0.0f, minc_frozen = inf, minc_all = inf, c_star = inf;
    ll n_live = 0, d_star = 0;
    for (ll v = lo; v < hi; ++v) {
      const bool pod_dom = s.allow_i[v] && s.tdoms()[g * V + v];
      const bool live = pod_dom && !s.dead()[v] && (s.dom_cand()[v] || s.dom_open()[v]);
      if (pod_dom && !live) minc_frozen = mn(minc_frozen, cnt[v]);
      if (pod_dom) minc_all = mn(minc_all, cnt[v]);
      if (live) {
        n_live += 1;
        sum_live = sum_live + cnt[v];
        if (cnt[v] < c_star) {
          c_star = cnt[v];
          d_star = v - lo;
        }
      }
    }
    const bool degraded = limits_finite || (N - s.nopen) < n_live ||
                          (a.L - s.ptr) < n_live + 1 || s.not_provable;
    const float level = (sum_live + (float)remaining) / (float)mx<ll>(n_live, 1);
    const bool has_live = n_live > 0;
    const float skew = (float)m[G_SKEW];
    ll cap_g = 0;
    bool skew_blocked = false;
    if (has_live) {
      const float level_cap = mx(floorf(level - c_star), 1.0f);
      const float skew_cap = degraded ? (minc_all + skew) - c_star : (minc_frozen + skew) - c_star;
      const float cap_f = mn(level_cap, skew_cap);
      skew_blocked = cap_f < 1.0f;
      if (!skew_blocked) cap_g = (ll)clampv(cap_f, 1.0f, (float)BIGK);
    }
    for (ll v = lo + blk.tid; v < hi; v += blk.nt) {
      const uint8_t oh = has_live && v - lo == d_star;
      s.force()[v] = oh;
      s.dmark()[v] = oh;
    }
    if (blk.tid == 0) s.gatev()[s.n_gate] = (int32_t)(lo + d_star);
    s.n_gate += 1;
    cap = mn(cap, cap_g);
    blocked = blocked || !has_live || skew_blocked;
  }
  blk.sync();
  return blocked;
}

// the water-fill's gate: a candidate slot allows every chosen domain
PS_FN bool gate_ok(const Scan& s, ll n) {
  for (ll q = 0; q < s.n_gate; ++q) {
    if (!s.allow[n * s.a->V + s.gatev()[q]]) return false;
  }
  return true;
}

// topo_node_filter_ok of the merged row (s.m_allow, m_out, m_def) into
// s.nf(), for the selected direct groups whose filter can fail: any term
// row Compatible with the merged row (requirements.go:123-133: Intersects
// over whole segments, then the term's custom keys the row must define).
template <class Blk>
PS_FN void topo_node_filter(Blk& blk, Scan& s) {
  const Args& a = *s.a;
  const ll K = a.K;
  if (s.need_nf) {
    for (ll k = blk.tid; k < K; k += blk.nt) {
      bool has_a = false, has_x = false;
      for (ll v = a.key_lo[k]; v < a.key_hi[k]; ++v) {
        if (s.m_allow[v]) has_a = true; else has_x = true;
      }
      s.m_escf()[k] = screen_dev::slot_escape(s.m_def[k] != 0, s.m_out[k] != 0, has_a, has_x);
    }
    blk.sync();
  }
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    bool ok = true;
    if (s.need_nf && s.sel_i()[g] && !m[G_INV] && !m[G_TRIV]) {
      ok = false;
      for (ll p = a.g_tptr[g]; p < a.g_tptr[g + 1] && !ok; ++p) {
        const ll r = a.g_trows[p];
        bool fail = false;
        for (ll k = blk.tid; k < K && !fail; k += blk.nt) {
          const ll rk = r * K + k;
          fail = !key_intersects(s.m_def[k], s.m_out[k], s.m_escf()[k], s.m_allow, a.term_def[rk],
                                 a.term_out[rk], a.term_esc[rk], a.term_allow + r * a.V,
                                 a.key_lo[k], a.key_hi[k]) ||
                 (!a.well_known[k] && a.term_def[rk] && !a.term_esc[rk] && !s.m_def[k]);
        }
        ok = !blk.any(fail);
      }
    }
    if (blk.tid == 0) s.nf()[g] = ok;
  }
  blk.sync();
}

// topo_record of a commit of the merged row (s.m_allow, s.m_out) to the
// slots [lo, hi), k_full replicas each but k_last on the last, `placed`
// in all (topology.go:120-143): hostname groups count per slot, value-key
// groups count the row's one domain (every domain it could take under
// anti-affinity and for inverse groups, Requirement.Values()'s complement
// quirk included). Needs s.nf() (topo_node_filter).
template <class Blk>
PS_FN void topo_record(Blk& blk, Scan& s, ll lo, ll hi, ll k_full, ll k_last, ll placed) {
  const Args& a = *s.a;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    const bool inv = m[G_INV] != 0;
    if (!(inv ? s.own_i()[g] != 0 : (s.sel_i()[g] && s.nf()[g]))) continue;
    if (m[G_HOST]) {
      for (ll n = lo + blk.tid; n < hi; n += blk.nt) {
        s.thost()[g * a.N + n] = s.thost()[g * a.N + n] + (float)(n == hi - 1 ? k_last : k_full);
      }
      continue;
    }
    const bool out_k = s.m_out[m[G_KEY]] != 0;
    const bool every = inv || m[G_TYPE] == TOPO_ANTI;
    ll n_allow = 0;
    if (!every) {
      for (ll v = m[G_LO]; v < m[G_HI]; ++v) n_allow += s.m_allow[v] != 0;
    }
    for (ll v = m[G_LO] + blk.tid; v < m[G_HI]; v += blk.nt) {
      const bool al = s.m_allow[v] != 0;
      const bool delta = every ? (out_k ? !al : al) : (al && !out_k && n_allow == 1);
      if (delta) {
        s.tcounts()[g * a.V + v] = s.tcounts()[g * a.V + v] + (float)placed;
        if (placed > 0) s.tdoms()[g * a.V + v] = 1;
      }
    }
  }
  blk.sync();
}

// topo_record_bulk after a bulk commit over the rows [0, BRo): each
// touched row (its planes now the merged row) counts its take; value-key
// groups count a row's one domain (these items carry no value-key
// anti-affinity and no node-filter terms).
template <class Blk>
PS_FN void topo_record_bulk(Blk& blk, Scan& s, ll BRo) {
  const Args& a = *s.a;
  const ll V = a.V, K = a.K;
  for (ll g = 0; g < a.G; ++g) {
    const int32_t* m = gmeta(a, g);
    const bool inv = m[G_INV] != 0;
    if (m[G_HOST]) {
      if (inv ? s.own_i()[g] : s.sel_i()[g]) {
        for (ll n = blk.tid; n < BRo; n += blk.nt) {
          s.thost()[g * a.N + n] = s.thost()[g * a.N + n] + (float)s.take[n];
        }
      }
      continue;
    }
    if (inv || !s.sel_i()[g]) continue;
    const ll lo = m[G_LO], hi = m[G_HI];
    for (ll n = blk.tid; n < BRo; n += blk.nt) {
      ll one = -1;
      if (s.take[n] > 0 && !s.out[n * K + m[G_KEY]]) {
        ll cnt = 0;
        for (ll v = lo; v < hi; ++v) {
          if (s.allow[n * V + v]) {
            cnt += 1;
            one = v;
          }
        }
        if (cnt != 1) one = -1;
      }
      s.rtmp()[n] = (int32_t)one;
    }
    blk.sync();
    for (ll v = lo; v < hi; ++v) {
      ll part = 0;
      for (ll n = blk.tid; n < BRo; n += blk.nt) {
        if (s.rtmp()[n] == v) part += s.take[n];
      }
      const ll sum = blk.sum_ll(part);
      if (blk.tid == 0 && sum > 0) {
        s.tcounts()[g * V + v] = s.tcounts()[g * V + v] + (float)sum;
        s.tdoms()[g * V + v] = 1;
      }
    }
    blk.sync();
  }
}

// do_candidate: verify and commit to the best-ranked slot (among those the
// water-fill's gate admits), narrowed to the topology's domain choice and
// capped at `cap` replicas.
template <class Blk>
PS_FN void do_candidate(Blk& blk, Scan& s, ll& remaining, ll cap) {
  const Args& a = *s.a;
  const ll N = a.N, R = a.R, T = a.T, K = a.K, V = a.V;
  const bool topo = Blk::topo && s.any_topo;
  float best = BIG;
  ll bi = -1;
  for (ll n = blk.tid; n < N; n += blk.nt) {
    if (s.score[n] < best && (!Blk::topo || s.n_gate == 0 || gate_ok(s, n))) {
      best = s.score[n];
      bi = n;
    }
  }
  // an all-BIG score takes slot 0 (torch.argmin's first index)
  ll n = blk.argmin_f(best, (int)bi);
  if (n < 0) n = 0;
  const bool is_ex = s.is_ex[n] != 0;
  bool t_viable = true;
  ll k_topo = BIGK;
  if (topo) {
    t_viable = topo_narrow_single(blk, s, s.allow + n * V, n, s.use_force ? s.force() : nullptr,
                                  k_topo);
  }
  merge_row(blk, s, s.allow + n * V, s.out + n * K, s.def + n * K, topo);
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
  kmax = mn<ll>(mn<ll>(mn<ll>(kmax, k_topo), s.pcap), BIGK);
  const ll k = mn(mn(remaining, kmax), cap);
  const bool commit = t_viable && kmax >= 1 && k >= 1 && s.ptr < a.L;
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
    if (s.writes_vols && n < a.EV && blk.tid == 0) mount_claims(s, n);
    if (!is_ex) {
      for (ll t = blk.tid; t < T; t += blk.nt) {
        s.tmask[n * T + t] = s.ctm[t] && s.kcap[t] >= k;
      }
      segment_max_alloc(blk, s, nullptr, k, s.rvec);
      for (ll r = blk.tid; r < R; r += blk.nt) s.cap[n * R + r] = s.rvec[r];
    }
    if (blk.tid == 0) s.pods[n] += (int32_t)k;
    if (topo) {
      topo_node_filter(blk, s);
      topo_record(blk, s, n, n + 1, k, k, k);
    }
    log_write(s, blk.tid, s.gi, n, 1, k, k);
    remaining -= k;
    blk.sync();
    if (s.plane_mut) {
      screen_slot_row(blk, s, s.allow + n * V, s.out + n * K, s.def + n * K, a.on_row,
                      s.screen + n * a.C);
    }
  }
  // retire on failure or when filled to capacity; a commit cut only by the
  // water-fill cap leaves the slot for a later round
  if (!commit || k >= kmax) {
    if (blk.tid == 0) s.score[n] = BIG;
  }
  blk.sync();
}

// A failed open (open_commit): a single owned value-key spread retires the
// water-fill's domain (`plan`: the iteration's own plan, not the bulk's
// fused open) and retries the next; anything else ends the item. Returns
// whether the item is exhausted.
template <class Blk>
PS_FN bool open_failed(Blk& blk, Scan& s, bool plan) {
  if (plan && s.n_owned_vk == 1) {
    for (ll v = blk.tid; v < s.a->V; v += blk.nt) s.dead()[v] |= s.dmark()[v];
  }
  blk.sync();
  return s.n_owned_vk != 1;
}

// open_commit: bulk-open fresh slots from the first template that can host
// the item, narrowed to the topology's domain choice (the water-fill's
// when `plan`), at most `cap` replicas in all. Returns whether the item is
// exhausted (open_failed) when nothing can open.
template <class Blk>
PS_FN bool open_commit(Blk& blk, Scan& s, ll& remaining, ll cap, bool plan) {
  const Args& a = *s.a;
  const ll N = a.N, R = a.R, T = a.T, K = a.K, V = a.V, J = a.J, C = a.C;
  // the first template (weight order) with a type that survives, fits one
  // replica over its daemons and stays within the provisioner's limits,
  // where the topology admits the fresh slot
  const bool topo = Blk::topo && s.any_topo;
  const ll slot_n = mn<ll>(s.nopen, N - 1);
  ll jc = -1, k_topo = BIGK;
  for (ll j = 0; j < J && jc < 0; ++j) {
    if (!a.openable[j * a.I + s.gi]) continue;
    if (topo && !topo_narrow_single(blk, s, a.t_allow + j * V, slot_n,
                                          plan ? s.force() : nullptr, k_topo)) {
      continue;
    }
    merge_row(blk, s, a.t_allow + j * V, a.t_out + j * K, a.t_def + j * K, topo);
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
  if (jc < 0) return open_failed(blk, s, plan);
  // (s.narrow() is still the chosen template's)
  merge_row(blk, s, a.t_allow + jc * V, a.t_out + jc * K, a.t_def + jc * K, topo);
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
  const ll meff = mn<ll>(mn<ll>(blk.max_i(m_eff), k_topo), mn<ll>(BIGK, s.pcap));
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
  // the water-fill cap bounds this iteration's share
  const ll target = mn(remaining, cap);
  const ll per = mx<ll>(meff, 1);
  const ll s_need = (target + per - 1) / per;
  ll ns = mn(mn(s_need, N - s.nopen), s_limit);
  // a hostname-affinity owner's replicas co-locate on the seeded host:
  // never more than one fresh slot
  if (Blk::topo && s.own_hostaff) ns = mn<ll>(ns, 1);
  if (!(meff >= 1 && ns >= 1 && s.ptr < a.L)) return open_failed(blk, s, plan);
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
  // the opened rows' planes, row by row (a thread per value of a row)
  for (ll n = lo; n < hi; ++n) {
    const ll kr = n == hi - 1 ? k_last : meff;
    for (ll v = blk.tid; v < V; v += blk.nt) s.allow[n * V + v] = s.m_allow[v];
    for (ll k = blk.tid; k < K; k += blk.nt) {
      s.out[n * K + k] = s.m_out[k];
      s.def[n * K + k] = s.m_def[k];
    }
    for (ll t = blk.tid; t < T; t += blk.nt) s.tmask[n * T + t] = s.ctm[t] && s.kcap[t] >= kr;
  }
  blk.sync();
  if (blk.tid == 0) {
    for (ll r = 0; r < R; ++r) s.remaining[jc * R + r] = rem[r] - (float)ns * max_cap[r];
  }
  if (topo) {
    topo_node_filter(blk, s);
    topo_record(blk, s, lo, hi, meff, k_last, placed);
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
  for (ll n = 1; n < ns; ++n) {
    for (ll c = blk.tid; c < C; c += blk.nt) row0[n * C + c] = row0[c];
  }
  blk.sync();
  return false;
}

// The surviving types of machine row n merged with the item (and the bulk
// narrowing when topo) into s.ctm and their replica caps into s.kcap, as
// the machine-region bulk's mach_rows_types_compat and replica_cap_rows
// compute them from the row's planes before the commit; returns the most
// replicas a surviving type takes.
template <class Blk>
PS_FN ll mach_row_types(Blk& blk, Scan& s, ll n, bool topo) {
  const Args& a = *s.a;
  const ll V = a.V, K = a.K, R = a.R, T = a.T;
  merge_row(blk, s, s.allow + n * V, s.out + n * K, s.def + n * K, topo);
  const uint8_t* fs = a.f_static + ((ll)s.tmpl[n] * a.I + s.gi) * T;
  int km = 0;
  for (ll t = blk.tid; t < T; t += blk.nt) {
    const bool ok = s.tmask[n * T + t] && fs[t] && type_compat(s, t, true);
    const int kc = replica_cap(a.y_alloc + t * R, s.used + n * R, s.req_i, R);
    s.ctm[t] = ok;
    s.kcap[t] = kc;
    if (ok) km = mx(km, kc);
  }
  return blk.max_i(km);
}

// do_bulk: every candidate of the bulk region [0, BRo) in one commit under
// per-slot caps: the existing prefix in index order, then (the machine
// region, with hostname anti-affinity groups) the machine rows in score
// order, as the eager scan's stable argsort takes them. Returns whether
// the item is exhausted (the fused open found nothing to open).
template <class Blk>
PS_FN bool do_bulk(Blk& blk, Scan& s, ll& remaining) {
  const Args& a = *s.a;
  const ll R = a.R, V = a.V, K = a.K, N = a.N, T = a.T;
  const ll BRo = mn<ll>(a.BR, s.nopen);
  const bool mach = Blk::topo && a.MACH;
  const ll KEW = mach ? mn<ll>(a.E, BRo) : BRo;
  const bool topo = Blk::topo && s.any_topo;
  const bool mach_ok = Blk::topo && s.mach_ok;
  const bool mach_rows = mach && mach_ok && BRo > KEW;
  const ll pk = mn<ll>(BIGK, s.pcap);
  if (topo) {
    topo_hany(blk, s, BRo);
    topo_bulk_narrow(blk, s);
  }
  // the candidates (viable under the groups, every owned narrowed domain
  // reachable) and their caps: an existing slot's own capacity
  for (ll n = blk.tid; n < BRo; n += blk.nt) {
    bool ok = s.score[n] < BIG && (mach_ok || s.is_ex[n]);
    if (ok && topo) ok = topo_slot_ok(s, n) && topo_bulk_reach(s, n);
    ll ks = 0;
    if (ok && n < KEW) {
      ks = replica_cap(s.cap + n * R, s.used + n * R, s.req_i, R);
      if (topo) ks = mn(ks, topo_bulk_kcap(s, n));
    }
    s.rtmp()[n] = ok;
    s.keff[n] = ok ? (int32_t)mn(ks, pk) : 0;
  }
  blk.sync();
  // a machine row's: its exact surviving types (the bulk analog of the
  // candidate verify), one row at a time
  if (mach_rows) {
    for (ll n = KEW; n < BRo; ++n) {
      if (!s.rtmp()[n]) continue;
      ll km = mach_row_types(blk, s, n, topo);
      if (topo) km = mn(km, topo_bulk_kcap(s, n));
      if (blk.tid == 0) s.keff[n] = (int32_t)mn(km, pk);
    }
    blk.sync();
  }
  // take = min(max(budget - (csum - k_eff), 0), k_eff), the prefix sum in
  // int32 arithmetic as torch.cumsum(dtype=int32) computes it
  const uint32_t budget = (uint32_t)(int32_t)remaining;
  uint32_t carry = 0u;
  ll placed_part = 0;
  for (ll base = 0; base < KEW; base += blk.nt) {
    const ll n = base + blk.tid;
    const uint32_t v = n < KEW ? (uint32_t)s.keff[n] : 0u;
    uint32_t total = 0u;
    const uint32_t excl = blk.scan_u(v, &total);
    if (n < KEW) {
      const uint32_t before = carry + excl;  // csum - k_eff
      const int32_t left = (int32_t)(budget - before);
      const int32_t t = mn<int32_t>(mx<int32_t>(left, 0), (int32_t)v);
      s.take[n] = t;
      placed_part += t;
    }
    carry += total;
  }
  if (mach && BRo > KEW) {
    // the machine rows follow every existing row (a machine's score is
    // at least N), least score first, the first index on a tie. Without an
    // int32 overflow in the prefix, nothing is taken once it reaches the
    // budget; with one, every row with a cap is visited.
    ll tot = 0;
    for (ll n = blk.tid; n < BRo; n += blk.nt) {
      tot += s.keff[n];
      if (n >= KEW) {
        s.take[n] = 0;
        s.fkey()[n] = s.keff[n] > 0 ? s.score[n] : BIG;
      }
    }
    // (without a wrap, carry is the prefix's true value)
    const bool wraps = blk.sum_ll(tot) > 0x7fffffffLL;
    while (wraps || (ll)carry < remaining) {
      float best = BIG;
      ll bi = -1;
      for (ll n = KEW + blk.tid; n < BRo; n += blk.nt) {
        if (s.fkey()[n] < best) {
          best = s.fkey()[n];
          bi = n;
        }
      }
      const ll m = blk.argmin_f(best, (int)bi);
      if (m < 0) break;
      const uint32_t v = (uint32_t)s.keff[m];
      const int32_t left = (int32_t)(budget - carry);
      const int32_t t = mn<int32_t>(mx<int32_t>(left, 0), (int32_t)v);
      if (blk.tid == 0) {
        s.take[m] = t;
        s.fkey()[m] = BIG;
        placed_part += t;
      }
      carry += v;
      blk.sync();
    }
  }
  const ll placed = blk.sum_ll(placed_part);
  const bool commit = placed >= 1 && s.ptr < a.L && s.bulk_n < a.LB;
  blk.sync();
  if (commit) {
    // touched machine rows narrow their types to those that fit the
    // committed replicas (from the rows' planes before the commit)
    if (mach_rows) {
      for (ll n = KEW; n < BRo; ++n) {
        const ll t_n = s.take[n];
        if (t_n <= 0) continue;
        mach_row_types(blk, s, n, topo);
        for (ll t = blk.tid; t < T; t += blk.nt) s.tmask[n * T + t] = s.ctm[t] && s.kcap[t] >= t_n;
        segment_max_alloc(blk, s, nullptr, t_n, s.rvec);
        for (ll r = blk.tid; r < R; r += blk.nt) s.cap[n * R + r] = s.rvec[r];
        blk.sync();
      }
    }
    int32_t* row = s.bulk_take + s.bulk_n * a.BR;
    for (ll n = blk.tid; n < BRo; n += blk.nt) {
      const int32_t t = s.take[n];
      for (ll r = 0; r < R; ++r) {
        s.used[n * R + r] = s.used[n * R + r] + (float)t * s.req_i[r];
      }
      s.pods[n] += t;
      row[n] = t;
      if (t > 0) {
        for (ll q = 0; q < a.Q; ++q) s.ports[n * a.Q + q] |= s.ports_i[q];
        if (s.writes_vols && n < a.EV) mount_claims(s, n);
      }
    }
    // the touched rows' planes, row by row (a thread per value of a row)
    for (ll n = 0; n < BRo; ++n) {
      if (s.take[n] <= 0) continue;
      uint8_t* al = s.allow + n * V;
      for (ll v = blk.tid; v < V; v += blk.nt) {
        al[v] = al[v] & s.allow_i[v] & (topo ? s.narrow()[v] : 1);
      }
      for (ll k = blk.tid; k < K; k += blk.nt) {
        const uint8_t ap = topo ? s.applied()[k] : 0;
        s.out[n * K + k] = s.out[n * K + k] & s.out_i[k] & (uint8_t)!ap;
        s.def[n * K + k] = s.def[n * K + k] | s.def_i[k] | ap;
      }
    }
    blk.sync();
    if (topo) topo_record_bulk(blk, s, BRo);
    log_write(s, blk.tid, s.gi, 0, -1, s.bulk_n, placed);
    s.bulk_n += 1;
    remaining -= placed;
    blk.sync();
    if (s.plane_mut) {
      for (ll n = 0; n < BRo; ++n) {
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
    if (n < BRo && sc < BIG && (mach_ok || s.is_ex[n])) {
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
  if (commit && !exist_left && !mach_cand && remaining > 0) {
    return open_commit(blk, s, remaining, BIGK, false);
  }
  return false;
}

// The screen of every open slot against the item, into the score: existing
// slots rank by index, open machines by pods then index, BIG elsewhere.
template <class Blk>
PS_FN void screen_item(Blk& blk, Scan& s, const uint8_t* tol_i, const uint8_t* conf_i,
                       bool has_conf, ll cls) {
  const Args& a = *s.a;
  const ll N = a.N, R = a.R, Q = a.Q, W = a.W, D = a.D, C = a.C;
  const bool topo = Blk::topo && s.any_topo;
  if (topo) topo_hany(blk, s, s.nopen);
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
        float cnt = s.vcnt()[n * D + d];
        for (ll q = 0; q < s.n_claims(); ++q) {
          if (!vn[s.claims()[q]]) cnt += a.vol_driver[s.claims()[q] * D + d];
        }
        ok = cnt <= a.vol_limits[n * D + d];
      }
    }
    if (ok && topo) ok = topo_slot_ok(s, n);
    if (ok) {
      sc = s.is_ex[n] ? (float)n : ((float)N + (float)s.pods[n] * (float)N) + (float)n;
    }
    s.score[n] = sc;
  }
  blk.sync();
}

// The host's proof of life for the dispatch watchdogs: the scan's steps
// (items and while-iterations) in host memory the card writes, at each
// item and every 64th step, so a long item reads as alive.
template <class Blk>
PS_FN void progress(Blk& blk, Scan& s, bool item) {
  s.steps += 1;
  if (!s.a->progress || blk.tid != 0 || !(item || (s.steps & 63) == 0)) return;
  *(volatile int32_t*)(s.a->progress + s.b) = (int32_t)s.steps;
#if defined(__CUDA_ARCH__)
  __threadfence_system();
#endif
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
  s.bulk_take = a.bulk_take + b * a.LB * a.BR;
  s.score = a.score + b * N;
  const ll BR1 = mx<ll>(a.BR, 1);
  s.keff = a.keff + b * BR1;
  s.take = a.take + b * BR1;
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
  s.n_items = s.n_bulk = s.n_cand = s.n_open = s.steps = 0;

  int32_t* lg = s.hdr + HDR;
  for (ll e = blk.tid; e < 5 * L; e += blk.nt) lg[e] = e < L ? -1 : 0;
  for (ll e = blk.tid; e < a.LB * a.BR; e += blk.nt) s.bulk_take[e] = 0;
  if (a.W > 0) {
    // the existing slots' mounted claims per driver, kept in step with the
    // volume rows by each mount
    for (ll e = blk.tid; e < a.EV * a.D; e += blk.nt) {
      const ll n = e / a.D, d = e % a.D;
      float c = 0.0f;
      for (ll w = 0; w < a.W; ++w) {
        if (s.vols[n * a.W + w]) c += a.vol_driver[w * a.D + d];
      }
      s.vcnt()[e] = c;
    }
  }
  blk.sync();

  for (ll m = 0; m < a.M; ++m) {
    const ll gi = a.item_sel ? (ll)a.item_sel[b * a.M + m] : m;
    if (gi < 0 || !a.i_valid[gi] || a.i_count[gi] <= 0) continue;
    const ll count = a.i_count[gi];
    s.n_items += 1;
    progress(blk, s, true);
    s.gi = gi;
    s.allow_i = a.i_allow + gi * V;
    s.out_i = a.i_out + gi * K;
    s.def_i = a.i_def + gi * K;
    s.req_i = a.i_req + gi * R;
    s.ports_i = a.i_ports + gi * a.Q;
    const uint8_t* conf_i = a.i_conf + gi * a.Q;
    bool has_ports = false, has_conf = false;
    for (ll q = 0; q < a.Q; ++q) {
      has_ports = has_ports || s.ports_i[q];
      has_conf = has_conf || conf_i[q];
    }
    bool mut = false;
    for (ll k = 0; k < K; ++k) mut = mut || (s.def_i[k] && a.key_scr[k]);
    s.plane_mut = mut;
    s.writes_vols = s.n_claims() > 0;
    // a pod with host ports never runs two replicas on one node
    s.pcap = has_ports ? 1 : BIGK;
    // the group flags; an item no group owns or selects skips every
    // group's work, which changes nothing for it
    topo_item(blk, s);

    screen_item(blk, s, a.i_tol + gi * a.TOLW, conf_i, has_conf, a.i_scls[gi]);

    ll remaining = count;
    bool exhausted = false;
    ll tries = 0;
    // backstop only: commits consume count, failed verifies retire slots,
    // failed opens end the item or retire a domain
    while (remaining > 0 && !exhausted && tries < count + N + V + 64) {
      tries += 1;
      progress(blk, s, false);
      ll cap = BIGK;
      s.n_gate = 0;
      s.use_force = Blk::topo && s.n_owned_vk > 0;
      // owners of a value-key spread pack by the water-fill; a blocked
      // group commits nothing and ends the item
      if (s.use_force && spread_plan(blk, s, remaining, cap)) break;
      bool hc = false, ec = false;
      for (ll n = blk.tid; n < N; n += blk.nt) {
        if (s.score[n] < BIG && (!Blk::topo || s.n_gate == 0 || gate_ok(s, n))) {
          hc = true;
          if (s.is_ex[n]) ec = true;
        }
      }
      const bool has_cand = blk.any(hc);
      const bool exist_cand = blk.any(ec);
      const bool seed = Blk::topo && a.BR > 0 && s.any_own && topo_bulk_need_seed(s);
      const bool mach_cand = Blk::topo && s.mach_ok && has_cand;
      if (a.BR > 0 && ((s.item_bulk_ok && exist_cand) || mach_cand) && !seed &&
          s.bulk_n < a.LB) {
        s.n_bulk += 1;
        exhausted = do_bulk(blk, s, remaining);
      } else if (has_cand) {
        s.n_cand += 1;
        do_candidate(blk, s, remaining, cap);
      } else {
        s.n_open += 1;
        exhausted = open_commit(blk, s, remaining, cap, s.use_force);
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
