// The requirement screen's per-row pieces, shared by csrc/screen.cu's
// kernels and the pack scan (csrc/pack_scan_body.h), which re-screens a
// slot row against every class column after each commit that changes it.
//
// Every function is plain per-row arithmetic on packed words and key
// bitmasks (see screen.cu for the layout), so it compiles for the card
// (nvcc) and for the host (g++, the scan's CPU build that the tests load).

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define SCREEN_DEV __host__ __device__ __forceinline__
#else
#define SCREEN_DEV inline
#endif

namespace screen_dev {

constexpr unsigned FULL = 0xffffffffu;

// The slot side's escape flag of one key (requirement.go:186-197): NotIn
// (a complement with an excluded value) or DoesNotExist (no complement and
// nothing allowed), from the key's has-allowed and has-excluded bits.
SCREEN_DEV bool slot_escape(bool def, bool out, bool has_allow, bool has_excl) {
  return def && (out ? has_excl : !has_allow);
}

// Word w of a byte row in the layout's order: bit j is the row's value
// column bit_col[32 w + j] (-1: past the key's segment, 0).
SCREEN_DEV unsigned pack_word(const uint8_t* row, const int32_t* bit_col, int w) {
  unsigned word = 0u;
  for (int j = 0; j < 32; ++j) {
    const int col = bit_col[32 * w + j];
    if (col >= 0 && row[col] != 0) word |= 1u << j;
  }
  return word;
}

// The verdict of one pair for key group q (keys 32q .. 32q + 31).
SCREEN_DEV bool group_ok(unsigned sd, unsigned so, unsigned se, unsigned id, unsigned io,
                         unsigned ie, unsigned idn, unsigned inter, unsigned on) {
  const unsigned ok = ~(sd & id) | (so & io) | (se & ie) | inter | ~on;
  return ok == FULL && (idn & ~sd) == 0u;
}

// The intersection bits of one row pair over words [w0, w1) of a key
// group, every step-th word from w0: bit (key & 31) is set where the
// single row's word meets row r of the word-major [W, ld] planes.
SCREEN_DEV unsigned row_inter(const uint32_t* one, const uint32_t* many, size_t ld, size_t r,
                              const int32_t* word_key, int w0, int w1, int step) {
  unsigned inter = 0u;
  for (int w = w0; w < w1; w += step) {
#if defined(__CUDA_ARCH__)
    const uint32_t m = __ldg(many + (size_t)w * ld + r);  // read-only planes
#else
    const uint32_t m = many[(size_t)w * ld + r];
#endif
    if ((one[w] & m) != 0u) inter |= 1u << (word_key[w] & 31);
  }
  return inter;
}

}  // namespace screen_dev
