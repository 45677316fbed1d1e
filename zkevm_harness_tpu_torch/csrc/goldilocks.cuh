// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as inline device routines on
// uint64_t. Shared by every kernel of the package. All inputs and outputs are
// canonical (< p).
//
// The reduction uses 2^64 = 2^32 - 1 (= EPS) and 2^96 = -1 (mod p). Adding
// EPS modulo 2^64 is the same as subtracting p modulo 2^64, so one wrapped
// add folds a carry (or a value in [p, 2^64)) back into range.
#pragma once
#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // carry out of 64 bits, or no carry but s >= p: both fixed by + EPS.
  // For canonical inputs the corrected value cannot overflow again.
  if (s < a || s >= GL_P) s += GL_EPS;
  return s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= GL_EPS;  // borrow: wrapped value is 2^64 too high
  return d;
}

__device__ __forceinline__ uint64_t gl_double(uint64_t a) { return gl_add(a, a); }

// 128 -> 64 bit reduction of hi * 2^64 + lo, canonical result.
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;     // weight 2^96 = -1
  uint64_t hi_lo = hi & GL_EPS;  // weight 2^64 = EPS
  uint64_t t = lo - hi_hi;
  if (lo < hi_hi) t -= GL_EPS;   // borrow fix-up; cannot underflow
  uint64_t u = hi_lo * GL_EPS;   // <= (2^32 - 1)^2, fits 64 bits
  uint64_t r = t + u;
  if (r < t) r += GL_EPS;        // carry fix-up; cannot carry again
  if (r >= GL_P) r -= GL_P;
  return r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t gl_sqr(uint64_t a) { return gl_mul(a, a); }

// x^7, the Poseidon2 S-box.
__device__ __forceinline__ uint64_t gl_pow7(uint64_t a) {
  uint64_t a2 = gl_sqr(a);
  uint64_t a3 = gl_mul(a2, a);
  uint64_t a6 = gl_sqr(a3);
  return gl_mul(a6, a);
}
