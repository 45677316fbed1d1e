// The BN254 scalar field Fr on Hopper: Montgomery form (R = 2^256) in eight
// 32-bit limbs, little-endian, multiplication on PTX carry chains, lazy
// reduction. Device code only; include it from a .cu file.
//
// Carries. Every 32 x 32-bit product is a `mad.lo` / `mad.hi` pair whose
// carry rides the carry flag (`.cc` / `madc`), with no compare or select.
// The carry flag lives only inside one asm block: each block below is one
// whole chain, which starts with an instruction that reads no carry and ends
// with one that writes none. Nothing the compiler places between two blocks
// can touch a carry.
//
// Multiplication (fr_mul). Interleaved Montgomery multiplication (CIOS) with
// two accumulators, as supranational's sppark `mont_t` has it: `e` holds the
// products of the even limbs of a, two words per product at word 2k; `o`
// those of the odd limbs, one word higher. So within a chain the low and
// high halves of consecutive products land on consecutive words and one
// carry flag serves the whole row. After each row the reduction zeroes the
// low word, and the next row moves the window one word down, swapping the
// two accumulators' roles. 264 multiply instructions: a low and a high half
// for each of the 8^2 products of a * b and the 8^2 of m * p, and the 8
// factors m.
//
// Squaring (fr_sqr). The 512-bit square by columns (product scanning): each
// off-diagonal product once, the column doubled, its square added; then a
// Montgomery reduction of the low half on the same two accumulators, plus
// the high half. 28 * 2 + 8 * 2 + 8 * 17 = 208 multiply instructions.
//
// Ranges. p < 2^254, and 5p < 2^256 < 6p. A value between operations is any
// representative below 2p, not only the canonical one; each function below
// states the range it takes and the range it gives, and
// tests/test_torch_bn254_limbs.py replays every function word for word in
// Python ints and checks each range and each carry at the extremes. Only
// where a value leaves a kernel is it reduced to [0, p) (fr_reduce).
#pragma once

#include <stdint.h>

namespace bn254 {

constexpr int N = 8;  // 32-bit limbs

// p, and -p^-1 mod 2^32
constexpr uint32_t P0 = 0xf0000001u, P1 = 0x43e1f593u, P2 = 0x79b97091u,
                   P3 = 0x2833e848u, P4 = 0x8181585du, P5 = 0xb85045b6u,
                   P6 = 0xe131a029u, P7 = 0x30644e72u;
constexpr uint32_t M0 = 0xefffffffu;
// 2p
constexpr uint32_t Q0 = 0xe0000002u, Q1 = 0x87c3eb27u, Q2 = 0xf372e122u,
                   Q3 = 0x5067d090u, Q4 = 0x0302b0bau, Q5 = 0x70a08b6du,
                   Q6 = 0xc2634053u, Q7 = 0x60c89ce5u;

struct Fr {
  uint32_t v[N];
};

// --- rows of the multiplication --------------------------------------------

// acc[2k], acc[2k + 1] = a[2k] * b for k = 0..3: the pairs do not overlap, so
// no carry. Called with a + 1 it gives the odd limbs' row.
__device__ __forceinline__ void mul_row(uint32_t acc[N], const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < N; k += 2) {
    const uint64_t t = (uint64_t)a[k] * b;
    acc[k] = (uint32_t)t;
    acc[k + 1] = (uint32_t)(t >> 32);
  }
}

// One chain: e0 += o[1], then o <- (o >> 64) + a_odd * b. The window moves one
// word down: o's word 1 goes into e's word 0, its word 0 (zeroed by the last
// reduction) leaves. The last add cannot carry: hi(a * b) + 1 < 2^32.
__device__ __forceinline__ void mac_shift_odd(uint32_t& e0, uint32_t o[N], const uint32_t a[N],
                                              uint32_t b) {
  asm volatile(
      "add.cc.u32     %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32    %8, %12, %13, 0;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// One chain: e += a_even * b, its carry into o[7] (the same weight, 2^256).
__device__ __forceinline__ void mac_even(uint32_t e[N], uint32_t& o7, const uint32_t a[N],
                                         uint32_t b) {
  asm volatile(
      "mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o7)
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
}

// One chain: o += m * p_odd. The window's value stays below 2^288 (see
// fr_mul), so o, one word above e, cannot carry out of its top word.
__device__ __forceinline__ void redc_odd(uint32_t o[N], uint32_t m) {
  asm volatile(
      "mad.lo.cc.u32  %0, %8, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
      "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
      "madc.hi.u32    %7, %8, %12, %7;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]),
        "+r"(o[7])
      : "r"(m), "r"(P1), "r"(P3), "r"(P5), "r"(P7));
}

// One chain: e += m * p_even, its carry into o[7].
__device__ __forceinline__ void redc_even(uint32_t e[N], uint32_t& o7, uint32_t m) {
  asm volatile(
      "mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o7)
      : "r"(m), "r"(P0), "r"(P2), "r"(P4), "r"(P6));
}

// Adds m * p with m = e[0] * -p^-1 mod 2^32, which makes e[0] zero.
__device__ __forceinline__ void redc_step(uint32_t e[N], uint32_t o[N]) {
  const uint32_t m = e[0] * M0;
  redc_odd(o, m);
  redc_even(e, o[7], m);
}

// One row of fr_mul: window down one word, + a * b, reduce.
__device__ __forceinline__ void mul_step(uint32_t e[N], uint32_t o[N], const uint32_t a[N],
                                         uint32_t b) {
  mac_shift_odd(e[0], o, a, b);
  mac_even(e, o[7], a, b);
  redc_step(e, o);
}

// One chain, the last move of the window: o += e >> 32 (e[0] is zero).
// Below 2^256 by the range of the caller's result, so no carry leaves.
__device__ __forceinline__ void merge(uint32_t o[N], const uint32_t e[N]) {
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, 0;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]),
        "+r"(o[7])
      : "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]), "r"(e[6]), "r"(e[7]));
}

// a * b / 2^256 mod p. Takes a < 2^256 - p (about 4.29p) and any b < 2^256;
// gives a value below a * b / 2^256 + p: below 2p when a, b < 2p, or when
// a < 4p and b <= p. The window (before each shift) stays below
// (a + p) * 2^32 <= 2^288, which is what keeps o from carrying out.
__device__ __forceinline__ Fr fr_mul(const Fr& a, const Fr& b) {
  uint32_t e[N], o[N];
  mul_row(e, a.v, b.v[0]);
  mul_row(o, a.v + 1, b.v[0]);
  redc_step(e, o);
  mul_step(o, e, a.v, b.v[1]);  // the accumulators swap roles every row
  mul_step(e, o, a.v, b.v[2]);
  mul_step(o, e, a.v, b.v[3]);
  mul_step(e, o, a.v, b.v[4]);
  mul_step(o, e, a.v, b.v[5]);
  mul_step(e, o, a.v, b.v[6]);
  mul_step(o, e, a.v, b.v[7]);
  merge(e, o);
  Fr r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = e[j];
  return r;
}

// --- squaring and reduction --------------------------------------------------

// One chain: (t0, t1, t2) += x * y. t2 counts carries (at most 3 a column).
__device__ __forceinline__ void col_mac(uint32_t& t0, uint32_t& t1, uint32_t& t2, uint32_t x,
                                        uint32_t y) {
  asm volatile(
      "mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32       %2, %2, 0;"
      : "+r"(t0), "+r"(t1), "+r"(t2)
      : "r"(x), "r"(y));
}

// Two chains: (t0, t1, t2) = 2 t + (c0, c1) + x * x, the column's total.
__device__ __forceinline__ void col_finish(uint32_t& t0, uint32_t& t1, uint32_t& t2, uint32_t c0,
                                           uint32_t c1, uint32_t x) {
  asm volatile(
      "add.cc.u32     %0, %0, %0;\n\t"
      "addc.cc.u32    %1, %1, %1;\n\t"
      "addc.u32       %2, %2, %2;\n\t"
      "add.cc.u32     %0, %0, %3;\n\t"
      "addc.cc.u32    %1, %1, %4;\n\t"
      "addc.u32       %2, %2, 0;"
      : "+r"(t0), "+r"(t1), "+r"(t2)
      : "r"(c0), "r"(c1));
  asm volatile(
      "mad.lo.cc.u32  %0, %3, %3, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %3, %1;\n\t"
      "addc.u32       %2, %2, 0;"
      : "+r"(t0), "+r"(t1), "+r"(t2)
      : "r"(x));
}

// The same without a square (odd columns).
__device__ __forceinline__ void col_finish(uint32_t& t0, uint32_t& t1, uint32_t& t2, uint32_t c0,
                                           uint32_t c1) {
  asm volatile(
      "add.cc.u32     %0, %0, %0;\n\t"
      "addc.cc.u32    %1, %1, %1;\n\t"
      "addc.u32       %2, %2, %2;\n\t"
      "add.cc.u32     %0, %0, %3;\n\t"
      "addc.cc.u32    %1, %1, %4;\n\t"
      "addc.u32       %2, %2, 0;"
      : "+r"(t0), "+r"(t1), "+r"(t2)
      : "r"(c0), "r"(c1));
}

// w = a * a, 16 words, column by column. A column's total is below 2^68, so
// the carry into the next column is two words.
__device__ __forceinline__ void sqr_wide(uint32_t w[2 * N], const uint32_t a[N]) {
  uint32_t c0 = 0, c1 = 0;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) {
    uint32_t t0 = 0, t1 = 0, t2 = 0;
    const int lo = k < N ? 0 : k - N + 1;
#pragma unroll
    for (int i = lo; 2 * i < k; ++i) {
      if (i == lo) {  // the column's first product needs no add
        const uint64_t t = (uint64_t)a[i] * a[k - i];
        t0 = (uint32_t)t;
        t1 = (uint32_t)(t >> 32);
      } else {
        col_mac(t0, t1, t2, a[i], a[k - i]);
      }
    }
    if (k % 2 == 0)
      col_finish(t0, t1, t2, c0, c1, a[k / 2]);
    else
      col_finish(t0, t1, t2, c0, c1);
    w[k] = t0;
    c0 = t1;
    c1 = t2;
  }
  w[2 * N - 1] = c0;  // c1 is 0: a * a < 2^512
}

// One chain, the window of a reduction without products: e0 += o[1],
// o <- o >> 64. o[7] becomes 0.
__device__ __forceinline__ void shift_step(uint32_t& e0, uint32_t o[N]) {
  asm volatile(
      "add.cc.u32  %0, %0, %2;\n\t"
      "addc.cc.u32 %1, %3, 0;\n\t"
      "addc.cc.u32 %2, %4, 0;\n\t"
      "addc.cc.u32 %3, %5, 0;\n\t"
      "addc.cc.u32 %4, %6, 0;\n\t"
      "addc.cc.u32 %5, %7, 0;\n\t"
      "addc.cc.u32 %6, %8, 0;\n\t"
      "addc.u32    %7, %9, 0;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6])
      : "r"(o[7]), "r"(0u));
  o[7] = 0;
}

// x / 2^256 mod p for any x < 2^256 (Montgomery reduction of one width):
// gives [0, p], and p exactly when x is a nonzero multiple of p (p, 2p, ...,
// 5p).
__device__ __forceinline__ void redc_low(uint32_t e[N]) {
  uint32_t o[N];
#pragma unroll
  for (int j = 0; j < N; ++j) o[j] = 0;
  redc_step(e, o);
  shift_step(o[0], e);
  redc_step(o, e);
  shift_step(e[0], o);
  redc_step(e, o);
  shift_step(o[0], e);
  redc_step(o, e);
  shift_step(e[0], o);
  redc_step(e, o);
  shift_step(o[0], e);
  redc_step(o, e);
  shift_step(e[0], o);
  redc_step(e, o);
  shift_step(o[0], e);
  redc_step(o, e);
  merge(e, o);
}

// One chain: r += x, where the sum is known to stay below 2^256.
__device__ __forceinline__ void add_to(uint32_t r[N], const uint32_t x[N]) {
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]),
        "r"(x[7]));
}

// a * a / 2^256 mod p. Takes a < 2.3p (a * a < 2^256 (p - 1)); gives a value
// below a * a / 2^256 + p + 1: below 2p when a < 2p. The reduction of the
// low half gives at most p, the high half adds a * a / 2^256.
__device__ __forceinline__ Fr fr_sqr(const Fr& a) {
  uint32_t w[2 * N];
  sqr_wide(w, a.v);
  redc_low(w);
  add_to(w, w + N);
  Fr r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = w[j];
  return r;
}

// --- additions ---------------------------------------------------------------

// One chain: s = a + b for a + b < 2^256.
__device__ __forceinline__ void add_limbs(uint32_t s[N], const uint32_t a[N], const uint32_t b[N]) {
  asm volatile(
      "add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]),
        "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// One chain: d = s - m and borrow = all ones where s < m, else 0.
__device__ __forceinline__ uint32_t sub_limbs(uint32_t d[N], const uint32_t s[N],
                                              const uint32_t m[N]) {
  uint32_t borrow;
  asm volatile(
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(borrow)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]),
        "r"(s[7]), "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]), "r"(m[4]), "r"(m[5]),
        "r"(m[6]), "r"(m[7]), "r"(0u));
  return borrow;
}

// s where s < m, else s - m: one conditional subtraction, no branch.
__device__ __forceinline__ Fr cond_sub(const uint32_t s[N], const uint32_t m[N]) {
  uint32_t d[N];
  const uint32_t keep = sub_limbs(d, s, m);
  Fr r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = (s[j] & keep) | (d[j] & ~keep);
  return r;
}

// a + b, kept below 2p. Takes a + b < 4p; gives a value below 2p.
__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  const uint32_t two_p[N] = {Q0, Q1, Q2, Q3, Q4, Q5, Q6, Q7};
  uint32_t s[N];
  add_limbs(s, a.v, b.v);
  return cond_sub(s, two_p);
}

// The canonical value of x. Takes x < 2p; gives x mod p.
__device__ __forceinline__ Fr fr_reduce(const Fr& x) {
  const uint32_t p[N] = {P0, P1, P2, P3, P4, P5, P6, P7};
  return cond_sub(x.v, p);
}

// x / 2^256 mod p, out of Montgomery form. Takes x < 2^256; gives x / R mod p
// in [0, p], p exactly when x is a nonzero multiple of p.
__device__ __forceinline__ Fr fr_from_mont(const Fr& x) {
  Fr r = x;
  redc_low(r.v);
  return r;
}

}  // namespace bn254
