// Poseidon2 over the BN254 scalar field Fr (t = 3, rate 2, x^5): the hash
// of the for-wrapper compression's Merkle trees.
//
// Replaces no TPU kernel. The JAX package hashes these trees in host Python,
// one permutation at a time (utils/poseidon2_bn254.py, prover/
// hash_backend.py); over a production for-wrapper circuit (2^17 rows at rate
// 2) that is about ten million permutations, hours of host time, so the port
// permutes on the card. Same function as the host version: the tests and
// chip_smoke.py hold the two equal.
//
// Two entry points, one thread per sponge:
//   bn254_hash_rows:  (w, k) column-major canonical Goldilocks values ->
//                     (k, 4) digests. A thread owns one row: it packs three
//                     values into one Fr (limbs [v0, v1, v2, 0]), zero-pads
//                     the Fr list to an even count and runs the overwrite
//                     sponge; the digest is lane 0. Column-major reads put
//                     neighbouring rows on neighbouring addresses, so each
//                     column's read coalesces across the warp.
//   bn254_hash_pairs: (2m, 4) -> (m, 4), node i = permute([in[2i], in[2i+1],
//                     0])[0], one Merkle level.
//
// Arithmetic: Fr in Montgomery form (R = 2^256) as four 64-bit limbs, CIOS
// multiplication on 64 x 64 -> 128-bit products (a * b and __umul64hi).
// 2p < 2^256, so the CIOS result needs one conditional subtraction and no
// fifth limb at the end. Round constants and the internal diagonal sit in
// __constant__ memory in Montgomery form, converted on the host from the
// port's params/poseidon2_bn254.json (bn254_set_constants). Digests leave in
// canonical form.
//
// Bound on an H100: per permutation 80 S-boxes (3 multiplies each) and 168
// diagonal multiplies, about 400 Montgomery multiplies of some 100 integer
// instructions each, against 24-96 bytes read and 32 written per sponge: the
// integer ALUs bound it, not memory. A simple kernel first: one thread per
// sponge, no shared memory, no wgmma (which has no 256-bit integer form).
//
// Plain C interface: the launchers enqueue on the given stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 3;
constexpr int R_F = 8;
constexpr int R_P = 56;
constexpr int kThreads = 128;

// Fr, little-endian 64-bit limbs, and -p^-1 mod 2^64.
constexpr uint64_t P0 = 0x43e1f593f0000001ULL;
constexpr uint64_t P1 = 0x2833e84879b97091ULL;
constexpr uint64_t P2 = 0xb85045b68181585dULL;
constexpr uint64_t P3 = 0x30644e72e131a029ULL;
constexpr uint64_t INV = 0xc2e1f593efffffffULL;

struct Fr {
  uint64_t v[4];
};

__constant__ uint64_t c_r2[4];             // 2^512 mod p
__constant__ uint64_t c_ext[R_F * T * 4];  // 4 initial, then 4 final rounds
__constant__ uint64_t c_int[R_P * 4];
__constant__ uint64_t c_diag[T * 4];

// a * b + c + carry -> low word; carry <- high word. Cannot overflow:
// (2^64 - 1)^2 + 2 (2^64 - 1) = 2^128 - 1.
__device__ __forceinline__ uint64_t mac(uint64_t a, uint64_t b, uint64_t c, uint64_t& carry) {
  uint64_t lo = a * b;
  uint64_t hi = __umul64hi(a, b);
  lo += c;
  hi += (lo < c);
  lo += carry;
  hi += (lo < carry);
  carry = hi;
  return lo;
}

__device__ __forceinline__ uint64_t adc(uint64_t a, uint64_t b, uint64_t& carry) {
  uint64_t s = a + b;
  uint64_t c1 = s < a;
  uint64_t s2 = s + carry;
  uint64_t c2 = s2 < s;
  carry = c1 + c2;
  return s2;
}

__device__ __forceinline__ uint64_t sbb(uint64_t a, uint64_t b, uint64_t& borrow) {
  uint64_t d = a - b;
  uint64_t b1 = a < b;
  uint64_t d2 = d - borrow;
  uint64_t b2 = d < borrow;
  borrow = b1 + b2;
  return d2;
}

// x - p where x >= p; x < 2p on entry.
__device__ __forceinline__ void reduce_once(Fr& x) {
  uint64_t borrow = 0;
  uint64_t d0 = sbb(x.v[0], P0, borrow);
  uint64_t d1 = sbb(x.v[1], P1, borrow);
  uint64_t d2 = sbb(x.v[2], P2, borrow);
  uint64_t d3 = sbb(x.v[3], P3, borrow);
  if (!borrow) {
    x.v[0] = d0;
    x.v[1] = d1;
    x.v[2] = d2;
    x.v[3] = d3;
  }
}

// a + b mod p; a, b < p < 2^254, so the sum fits four limbs.
__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  Fr r;
  uint64_t carry = 0;
  r.v[0] = adc(a.v[0], b.v[0], carry);
  r.v[1] = adc(a.v[1], b.v[1], carry);
  r.v[2] = adc(a.v[2], b.v[2], carry);
  r.v[3] = adc(a.v[3], b.v[3], carry);
  reduce_once(r);
  return r;
}

// Montgomery product a * b / 2^256 mod p (CIOS); a, b < p.
__device__ __forceinline__ Fr mont_mul(const Fr& a, const Fr& b) {
  uint64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t bi = b.v[i];
    uint64_t c = 0;
    t0 = mac(a.v[0], bi, t0, c);
    t1 = mac(a.v[1], bi, t1, c);
    t2 = mac(a.v[2], bi, t2, c);
    t3 = mac(a.v[3], bi, t3, c);
    uint64_t c_hi = 0;
    t4 = adc(t4, c, c_hi);
    const uint64_t m = t0 * INV;
    c = 0;
    (void)mac(m, P0, t0, c);  // low word is 0 by the choice of m
    t0 = mac(m, P1, t1, c);
    t1 = mac(m, P2, t2, c);
    t2 = mac(m, P3, t3, c);
    uint64_t c_top = 0;
    t3 = adc(t4, c, c_top);
    t4 = c_hi + c_top;
  }
  Fr r = {{t0, t1, t2, t3}};  // < 2p < 2^256, so t4 is 0 here
  reduce_once(r);
  return r;
}

__device__ __forceinline__ Fr load_const(const uint64_t* c) {
  Fr r = {{c[0], c[1], c[2], c[3]}};
  return r;
}

__device__ __forceinline__ Fr to_mont(const Fr& x) {
  return mont_mul(x, load_const(c_r2));
}

__device__ __forceinline__ Fr from_mont(const Fr& x) {
  Fr one = {{1, 0, 0, 0}};
  return mont_mul(x, one);
}

__device__ __forceinline__ Fr sbox(const Fr& x) {
  Fr x2 = mont_mul(x, x);
  Fr x4 = mont_mul(x2, x2);
  return mont_mul(x4, x);
}

// circ(2, 1, 1): y_i = x_i + (x_0 + x_1 + x_2).
__device__ __forceinline__ void external_linear(Fr* s) {
  Fr tot = fr_add(fr_add(s[0], s[1]), s[2]);
  s[0] = fr_add(s[0], tot);
  s[1] = fr_add(s[1], tot);
  s[2] = fr_add(s[2], tot);
}

__device__ __forceinline__ void full_round(Fr* s, int r) {
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = sbox(fr_add(s[i], load_const(c_ext + (r * T + i) * 4)));
  external_linear(s);
}

// The permutation on a Montgomery-form state. The round loops stay loops
// (unroll 1): unrolled, the 400 inlined multiplies would not fit the
// instruction cache, and the SASS keeps one body per loop, which the bound's
// instruction count reads.
__device__ __forceinline__ void permute(Fr* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < R_F / 2; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = 0; r < R_P; ++r) {
    s[0] = sbox(fr_add(s[0], load_const(c_int + r * 4)));
    Fr tot = fr_add(fr_add(s[0], s[1]), s[2]);
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = fr_add(mont_mul(load_const(c_diag + i * 4), s[i]), tot);
  }
#pragma unroll 1
  for (int r = R_F / 2; r < R_F; ++r) full_round(s, r);
}

__device__ __forceinline__ void store_digest(uint64_t* out, long i, const Fr& x) {
  Fr c = from_mont(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[i * 4 + j] = c.v[j];
}

__global__ void hash_rows_kernel(const uint64_t* __restrict__ cols, long w, long k,
                                 uint64_t* __restrict__ out) {
  long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  const long n_fr = (w + 2) / 3;       // packed Fr elements of the row
  const long blocks = (n_fr + 1) / 2;  // rate-2 absorptions, zero-padded
  Fr s[T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = Fr{{0, 0, 0, 0}};
  for (long blk = 0; blk < blocks; ++blk) {
#pragma unroll
    for (int lane = 0; lane < 2; ++lane) {
      const long e = 2 * blk + lane;
      Fr v = {{0, 0, 0, 0}};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const long c = 3 * e + j;
        if (c < w) v.v[j] = cols[c * k + r];
      }
      s[lane] = to_mont(v);  // v < 2^192 < p
    }
    permute(s);
  }
  store_digest(out, r, s[0]);
}

__global__ void hash_pairs_kernel(const uint64_t* __restrict__ in, long m,
                                  uint64_t* __restrict__ out) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Fr s[T];
  s[0] = to_mont(load_const(in + (2 * i) * 4));
  s[1] = to_mont(load_const(in + (2 * i + 1) * 4));
  s[2] = Fr{{0, 0, 0, 0}};
  permute(s);
  store_digest(out, i, s[0]);
}

}  // namespace

extern "C" {

// Host pointers, Montgomery form, 4 limbs per element: r2 (1 element), ext
// (R_F * T: the 4 initial rounds then the 4 final), internal (R_P), diag
// (T). Copies them into the current device's constant memory; call once per
// device before the first launch.
int bn254_set_constants(const void* r2, const void* ext, const void* internal, const void* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_r2, r2, sizeof(uint64_t) * 4);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_ext, ext, sizeof(uint64_t) * R_F * T * 4);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_int, internal, sizeof(uint64_t) * R_P * 4);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_diag, diag, sizeof(uint64_t) * T * 4);
  return (int)e;
}

int bn254_hash_rows_launch(const void* cols, long w, long k, void* out, void* stream) {
  if (k <= 0) return 0;
  long blocks = (k + kThreads - 1) / kThreads;
  hash_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cols, w, k, (uint64_t*)out);
  return (int)cudaGetLastError();
}

int bn254_hash_pairs_launch(const void* in, long m, void* out, void* stream) {
  if (m <= 0) return 0;
  long blocks = (m + kThreads - 1) / kThreads;
  hash_pairs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, m, (uint64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
