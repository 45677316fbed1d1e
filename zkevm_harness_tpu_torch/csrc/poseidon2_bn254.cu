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
// Bound on an H100: integer multiplies. A permutation is 80 S-boxes (two
// squarings and one multiply each) and 168 multiplies by the internal
// diagonal, whose entries are full-size Fr constants. At eight 32-bit limbs
// a Montgomery multiply is 264 multiply instructions and a squaring 208
// (bn254_fr.cuh), so 98,752 a permutation, plus a multiply per Fr converted
// into Montgomery form and a reduction per digest out of it; the card
// retires 64 integer multiplies a clock on each SM. Bytes are 1-3% of that.
//
// What the design does about it:
//   - Carries ride the carry flag: the field arithmetic is bn254_fr.cuh's
//     PTX carry chains (mad.lo.cc / madc.hi.cc / addc), two accumulators
//     per multiply as in sppark's mont_t, no compare and select per carry.
//   - Lazy reduction: every Fr between operations lies in [0, 2p), not
//     [0, p). A Montgomery product of two such values is below 2p with no
//     final subtraction; an add subtracts 2p where the sum reaches it
//     (fr_add: inputs summing below 4p). The three-lane sums of the linear
//     layers take two such adds, since 6p does not fit 256 bits. Only a
//     digest is reduced to [0, p), once, as it leaves.
//   - Waves: ptxas gives the kernels 62 (rows) and 60 (pairs) registers
//     with no spill, so 8 blocks of 128 stay on an SM, 135,168 threads on
//     the card at once: a 2^17-node level runs in one wave, 2^18 rows in
//     two. The source forces no bound, since the waves gain little:
//     tools/k3_launch_bounds.py builds this file beside forms bound to 8
//     blocks an SM (64 registers) and to 6 (78-80, spilling in the pairs
//     kernel), and times both within 1% of this one (PERF.md).
//   - The partial round's diagonal multiplies of lanes 1 and 2 depend only
//     on the state before the S-box: independent chains that the scheduler
//     may overlap with the S-box's. They come after it in the source, so
//     their 16 words are not held across it beside the squarings' 512-bit
//     products; 8 warps a scheduler hide the latency of the serial chains.
//   - The round loops stay loops (unroll 1), and a full round's three
//     S-boxes are one S-box in a loop of three trips with the lanes turning
//     round: the code of a permutation fits the instruction cache.
// Round constants and the diagonal sit in __constant__ memory in Montgomery
// form, 32-bit limbs (the same bytes as 64-bit little-endian limbs), set from
// the port's params/poseidon2_bn254.json on the host (bn254_set_constants);
// every thread reads the same constant at the same time, a broadcast.
//
// Plain C interface: the launchers enqueue on the given stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_fr.cuh"

namespace {

using bn254::Fr;
using bn254::fr_add;
using bn254::fr_mul;
using bn254::fr_sqr;

constexpr int T = 3;
constexpr int R_F = 8;
constexpr int R_P = 56;
constexpr int L = bn254::N;  // 32-bit limbs of an Fr
constexpr int kThreads = 128;

__constant__ uint32_t c_r2[L];             // 2^512 mod p
__constant__ uint32_t c_ext[R_F * T * L];  // 4 initial, then 4 final rounds
__constant__ uint32_t c_int[R_P * L];
__constant__ uint32_t c_diag[T * L];

__device__ __forceinline__ Fr load_const(const uint32_t* c) {
  Fr r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = c[j];
  return r;
}

// x < p (a packed row value, below 2^193, or a canonical input) -> x * R mod
// p, below 2p.
__device__ __forceinline__ Fr to_mont(const Fr& x) { return fr_mul(x, load_const(c_r2)); }

// [0, 2p) -> [0, 2p).
__device__ __forceinline__ Fr sbox(const Fr& x) {
  const Fr x2 = fr_sqr(x);
  const Fr x4 = fr_sqr(x2);
  return fr_mul(x4, x);
}

// circ(2, 1, 1): y_i = x_i + (x_0 + x_1 + x_2). [0, 2p) -> [0, 2p): the sum
// of three lanes is taken two at a time, each add below 4p.
__device__ __forceinline__ void external_linear(Fr* s) {
  const Fr tot = fr_add(fr_add(s[0], s[1]), s[2]);
  s[0] = fr_add(s[0], tot);
  s[1] = fr_add(s[1], tot);
  s[2] = fr_add(s[2], tot);
}

// One full round: lane i gets the S-box of s_i + c_i (below 3p, brought
// below 2p), then the external layer. One S-box per trip: the lanes turn
// round, so after three trips they are in order again.
__device__ __forceinline__ void full_round(Fr* s, int r) {
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    const Fr x = sbox(fr_add(s[0], load_const(c_ext + (r * T + i) * L)));
    s[0] = s[1];
    s[1] = s[2];
    s[2] = x;
  }
  external_linear(s);
}

// One partial round: the S-box on lane 0, then y_i = d_i x_i + sum(x).
// d_i x_i < 2p * p / 2^256 + p < 1.4p and the sum < 2p, so each add is below
// 4p and gives [0, 2p). The multiplies of lanes 1 and 2 need only the state
// before the S-box, but come after it in the source, so that their 16 words
// are not held across it.
__device__ __forceinline__ void partial_round(Fr* s, int r) {
  const Fr x = sbox(fr_add(s[0], load_const(c_int + r * L)));
  const Fr y1 = fr_mul(s[1], load_const(c_diag + 1 * L));
  const Fr y2 = fr_mul(s[2], load_const(c_diag + 2 * L));
  const Fr tot = fr_add(fr_add(x, s[1]), s[2]);
  s[0] = fr_add(fr_mul(x, load_const(c_diag)), tot);
  s[1] = fr_add(y1, tot);
  s[2] = fr_add(y2, tot);
}

// The permutation on a state in [0, 2p) Montgomery form; the result is in
// [0, 2p) too.
__device__ __forceinline__ void permute(Fr* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < R_F / 2; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = 0; r < R_P; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = R_F / 2; r < R_F; ++r) full_round(s, r);
}

// [0, 2p) Montgomery form -> the canonical value as 4 little-endian 64-bit
// limbs: out of Montgomery form gives [0, p], one subtraction [0, p).
__device__ __forceinline__ void store_digest(uint64_t* out, long i, const Fr& x) {
  const Fr c = bn254::fr_reduce(bn254::fr_from_mont(x));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[i * 4 + j] = (uint64_t)c.v[2 * j] | ((uint64_t)c.v[2 * j + 1] << 32);
}

__device__ __forceinline__ Fr zero_fr() {
  Fr r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = 0;
  return r;
}

__global__ void __launch_bounds__(kThreads)
    hash_rows_kernel(const uint64_t* __restrict__ cols, long w, long k,
                     uint64_t* __restrict__ out) {
  const long r = (long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= k) return;
  Fr s[T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = zero_fr();
  // one rate-2 absorption of six columns (two packed Fr, zero-padded) a trip
  for (int c0 = 0; c0 < (int)w; c0 += 6) {
#pragma unroll
    for (int lane = 0; lane < 2; ++lane) {
      Fr v = zero_fr();
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = c0 + 3 * lane + j;
        if (c < (int)w) {
          const uint64_t x = cols[(long)c * k + r];
          v.v[2 * j] = (uint32_t)x;
          v.v[2 * j + 1] = (uint32_t)(x >> 32);
        }
      }
      s[lane] = to_mont(v);  // v < 2^193 < p
    }
    permute(s);
  }
  store_digest(out, r, s[0]);
}

__device__ __forceinline__ Fr load_fr(const uint64_t* p) {
  Fr r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.v[2 * j] = (uint32_t)p[j];
    r.v[2 * j + 1] = (uint32_t)(p[j] >> 32);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
    hash_pairs_kernel(const uint64_t* __restrict__ in, long m, uint64_t* __restrict__ out) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  Fr s[T];
  s[0] = to_mont(load_fr(in + (2 * i) * 4));  // canonical inputs, < p
  s[1] = to_mont(load_fr(in + (2 * i + 1) * 4));
  s[2] = zero_fr();
  permute(s);
  store_digest(out, i, s[0]);
}

}  // namespace

extern "C" {

// Host pointers, Montgomery form, 4 little-endian 64-bit limbs per element
// (the same bytes as 8 32-bit limbs): r2 (1 element), ext (R_F * T: the 4
// initial rounds then the 4 final), internal (R_P), diag (T). Copies them
// into the current device's constant memory; call once per device before the
// first launch.
int bn254_set_constants(const void* r2, const void* ext, const void* internal, const void* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_r2, r2, sizeof(uint32_t) * L);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_ext, ext, sizeof(uint32_t) * R_F * T * L);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_int, internal, sizeof(uint32_t) * R_P * L);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_diag, diag, sizeof(uint32_t) * T * L);
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
