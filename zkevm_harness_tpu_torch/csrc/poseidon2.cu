// Width-12 Poseidon2 permutation over Goldilocks: the port of the Pallas
// `pallas_poseidon2_permute` kernel.
//
// One thread per state. The 12 lanes stay in registers for all 30 rounds
// (external layer, 4 full rounds, 22 partial rounds, 4 full rounds), so a
// state is read from device memory once and written once. The 130 round
// constants (8 x 12 external, 22 internal, 12 diagonal) sit in __constant__
// memory, written once per device by p2_set_constants. The M4 block of the
// external layer is in add/double form, never with multiplies.
//
// Input and output are (B, 12) row-major uint64, any B >= 1: the transcript
// permutes a single state and Merkle levels shrink down to the cap.
//
// Bound on an H100: per state 8*12*4 + 22*(4+12) = 736 field multiplies
// (each a 64x64 -> 128 bit product plus reduction) and about 1200 field adds
// against 192 bytes moved, so integer arithmetic bounds it, not memory. A
// thread's 96-byte row is therefore read and written uncoalesced and left so.
//
// Plain C interface: the launcher enqueues on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int T = 12;
constexpr int R_F = 8;
constexpr int R_P = 22;
constexpr int kThreads = 128;

__constant__ uint64_t c_ext[R_F * T];
__constant__ uint64_t c_int[R_P];
__constant__ uint64_t c_diag[T];

// M4 @ [c0..c3], M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]].
__device__ __forceinline__ void m4(uint64_t* c) {
  uint64_t t0 = gl_add(c[0], c[1]);
  uint64_t t1 = gl_add(c[2], c[3]);
  uint64_t t2 = gl_add(gl_double(c[1]), t1);
  uint64_t t3 = gl_add(gl_double(c[3]), t0);
  uint64_t t4 = gl_add(gl_double(gl_double(t1)), t3);
  uint64_t t5 = gl_add(gl_double(gl_double(t0)), t2);
  uint64_t t6 = gl_add(t3, t5);
  uint64_t t7 = gl_add(t2, t4);
  c[0] = t6;
  c[1] = t5;
  c[2] = t7;
  c[3] = t4;
}

// circ(2*M4, M4, M4) over the 12 lanes.
__device__ __forceinline__ void external_linear(uint64_t* x) {
  m4(x);
  m4(x + 4);
  m4(x + 8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint64_t total = gl_add(gl_add(x[j], x[4 + j]), x[8 + j]);
    x[j] = gl_add(x[j], total);
    x[4 + j] = gl_add(x[4 + j], total);
    x[8 + j] = gl_add(x[8 + j], total);
  }
}

__device__ __forceinline__ void full_round(uint64_t* x, int r) {
#pragma unroll
  for (int i = 0; i < T; ++i) x[i] = gl_pow7(gl_add(x[i], c_ext[r * T + i]));
  external_linear(x);
}

__global__ void permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                               long batch) {
  long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t x[T];
#pragma unroll
  for (int i = 0; i < T; ++i) x[i] = in[b * T + i];

  external_linear(x);
  for (int r = 0; r < R_F / 2; ++r) full_round(x, r);
  for (int r = 0; r < R_P; ++r) {
    x[0] = gl_pow7(gl_add(x[0], c_int[r]));
    uint64_t total = x[0];
#pragma unroll
    for (int i = 1; i < T; ++i) total = gl_add(total, x[i]);
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = gl_add(gl_mul(x[i], c_diag[i]), total);
  }
  for (int r = R_F / 2; r < R_F; ++r) full_round(x, r);

#pragma unroll
  for (int i = 0; i < T; ++i) out[b * T + i] = x[i];
}

}  // namespace

extern "C" {

// Host pointers to 96 + 22 + 12 uint64 values; copies them into the current
// device's constant memory. Call once per device before the first launch.
int p2_set_constants(const void* ext, const void* internal, const void* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext, ext, sizeof(uint64_t) * R_F * T);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_int, internal, sizeof(uint64_t) * R_P);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_diag, diag, sizeof(uint64_t) * T);
  return (int)e;
}

int p2_permute_launch(const void* in, void* out, long batch, void* stream) {
  if (batch <= 0) return 0;
  long blocks = (batch + kThreads - 1) / kThreads;
  permute_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
