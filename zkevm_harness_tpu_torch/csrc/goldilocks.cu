// Elementwise Goldilocks kernels: mul (the port of the Pallas `pallas_mul`
// kernel), add, sub and a fused x^7.
//
// One grid-stride thread per output element, 64-bit loads and stores. Any
// length: there is no tile alignment rule. Each operand is read through a
// (div, mod) pair, element i of the output reading operand[(i / div) % mod],
// which covers the broadcasts the prover uses (scalar, row vector, column
// vector) without materialising them; div = 1 and mod = n is the plain
// same-shape case and skips the index arithmetic.
//
// Bound on an H100: 24 bytes moved per element against a few dozen integer
// operations, so device memory bandwidth is the limit, not arithmetic.
//
// Plain C interface: each launcher enqueues on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 32;  // grid-stride beyond this

struct Operand {
  const uint64_t* p;
  unsigned long long div;
  unsigned long long mod;
  bool direct;  // div == 1 and mod == n
};

__device__ __forceinline__ uint64_t load(const Operand& o, unsigned long long i) {
  if (o.direct) return o.p[i];
  if (o.mod == 1) return o.p[0];
  return o.p[(i / o.div) % o.mod];
}

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

template <int OP>
__global__ void binary_kernel(Operand a, Operand b, uint64_t* __restrict__ out,
                              unsigned long long n) {
  unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint64_t x = load(a, i);
    uint64_t y = load(b, i);
    uint64_t r;
    if (OP == kAdd) r = gl_add(x, y);
    else if (OP == kSub) r = gl_sub(x, y);
    else r = gl_mul(x, y);
    out[i] = r;
  }
}

__global__ void pow7_kernel(const uint64_t* __restrict__ a, uint64_t* __restrict__ out,
                            unsigned long long n) {
  unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = gl_pow7(a[i]);
  }
}

int grid_for(long n) {
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

Operand operand(const void* p, long div, long mod, long n) {
  Operand o;
  o.p = (const uint64_t*)p;
  o.div = (unsigned long long)div;
  o.mod = (unsigned long long)mod;
  o.direct = (div == 1 && mod == n);
  return o;
}

template <int OP>
int launch_binary(const void* a, long a_div, long a_mod, const void* b, long b_div,
                  long b_mod, void* out, long n, void* stream) {
  if (n <= 0) return 0;
  binary_kernel<OP><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      operand(a, a_div, a_mod, n), operand(b, b_div, b_mod, n), (uint64_t*)out,
      (unsigned long long)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gl_mul_launch(const void* a, long a_div, long a_mod, const void* b, long b_div,
                  long b_mod, void* out, long n, void* stream) {
  return launch_binary<kMul>(a, a_div, a_mod, b, b_div, b_mod, out, n, stream);
}

int gl_add_launch(const void* a, long a_div, long a_mod, const void* b, long b_div,
                  long b_mod, void* out, long n, void* stream) {
  return launch_binary<kAdd>(a, a_div, a_mod, b, b_div, b_mod, out, n, stream);
}

int gl_sub_launch(const void* a, long a_div, long a_mod, const void* b, long b_div,
                  long b_mod, void* out, long n, void* stream) {
  return launch_binary<kSub>(a, a_div, a_mod, b, b_div, b_mod, out, n, stream);
}

int gl_pow7_launch(const void* a, void* out, long n, void* stream) {
  if (n <= 0) return 0;
  pow7_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (uint64_t*)out, (unsigned long long)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
