"""Hand-written Hopper kernels: build, ctypes binding, wrappers, plain versions.

Counterpart of the JAX package's `ops/pallas_kernels.py`. Its two Pallas
kernels become CUDA C++ kernels for `sm_90a` (sources under `csrc/`):

  `pallas_mul`                -> `gl_mul`             (csrc/goldilocks.cu)
  `pallas_poseidon2_permute`  -> `poseidon2_permute`  (csrc/poseidon2.cu)

plus three small elementwise helpers on the same device routines (`gl_add`,
`gl_sub`, `gl_pow7`), which port no TPU kernel and are listed apart, and one
kernel of the port with no TPU counterpart: Poseidon2 over BN254 Fr
(`bn254_hash_rows`, `bn254_hash_pairs`, csrc/poseidon2_bn254.cu), which the
JAX package runs in host Python for the for-wrapper compression's trees.

Beside each kernel stand its plain PyTorch version (`*_plain`, int64 tensor
arithmetic on 32-bit halves, any device), a launch counter in `LAUNCHES`,
and a source note. A wrapper takes the plain version only for a tensor that
lies on the CPU; for a CUDA tensor it launches the kernel or raises — the
build, the load and the launch have no fallback.

Build: at the first call with a CUDA tensor, one `nvcc` per source (all
started together) compiles `csrc/*.cu` into shared libraries under `build/`
in the package, which are loaded with `ctypes`. A library is rebuilt when its
source or any header under `csrc/` is newer than it. The module itself
imports without `nvcc`.

A field element is one int64 holding the canonical u64 bit pattern (< p); a
BN254 Fr digest is four int64 limbs, little-endian 64-bit words.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils import poseidon2_bn254 as p2b
from .poseidon2_params import R_F, R_P, T, const_tables_u64

P = 0xFFFFFFFF_00000001
_P_S = P - (1 << 64)  # p as a signed 64-bit pattern
_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF  # also EPSILON = 2^64 mod p

_PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("goldilocks", "poseidon2", "poseidon2_bn254")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset (plain integers; a wrapper
# adds one exactly where it launches its kernel)
LAUNCHES: Dict[str, int] = {"gl_mul": 0, "poseidon2_permute": 0,
                            "gl_add": 0, "gl_sub": 0, "gl_pow7": 0,
                            "bn254_hash_rows": 0, "bn254_hash_pairs": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _dump_launches(path: str) -> None:
    with open(path, "w") as f:
        json.dump(LAUNCHES, f)


# A process started with ZKEVM_LAUNCHES_FILE set writes its launch counts
# there as JSON when it exits (a CLI command's counts for the run that
# started it)
if os.environ.get("ZKEVM_LAUNCHES_FILE"):
    atexit.register(_dump_launches, os.environ["ZKEVM_LAUNCHES_FILE"])


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    header under csrc/ (a source may include any of them)."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    deps = [os.path.join(CSRC_DIR, f"{name}.cu")] + [
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")]
    return any(os.path.getmtime(d) > built for d in deps)


# nvcc's output of the last build of each source: ptxas' registers, stack
# and spills of every kernel (-Xptxas -v)
BUILD_LOG: Dict[str, str] = {}


def build_all(force: bool = False, verbose: bool = False) -> float:
    """Compile every stale source, one nvcc each, all started together,
    keeping each compiler report in `BUILD_LOG` (printed when `verbose`).
    Returns the seconds spent. Raises if any compile fails."""
    t0 = time.time()
    todo = [n for n in SOURCES if force or _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = _lib_path(name) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC_DIR,
               "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.time() - t0


def ptxas_report(text: str) -> Dict[str, Dict[str, int]]:
    """Registers, stack frame and spill bytes of each kernel, read from
    nvcc's `-Xptxas -v` output (`BUILD_LOG`); keyed by the kernel's
    mangled name."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


_LIBS: Dict[str, ctypes.CDLL] = {}

_PTR = ctypes.c_void_p
_LONG = ctypes.c_long
_BINARY_ARGS = [_PTR, _LONG, _LONG, _PTR, _LONG, _LONG, _PTR, _LONG, _PTR]


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = ctypes.CDLL(_lib_path(name))
    if name == "goldilocks":
        for fn in (lib.gl_mul_launch, lib.gl_add_launch, lib.gl_sub_launch):
            fn.argtypes = _BINARY_ARGS
            fn.restype = ctypes.c_int
        lib.gl_pow7_launch.argtypes = [_PTR, _PTR, _LONG, _PTR]
        lib.gl_pow7_launch.restype = ctypes.c_int
    elif name == "poseidon2":
        lib.p2_set_constants.argtypes = [_PTR, _PTR, _PTR]
        lib.p2_set_constants.restype = ctypes.c_int
        lib.p2_permute_launch.argtypes = [_PTR, _PTR, _LONG, _PTR]
        lib.p2_permute_launch.restype = ctypes.c_int
    elif name == "poseidon2_bn254":
        lib.bn254_set_constants.argtypes = [_PTR, _PTR, _PTR, _PTR]
        lib.bn254_set_constants.restype = ctypes.c_int
        lib.bn254_hash_rows_launch.argtypes = [_PTR, _LONG, _LONG, _PTR, _PTR]
        lib.bn254_hash_rows_launch.restype = ctypes.c_int
        lib.bn254_hash_pairs_launch.argtypes = [_PTR, _LONG, _PTR, _PTR]
        lib.bn254_hash_pairs_launch.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _require_field(t: torch.Tensor, name: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
        raise TypeError(f"{name}: field tensors are int64, got "
                        f"{getattr(t, 'dtype', type(t))}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 arithmetic, unsigned semantics spelled out)
# ---------------------------------------------------------------------------

def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def _ge_p(x: torch.Tensor) -> torch.Tensor:
    """Unsigned x >= p: p's high word is all ones, so exactly the signed
    values in [p - 2^64, -1]."""
    return (x < 0) & (x >= _P_S)


def _shr32(x: torch.Tensor) -> torch.Tensor:
    """Logical x >> 32."""
    return (x >> 32) & _M32


def gl_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    fix = _ult(s, a) | _ge_p(s)
    return torch.where(fix, s + _M32, s)


def gl_sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(_ult(a, b), d - _M32, d)


def _reduce128_plain(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """hi * 2^64 + lo mod p with 2^64 = 2^32 - 1 and 2^96 = -1."""
    hi_hi = _shr32(hi)
    hi_lo = hi & _M32
    t = lo - hi_hi
    t = torch.where(_ult(lo, hi_hi), t - _M32, t)
    u = (hi_lo << 32) - hi_lo  # hi_lo * (2^32 - 1), below 2^64
    r = t + u
    r = torch.where(_ult(r, t), r + _M32, r)
    return torch.where(_ge_p(r), r + _M32, r)


def gl_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p. Four 32x32 partial products on halves held in int64 (a
    product of two 32-bit values fits the 64-bit pattern), recombined into
    the low and high words of the 128-bit product, then reduced."""
    a, b = torch.broadcast_tensors(a, b)
    a_lo, a_hi = a & _M32, _shr32(a)
    b_lo, b_hi = b & _M32, _shr32(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    cross = _shr32(ll) + (lh & _M32) + (hl & _M32)  # < 3 * 2^32
    lo = (ll & _M32) | (cross << 32)
    hi = hh + _shr32(lh) + _shr32(hl) + _shr32(cross)
    return _reduce128_plain(lo, hi)


def gl_pow7_plain(a: torch.Tensor) -> torch.Tensor:
    a2 = gl_mul_plain(a, a)
    a3 = gl_mul_plain(a2, a)
    a6 = gl_mul_plain(a3, a3)
    return gl_mul_plain(a6, a)


_CONST_CACHE: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = {}


def _const_tensors(device: torch.device):
    key = (device.type, device.index or 0)
    if key not in _CONST_CACHE:
        _CONST_CACHE[key] = tuple(
            torch.from_numpy(t.view(np.int64).copy()).to(device)
            for t in const_tables_u64())
    return _CONST_CACHE[key]


def _m4_plain(c):
    c0, c1, c2, c3 = c
    add = gl_add_plain
    t0 = add(c0, c1)
    t1 = add(c2, c3)
    t2 = add(add(c1, c1), t1)
    t3 = add(add(c3, c3), t0)
    t1x2 = add(t1, t1)
    t0x2 = add(t0, t0)
    t4 = add(add(t1x2, t1x2), t3)
    t5 = add(add(t0x2, t0x2), t2)
    return [add(t3, t5), t5, add(t2, t4), t4]


def _external_linear_plain(x: torch.Tensor) -> torch.Tensor:
    """circ(2*M4, M4, M4) on (..., 12), the three 4-lane chunks batched."""
    c = x.reshape(*x.shape[:-1], 3, 4)
    m = torch.stack(_m4_plain([c[..., j] for j in range(4)]), dim=-1)
    total = gl_add_plain(gl_add_plain(m[..., 0, :], m[..., 1, :]),
                         m[..., 2, :])
    out = gl_add_plain(m, total.unsqueeze(-2))
    return out.reshape(x.shape)


def poseidon2_permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The width-12 Poseidon2 permutation on (..., 12), in plain tensor ops."""
    ext, internal, diag = _const_tensors(state.device)
    half = R_F // 2
    x = _external_linear_plain(state)

    def full_round(x, r):
        return _external_linear_plain(gl_pow7_plain(gl_add_plain(x, ext[r])))

    for r in range(half):
        x = full_round(x, r)
    for r in range(R_P):
        lane0 = gl_pow7_plain(gl_add_plain(x[..., 0], internal[r]))
        x = torch.cat([lane0.unsqueeze(-1), x[..., 1:]], dim=-1)
        total = x[..., 0]
        for i in range(1, T):
            total = gl_add_plain(total, x[..., i])
        x = gl_add_plain(gl_mul_plain(x, diag), total.unsqueeze(-1))
    for r in range(half, R_F):
        x = full_round(x, r)
    return x


def _m4_ints(c0: int, c1: int, c2: int, c3: int):
    t0, t1 = c0 + c1, c2 + c3
    t2, t3 = 2 * c1 + t1, 2 * c3 + t0
    t4, t5 = 4 * t1 + t3, 4 * t0 + t2
    return t3 + t5, t5, t2 + t4, t4


def _external_linear_ints(x):
    m = [v for j in range(0, T, 4) for v in _m4_ints(*x[j:j + 4])]
    tot = [m[i] + m[i + 4] + m[i + 8] for i in range(4)]
    return [(m[i] + tot[i % 4]) % P for i in range(T)]


def poseidon2_permute_one_host(state: torch.Tensor) -> torch.Tensor:
    """One (12,)-element state on the CPU, permuted in exact Python ints.

    The serial sponges (transcript, challenge hash) permute one state at a
    time; there the plain tensor version is some ten thousand tensor ops for
    twelve elements. Same function, pinned against the plain version by
    tests/test_torch_poseidon2.py. Never used for a CUDA tensor."""
    x = poseidon2_permute_ints(
        state.reshape(T).numpy().view(np.uint64).tolist())
    out = np.array(x, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(out).reshape(state.shape)


@functools.lru_cache(maxsize=1)
def _const_lists():
    return tuple(t.tolist() for t in const_tables_u64())


def poseidon2_permute_ints(state: Sequence[int]) -> List[int]:
    """One 12-lane state of canonical Python ints, permuted exactly; the
    body of `poseidon2_permute_one_host`, for callers that hold ints."""
    ext, internal, diag = _const_lists()
    x = _external_linear_ints(state)
    half = R_F // 2
    for r in range(R_F + R_P):
        if half <= r < half + R_P:
            x[0] = pow(x[0] + internal[r - half], 7, P)
            total = sum(x)
            x = [(v * d + total) % P for v, d in zip(x, diag)]
        else:
            rc = ext[r if r < half else r - R_P]
            x = _external_linear_ints(
                [pow(v + c, 7, P) for v, c in zip(x, rc)])
    return x


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _prod(xs) -> int:
    out = 1
    for v in xs:
        out *= int(v)
    return out


def _operand(t: torch.Tensor, shape: Tuple[int, ...], n: int):
    """(contiguous tensor, div, mod) with
    broadcast(t, shape).flatten()[i] == tensor.flatten()[(i // div) % mod].

    Scalars, and operands whose non-unit dims form one run that matches the
    output there (row vector, column vector, full shape), are passed as they
    are; anything else is materialised at the output shape."""
    if t.numel() > 1 and 0 in t.stride():
        # undo expand(): a stride-0 dim repeats one entry
        for d, (size, stride) in enumerate(zip(t.shape, t.stride())):
            if stride == 0 and size > 1:
                t = t.narrow(d, 0, 1)
    if t.numel() == 1:
        return t.reshape(1), 1, 1
    ts = (1,) * (len(shape) - t.dim()) + tuple(t.shape)
    nz = [i for i, d in enumerate(ts) if d != 1]
    i0, i1 = nz[0], nz[-1]
    if all(ts[i] == shape[i] for i in range(i0, i1 + 1)):
        return t.contiguous(), _prod(shape[i1 + 1:]), _prod(shape[i0:i1 + 1])
    return t.expand(shape).contiguous(), 1, n


def _binary(name: str, plain, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _require_field(a, name)
    _require_field(b, name)
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    n = _prod(shape)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if n == 0:
        return out
    ta, a_div, a_mod = _operand(a, shape, n)
    tb, b_div, b_mod = _operand(b, shape, n)
    fn = getattr(_lib("goldilocks"), f"{name}_launch")
    with torch.cuda.device(a.device):
        rc = fn(ta.data_ptr(), a_div, a_mod, tb.data_ptr(), b_div, b_mod,
                out.data_ptr(), n, _stream(a.device))
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def gl_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a * b mod p with broadcasting.

    Replaces `pallas_mul` (body `_mul_kernel`) of the JAX package's
    ops/pallas_kernels.py. There the product is built from 16-bit pieces of
    uint32 limb pairs over (512, 128) tiles; here one thread forms lo = a*b
    and hi = __umul64hi(a, b) and runs the same 128 -> 64 bit reduction. It
    moves 24 bytes per element, so device memory bounds it on an H100."""
    return _binary("gl_mul", gl_mul_plain, a, b)


def gl_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a + b mod p (helper on the shared device routines; ports
    no TPU kernel). Memory-bound."""
    return _binary("gl_add", gl_add_plain, a, b)


def gl_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a - b mod p (helper; ports no TPU kernel). Memory-bound."""
    return _binary("gl_sub", gl_sub_plain, a, b)


def gl_pow7(a: torch.Tensor) -> torch.Tensor:
    """Elementwise a^7 mod p, four multiplies fused in registers (helper;
    ports no TPU kernel). Memory-bound: 16 bytes per element."""
    _require_field(a, "gl_pow7")
    if a.device.type == "cpu":
        return gl_pow7_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"gl_pow7: unsupported device {a.device}")
    src = a.contiguous()
    out = torch.empty_like(src)
    n = src.numel()
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _lib("goldilocks").gl_pow7_launch(
            src.data_ptr(), out.data_ptr(), n, _stream(a.device))
    _check(rc, "gl_pow7")
    LAUNCHES["gl_pow7"] += 1
    return out


_P2_CONSTANTS_SET = set()  # CUDA device indices whose constant memory is set


def _p2_lib(device: torch.device) -> ctypes.CDLL:
    lib = _lib("poseidon2")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _P2_CONSTANTS_SET:
        ext, internal, diag = (np.ascontiguousarray(t)
                               for t in const_tables_u64())
        with torch.cuda.device(device):
            rc = lib.p2_set_constants(ext.ctypes.data, internal.ctypes.data,
                                      diag.ctypes.data)
        _check(rc, "p2_set_constants")
        _P2_CONSTANTS_SET.add(idx)
    return lib


def poseidon2_permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation on (..., 12) states, any batch >= 1.

    Replaces `pallas_poseidon2_permute` (body `_make_poseidon2_kernel`) of
    the JAX package's ops/pallas_kernels.py. There a lane-major block of 2048
    states stays in on-chip memory for all rounds; here one thread keeps one
    state's 12 lanes in registers for all 30 rounds, with the round constants
    in constant memory. 736 field multiplies against 192 bytes per state:
    integer arithmetic bounds it on an H100, not memory."""
    _require_field(state, "poseidon2_permute")
    if state.shape[-1] != T:
        raise ValueError(f"poseidon2_permute: last dim must be {T}, got "
                         f"{tuple(state.shape)}")
    if state.device.type == "cpu":
        if state.numel() == T:
            return poseidon2_permute_one_host(state)
        return poseidon2_permute_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"poseidon2_permute: unsupported device {state.device}")
    src = state.contiguous()
    out = torch.empty_like(src)
    batch = src.numel() // T
    if batch == 0:
        return out
    lib = _p2_lib(state.device)
    with torch.cuda.device(state.device):
        rc = lib.p2_permute_launch(src.data_ptr(), out.data_ptr(), batch,
                                   _stream(state.device))
    _check(rc, "poseidon2_permute")
    LAUNCHES["poseidon2_permute"] += 1
    return out


# ---------------------------------------------------------------------------
# Poseidon2 over BN254 Fr (no TPU counterpart)
# ---------------------------------------------------------------------------

def bn254_hash_rows_plain(cols: torch.Tensor) -> torch.Tensor:
    """(w, k) canonical Goldilocks values on the CPU -> (k, 4) Fr digests:
    each row packed 3 values per Fr and sponge-hashed, in exact Python ints
    (the JAX package's algorithm, `utils/poseidon2_bn254.py`)."""
    rows = cols.numpy().view(np.uint64).T.tolist()
    digests = [p2b.hash_elements(p2b.pack_goldilocks(r)) for r in rows]
    return torch.from_numpy(p2b.to_limbs(digests))


def bn254_hash_pairs_plain(nodes: torch.Tensor) -> torch.Tensor:
    """(2m, 4) Fr limbs on the CPU -> (m, 4): node i = hash(in[2i],
    in[2i + 1]), one permutation of [l, r, 0] each, in exact Python ints."""
    vals = p2b.from_limbs(nodes.numpy())
    assert all(v < p2b.FR for v in vals), "Fr limbs must be canonical"
    return torch.from_numpy(p2b.to_limbs(
        [p2b.hash_elements(vals[i:i + 2]) for i in range(0, len(vals), 2)]))


_BN254_CONSTANTS_SET = set()  # CUDA device indices whose constant memory is set


def _mont_limbs(values) -> np.ndarray:
    """Fr ints -> Montgomery form (times 2^256 mod p), (k, 4) uint64."""
    return np.ascontiguousarray(p2b.to_limbs(
        [(int(v) << 256) % p2b.FR for v in values]).view(np.uint64))


def bn254_constant_tables() -> Tuple[np.ndarray, ...]:
    """The four arrays `bn254_set_constants` takes, (k, 4) uint64: 2^512
    mod p, then the external rounds' constants (4 initial rounds, 4 final),
    the internal rounds' and the diagonal, in Montgomery form."""
    ext0, internal, ext1, diag = p2b.round_constants()
    r2 = np.ascontiguousarray(
        p2b.to_limbs([(1 << 512) % p2b.FR]).view(np.uint64))
    return (r2, _mont_limbs([c for rc in ext0 + ext1 for c in rc]),
            _mont_limbs(internal), _mont_limbs(diag))


def _bn254_lib(device: torch.device) -> ctypes.CDLL:
    lib = _lib("poseidon2_bn254")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _BN254_CONSTANTS_SET:
        tables = bn254_constant_tables()
        with torch.cuda.device(device):
            rc = lib.bn254_set_constants(*(t.ctypes.data for t in tables))
        _check(rc, "bn254_set_constants")
        _BN254_CONSTANTS_SET.add(idx)
    return lib


def bn254_hash_rows(cols: torch.Tensor) -> torch.Tensor:
    """(w, k) canonical Goldilocks values, column-major as the prover's LDE
    lies -> (k, 4) int64 limbs of each row's Poseidon2-BN254 sponge digest
    (3 values packed per Fr, zero-padded to the rate, digest lane 0).

    Replaces no TPU kernel: the JAX package hashes the for-wrapper trees in
    host Python (prover/hash_backend.py `hash_rows`). One thread per row,
    the Fr state in registers in Montgomery form; integer arithmetic bounds
    it on an H100. The values must be canonical (< p): the kernel packs the
    bits as they are, and the plain version refuses other values."""
    _require_field(cols, "bn254_hash_rows")
    if cols.dim() != 2:
        raise ValueError(f"bn254_hash_rows: want (w, k), got "
                         f"{tuple(cols.shape)}")
    if cols.device.type == "cpu":
        return bn254_hash_rows_plain(cols)
    if cols.device.type != "cuda":
        raise ValueError(f"bn254_hash_rows: unsupported device {cols.device}")
    src = cols.contiguous()
    w, k = src.shape
    out = torch.empty((k, 4), dtype=torch.int64, device=cols.device)
    if k == 0:
        return out
    lib = _bn254_lib(cols.device)
    with torch.cuda.device(cols.device):
        rc = lib.bn254_hash_rows_launch(src.data_ptr(), w, k, out.data_ptr(),
                                        _stream(cols.device))
    _check(rc, "bn254_hash_rows")
    LAUNCHES["bn254_hash_rows"] += 1
    return out


def bn254_hash_pairs(nodes: torch.Tensor) -> torch.Tensor:
    """(2m, 4) int64 limbs of canonical Fr -> (m, 4): one Merkle level,
    node i = permute([in[2i], in[2i + 1], 0])[0]. Replaces no TPU kernel
    (see `bn254_hash_rows`); one thread per node."""
    _require_field(nodes, "bn254_hash_pairs")
    if nodes.dim() != 2 or nodes.shape[1] != 4 or nodes.shape[0] % 2:
        raise ValueError(f"bn254_hash_pairs: want (2m, 4), got "
                         f"{tuple(nodes.shape)}")
    if nodes.device.type == "cpu":
        return bn254_hash_pairs_plain(nodes)
    if nodes.device.type != "cuda":
        raise ValueError(f"bn254_hash_pairs: unsupported device "
                         f"{nodes.device}")
    src = nodes.contiguous()
    m = src.shape[0] // 2
    out = torch.empty((m, 4), dtype=torch.int64, device=nodes.device)
    if m == 0:
        return out
    lib = _bn254_lib(nodes.device)
    with torch.cuda.device(nodes.device):
        rc = lib.bn254_hash_pairs_launch(src.data_ptr(), m, out.data_ptr(),
                                         _stream(nodes.device))
    _check(rc, "bn254_hash_pairs")
    LAUNCHES["bn254_hash_pairs"] += 1
    return out
