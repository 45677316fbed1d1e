"""The build bookkeeping of `ops/cuda_kernels.py`, without nvcc: when a
library counts as stale (its source or any header under csrc/ newer than
it), and the reading of ptxas' register and spill report."""

import os

import pytest

from zkevm_harness_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ and build/ pair in a temporary directory: two sources, two
    headers, one library built at t = 1000 s."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    for f in ("goldilocks.cuh", "bn254_fr.cuh", "poseidon2_bn254.cu",
              "goldilocks.cu"):
        (csrc / f).write_text("// source\n")
        os.utime(csrc / f, (900, 900))
    monkeypatch.setattr(ck, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(ck, "BUILD_DIR", str(build))
    lib = build / "libposeidon2_bn254.so"
    lib.write_bytes(b"\x7fELF")
    os.utime(lib, (1000, 1000))
    return csrc, lib


def test_a_missing_library_is_stale(tree):
    assert ck._stale("goldilocks")  # never built
    assert not ck._stale("poseidon2_bn254")


@pytest.mark.parametrize("touched", ["poseidon2_bn254.cu", "bn254_fr.cuh",
                                     "goldilocks.cuh"])
def test_a_newer_source_or_header_makes_the_library_stale(tree, touched):
    csrc, _ = tree
    os.utime(csrc / touched, (1100, 1100))
    assert ck._stale("poseidon2_bn254")


def test_a_new_header_counts_and_other_sources_do_not(tree):
    csrc, _ = tree
    os.utime(csrc / "goldilocks.cu", (1100, 1100))  # another library's
    assert not ck._stale("poseidon2_bn254")
    (csrc / "bn254_fp.cuh").write_text("// a header added later\n")
    os.utime(csrc / "bn254_fp.cuh", (1200, 1200))
    assert ck._stale("poseidon2_bn254")


def test_build_all_skips_fresh_libraries_without_nvcc(tree, monkeypatch):
    monkeypatch.setattr(ck, "SOURCES", ("poseidon2_bn254",))
    monkeypatch.setattr(ck, "_nvcc", lambda: pytest.fail("nvcc was called"))
    assert ck.build_all() == 0.0


PTXAS = """\
ptxas info    : 0 bytes gmem, 1696 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117hash_pairs_kernelEPKmlPm' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117hash_pairs_kernelEPKmlPm
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 376 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116hash_rows_kernelEPKmllPm' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116hash_rows_kernelEPKmllPm
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, 384 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = ck.ptxas_report(PTXAS)
    assert rep == {
        "_ZN12_GLOBAL__N_117hash_pairs_kernelEPKmlPm":
            {"stack": 0, "spill_stores": 0, "spill_loads": 0,
             "registers": 64},
        "_ZN12_GLOBAL__N_116hash_rows_kernelEPKmllPm":
            {"stack": 16, "spill_stores": 12, "spill_loads": 8,
             "registers": 64}}
    assert ck.ptxas_report("") == {}


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k3_work_bound_counts_the_algorithms_multiplies():
    # the bound's constants live in utils/kernel_bench.py, which
    # chip_smoke.py and the CLI's bench-kernels share
    from zkevm_harness_tpu_torch.utils import kernel_bench as cs
    from zkevm_harness_tpu_torch.utils import poseidon2_bn254 as p2b
    assert _chip_smoke().bn254_bound_ms is cs.bn254_bound_ms
    params = p2b.get_params_bn254()
    assert (cs.BN254_MUL_INSNS, cs.BN254_SQR_INSNS,
            cs.BN254_REDC_INSNS) == (264, 208, 136)
    # 80 S-boxes of two squarings and a multiply, 168 diagonal multiplies
    assert cs.bn254_permutation_insns(params) == 80 * (2 * 208 + 264) \
        + 168 * 264 == 98752
    # the production tree: 2^18 rows of 24 Fr (12 permutations each), and
    # its first level of 2^17 pairs
    rows = cs.bn254_bound_ms(params, 12 << 18, 24 << 18, 1 << 18)
    pairs = cs.bn254_bound_ms(params, 1 << 17, 2 << 17, 1 << 17)
    assert 18.6 < rows < 18.7 and 0.77 < pairs < 0.79


SASS = """\
        Function : _ZN12_GLOBAL__N_117hash_pairs_kernelEPKmlPm
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0030*/                   LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT ;
        /*0040*/              @P0 BRA 0x20 ;
        /*0050*/                   ISETP.NE.AND P0, PT, R2, 0x4, PT ;
        /*0060*/              @P0 BRA 0x10 ;
        /*0070*/                   IMAD.HI.U32 R4, R2, R3, RZ ;
        /*0080*/                   IADD3.X R4, R4, RZ, RZ, P0, !PT ;
        /*0090*/              @P1 BRA 0x70 ;
        /*00a0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_116hash_rows_kernelEPKmllPm
        /*0000*/                   EXIT ;
"""


def test_sass_dynamic_counts_multiplies_trips_of_nested_loops(tmp_path):
    cs = _chip_smoke()
    path = tmp_path / "k.sass"
    path.write_text(SASS)
    # loops by first instruction: [0x10, 0x60] holds [0x20, 0x40]; then
    # [0x70, 0x90]
    got = cs.sass_dynamic_counts(str(path), "hash_pairs_kernel", (4, 3, 56))
    assert got == {"imad": 1 + 4 * 3 + 56, "alu": 4 + 4 * 3 + 4 + 56}
    assert cs.sass_dynamic_counts(str(path), "hash_pairs_kernel",
                                  (4, 56)) is None


@pytest.mark.parametrize("name", ["this", "blocks8", "blocks6"])
def test_k3_launch_bound_variants_still_find_their_targets(name):
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "k3_launch_bounds.py")
    spec = importlib.util.spec_from_file_location("k3_launch_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(ck.CSRC_DIR, "poseidon2_bn254.cu")) as f:
        text = f.read()
    src = mod.variant_source(text, name)
    bound = {"this": "(kThreads)", "blocks8": "(kThreads, 8)",
             "blocks6": "(kThreads, 6)"}[name]
    assert src.count("__launch_bounds__" + bound) == 2
    assert src.replace(bound, "(kThreads)") == text
    with pytest.raises(ValueError):
        mod.variant_source("// not the kernel\n", name)
