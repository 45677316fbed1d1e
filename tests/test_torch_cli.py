"""The port's CLI (`python -m zkevm_harness_tpu_torch`) against the JAX
CLI's outputs, through `main([...])` with `--device cpu`: `prove` writes the
JAX CLI's file byte for byte (test_artifacts/cli_prove_log8_w16.json),
`verify` prints VALID and exits 0 on it and INVALID and exits 1 on a
tampered copy, `geometry` prints the JAX CLI's JSON, `generate-vks` writes
its VKs, and `prove-block` (slow) writes its scheduler, compression and
SNARK proofs and block commitment (test_artifacts/cli_*,
tools/gen_cli_golden.py)."""

import contextlib
import io
import json
import os

import pytest

from zkevm_harness_tpu_torch.__main__ import main

ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def _golden_bytes(name):
    with open(os.path.join(ART, name), "rb") as f:
        return f.read()


def _run(argv):
    """(exit code, printed text) of one CLI command."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


@pytest.fixture(scope="module")
def proof_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "proof.json")
    code, text = _run(["prove", "--log-n", "8", "--width", "16", "--seed", "0",
                       "--out", path, "--device", "cpu"])
    assert code == 0
    assert text == f"proof written to {path} (verified)\n"
    return path


def test_prove_writes_the_jax_file(proof_file):
    with open(proof_file, "rb") as f:
        assert f.read() == _golden_bytes("cli_prove_log8_w16.json")


def test_verify_valid_exits_0(proof_file):
    assert _run(["verify", "--proof", proof_file, "--device", "cpu"]) == \
        (0, "VALID\n")


@pytest.mark.parametrize("what", ["public_input", "vk"])
def test_verify_tampered_exits_1(proof_file, tmp_path, what):
    with open(proof_file) as f:
        blob = json.load(f)
    if what == "vk":
        blob["vk"][0] = int(blob["vk"][0]) + 1
    else:
        fields = blob["proof"]["fields"]
        fields["public_inputs"][0] = int(fields["public_inputs"][0]) + 1
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump(blob, f)
    assert _run(["verify", "--proof", bad, "--device", "cpu"]) == \
        (1, "INVALID\n")


@pytest.mark.parametrize("argv, golden", [
    (["geometry"], "cli_geometry.txt"),
    (["geometry", "--measured"], "cli_geometry_measured.txt")])
def test_geometry_prints_the_jax_json(argv, golden):
    code, text = _run(argv + ["--device", "cpu"])
    assert code == 0
    assert text.encode() == _golden_bytes(golden)


@pytest.mark.slow  # leaf and node synthesis and setups, about 30 s
def test_generate_vks_testing_recursion(tmp_path):
    code, text = _run(["generate-vks", "--types", "8", "--recursion",
                       "--out", str(tmp_path), "--device", "cpu"])
    assert code == 0
    assert text.endswith(f"verification keys written to {tmp_path}\n")
    for what, rel in (("base", "setup/base_layer/vk_8.json"),
                      ("leaf", "setup/recursion_layer/vk_10.json"),
                      ("node", "setup/recursion_layer/vk_2.json")):
        with open(tmp_path / rel, "rb") as f:
            assert f.read() == _golden_bytes(f"cli_vks8_{what}_vk.json"), what
    digests = json.loads((tmp_path / "setup/vk_digests.json").read_text())
    assert digests["geometry"] == "testing"
    assert set(digests["vk_sha256"]) == {"8"}


def test_generate_vks_base_only(tmp_path):
    code, _text = _run(["generate-vks", "--types", "8", "--out", str(tmp_path),
                        "--device", "cpu"])
    assert code == 0
    with open(tmp_path / "setup/base_layer/vk_8.json", "rb") as f:
        assert f.read() == _golden_bytes("cli_vks8_base_vk.json")


@pytest.mark.slow  # the full chain on the CPU: tens of minutes
def test_prove_block_writes_the_golden_files(tmp_path):
    code, text = _run(["prove-block", "--types", "8", "--out", str(tmp_path),
                       "--device", "cpu"])
    assert code == 0
    summary = json.loads(_golden_bytes("cli_block_summary.json"))
    assert f"block commitment: {summary['block_commitment']}\n" in text
    for what, rel in (
            ("scheduler", "test_proofs/recursion_layer/scheduler_proof.json"),
            ("compression", "test_proofs/aux_layer/compression_proof_1.json"),
            ("snark", "test_proofs/aux_layer/wrapper_proof.json")):
        with open(tmp_path / rel, "rb") as f:
            assert f.read() == _golden_bytes(f"cli_block_{what}_proof.json")


def test_every_command_takes_a_device():
    for cmd in ("prove", "verify", "prove-block", "generate-vks", "geometry",
                "bench-kernels"):
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                main([cmd, "--device"])  # the option wants a value


def test_bench_kernels_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        _run(["bench-kernels", "--device", "cpu"])
