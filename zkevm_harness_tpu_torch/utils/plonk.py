"""PLONK over BN254 KZG: the SNARK wrapper's proof system.

The reference wraps the final compression proof in a bellman_ce PLONK proof
over BN254 (src/proof_wrapper_utils/wrapper.rs:108-275, 2^24 domain for the
L1 verifier). This is that protocol, host-exact over utils/bn254.py:

  - 3 wire columns (a, b, c), gate equation
        qM*a*b + qL*a + qR*b + qO*c + qC + PI(X) = 0  on H,
  - copy permutation over the 3 wire cosets (k1 = 2, k2 = 3) with the
    grand-product polynomial z(X),
  - quotient t(X) split into 3 degree-<n chunks, computed on a 4n coset,
  - Kate openings of every polynomial at zeta (and z at zeta*omega), batched
    with powers of v into two KZG witnesses (the "all-evals" PLONK variant:
    no linearization polynomial — the verifier checks the gate+permutation
    identity directly on the claimed evaluations and batch-verifies the
    openings; completeness and soundness are the standard batched-KZG
    argument),
  - Fiat-Shamir over keccak256.

No zero-knowledge blinding: the wrapper attests to a public computation
(verifying the compression proof), exactly like the reference's usage where
the witness is derivable from public data.

The wrapper proves once per block on the host — off the card's hot path, as
the reference keeps its wrapper on CPU. Counterpart of the JAX package's
`utils/plonk.py`, moved across as it is (its structural-error guard is the
port's `prover/guard.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import bn254 as bn
from .native import keccak256

R = bn.R
K1 = 2
K2 = 3


# ---------------------------------------------------------------------------
# Fr polynomial utilities
# ---------------------------------------------------------------------------

def fr_ifft(evals: Sequence[int]) -> List[int]:
    n = len(evals)
    coeffs = bn.fr_fft(list(evals))
    n_inv = pow(n, R - 2, R)
    out = [coeffs[0] * n_inv % R] + \
        [coeffs[n - i] * n_inv % R for i in range(1, n)]
    return out


def coset_fft(coeffs: Sequence[int], size: int, shift: int) -> List[int]:
    """Evaluate coeffs (len <= size) on shift * H_size."""
    c = list(coeffs) + [0] * (size - len(coeffs))
    acc = 1
    for i in range(size):
        c[i] = c[i] * acc % R
        acc = acc * shift % R
    return bn.fr_fft(c)


def coset_ifft(evals: Sequence[int], shift: int) -> List[int]:
    c = fr_ifft(evals)
    sinv = pow(shift, R - 2, R)
    acc = 1
    for i in range(len(c)):
        c[i] = c[i] * acc % R
        acc = acc * sinv % R
    return c


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    y = 0
    for c in reversed(list(coeffs)):
        y = (y * x + c) % R
    return y


# ---------------------------------------------------------------------------
# Circuit representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlonkCircuit:
    """n gates (power of two after padding). Wire slot j of column k is
    copy-class `permutation[k][j]` (slots sharing a class are wired)."""
    num_gates: int
    qL: List[int]
    qR: List[int]
    qO: List[int]
    qM: List[int]
    qC: List[int]
    wires: Tuple[List[int], List[int], List[int]]  # copy-class ids per slot
    public_gates: List[int]  # gate rows whose `a` wire is a public input


@dataclasses.dataclass
class PlonkVerificationKey:
    n: int
    q_comms: Dict[str, Tuple]
    sigma_comms: Tuple
    public_gates: List[int]
    g2_powers: Tuple


@dataclasses.dataclass
class PlonkSetup:
    circuit: PlonkCircuit
    crs: List
    g2_powers: Tuple
    q_polys: Dict[str, List[int]]
    sigma_polys: Tuple[List[int], List[int], List[int]]
    sigma_evals: Tuple[List[int], List[int], List[int]]  # on H (slot labels)
    vk: PlonkVerificationKey


@dataclasses.dataclass
class PlonkProof:
    public_inputs: List[int]
    comms: Dict[str, Tuple]     # a, b, c, z, t_lo, t_mid, t_hi
    evals: Dict[str, int]       # at zeta (+ z_omega at zeta*omega)
    w_zeta: Tuple
    w_zeta_omega: Tuple


def _pad_pow2(x: int) -> int:
    return 1 << max(2, (x - 1).bit_length())


def _domain(n: int) -> List[int]:
    w = bn.fr_root_of_unity(n.bit_length() - 1)
    out = [1]
    for _ in range(n - 1):
        out.append(out[-1] * w % R)
    return out


def _sigma_permutation(circuit: PlonkCircuit, n: int,
                       dom: List[int]) -> Tuple[List[int], ...]:
    """Slot labels: column 0 -> w^i, column 1 -> k1*w^i, column 2 -> k2*w^i;
    sigma maps each slot to the next slot in its copy cycle."""
    ks = (1, K1, K2)
    label = [[ks[c] * dom[i] % R for i in range(n)] for c in range(3)]
    classes: Dict[int, List[Tuple[int, int]]] = {}
    for c in range(3):
        col = circuit.wires[c]
        for i in range(n):
            cid = col[i] if i < len(col) else -1_000_000 - (c * n + i)
            classes.setdefault(cid, []).append((c, i))
    sigma = [list(label[c]) for c in range(3)]
    for slots in classes.values():
        for idx, (c, i) in enumerate(slots):
            nc, ni = slots[(idx + 1) % len(slots)]
            sigma[c][i] = label[nc][ni]
    return tuple(sigma)


def plonk_setup(circuit: PlonkCircuit, crs: Optional[List] = None,
                g2_powers: Optional[Tuple] = None) -> PlonkSetup:
    n = _pad_pow2(circuit.num_gates)
    dom = _domain(n)

    def padq(v):
        return list(v) + [0] * (n - len(v))

    q_polys = {name: fr_ifft(padq(getattr(circuit, name)))
               for name in ("qL", "qR", "qO", "qM", "qC")}
    sig_evals = _sigma_permutation(circuit, n, dom)
    sigma_polys = tuple(fr_ifft(list(s)) for s in sig_evals)
    crs = crs if crs is not None else bn.simulated_crs(n + 1)
    g2_powers = g2_powers if g2_powers is not None else bn.simulated_crs_g2()
    q_comms = {k: bn.kate_commit(crs, v) for k, v in q_polys.items()}
    sigma_comms = tuple(bn.kate_commit(crs, s) for s in sigma_polys)
    vk = PlonkVerificationKey(n=n, q_comms=q_comms, sigma_comms=sigma_comms,
                              public_gates=list(circuit.public_gates),
                              g2_powers=g2_powers)
    return PlonkSetup(circuit=circuit, crs=crs, g2_powers=g2_powers,
                      q_polys=q_polys, sigma_polys=sigma_polys,
                      sigma_evals=sig_evals, vk=vk)


# ---------------------------------------------------------------------------
# Fiat-Shamir transcript
# ---------------------------------------------------------------------------

class _FS:
    def __init__(self, tag: bytes = b"tpu-plonk-bn254"):
        self.state = keccak256(tag)

    def absorb_point(self, p):
        data = (b"\x00" * 64 if p is None
                else p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big"))
        self.state = keccak256(self.state + data)

    def absorb_fr(self, x: int):
        self.state = keccak256(self.state + (int(x) % R).to_bytes(32, "big"))

    def challenge(self) -> int:
        self.state = keccak256(self.state + b"\x01")
        return int.from_bytes(self.state, "big") % R


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

_EVAL_NAMES = ("a", "b", "c", "qL", "qR", "qO", "qM", "qC",
               "s1", "s2", "s3", "t_lo", "t_mid", "t_hi", "z")


def _batch_inverse(vals: Sequence[int]) -> List[int]:
    """[v^-1 mod R for v in vals], 0 for 0 (as pow(v, R - 2, R) gives), with
    one modular exponentiation for the whole list (Montgomery's trick)."""
    prefix = []
    acc = 1
    for v in vals:
        prefix.append(acc)
        if v % R:
            acc = acc * v % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        v = vals[i] % R
        if v:
            out[i] = inv * prefix[i] % R
            inv = inv * v % R
    return out


def plonk_prove(setup: PlonkSetup, wire_values: Tuple[Sequence[int], ...],
                public_inputs: Sequence[int]) -> PlonkProof:
    """wire_values: three length-num_gates value vectors consistent with the
    circuit's copy classes; public_inputs: values of the `a` wire at the
    circuit's public gates."""
    circ = setup.circuit
    n = setup.vk.n
    dom = _domain(n)
    omega = dom[1] if n > 1 else 1

    av = [int(v) % R for v in wire_values[0]] + [0] * (n - circ.num_gates)
    bv = [int(v) % R for v in wire_values[1]] + [0] * (n - circ.num_gates)
    cv = [int(v) % R for v in wire_values[2]] + [0] * (n - circ.num_gates)
    assert len(public_inputs) == len(circ.public_gates)
    for g, x in zip(circ.public_gates, public_inputs):
        assert av[g] == int(x) % R, "public input disagrees with wire value"

    # PI(X) = -sum x_i L_{g_i}(X): as evaluations
    pi_evals = [0] * n
    for g, x in zip(circ.public_gates, public_inputs):
        pi_evals[g] = (-int(x)) % R

    a_poly, b_poly, c_poly = fr_ifft(av), fr_ifft(bv), fr_ifft(cv)
    pi_poly = fr_ifft(pi_evals)

    fs = _FS()
    for x in public_inputs:
        fs.absorb_fr(x)
    comms = {"a": bn.kate_commit(setup.crs, a_poly),
             "b": bn.kate_commit(setup.crs, b_poly),
             "c": bn.kate_commit(setup.crs, c_poly)}
    for k in ("a", "b", "c"):
        fs.absorb_point(comms[k])
    beta = fs.challenge()
    gamma = fs.challenge()

    # grand product z (the inverses of all denominators in one batch)
    s1e, s2e, s3e = setup.sigma_evals
    nums, dens = [], []
    for i in range(n):
        nums.append(((av[i] + beta * dom[i] + gamma)
                     * (bv[i] + beta * K1 * dom[i] + gamma) % R
                     * ((cv[i] + beta * K2 * dom[i] + gamma) % R)) % R)
        dens.append(((av[i] + beta * s1e[i] + gamma)
                     * (bv[i] + beta * s2e[i] + gamma) % R
                     * ((cv[i] + beta * s3e[i] + gamma) % R)) % R)
    den_inv = _batch_inverse(dens)
    z_evals = [1]
    for i in range(n - 1):
        z_evals.append(z_evals[-1] * nums[i] % R * den_inv[i] % R)
    # final wrap must close the product
    assert z_evals[-1] * nums[-1] % R * den_inv[-1] % R == 1, \
        "copy permutation does not close (wires inconsistent)"
    z_poly = fr_ifft(z_evals)
    comms["z"] = bn.kate_commit(setup.crs, z_poly)
    fs.absorb_point(comms["z"])
    alpha = fs.challenge()

    # quotient on a 4n coset
    m = 4 * n
    shift = bn.FR_GENERATOR
    co = {}
    for name, poly in (("a", a_poly), ("b", b_poly), ("c", c_poly),
                       ("z", z_poly), ("pi", pi_poly),
                       ("qL", setup.q_polys["qL"]),
                       ("qR", setup.q_polys["qR"]),
                       ("qO", setup.q_polys["qO"]),
                       ("qM", setup.q_polys["qM"]),
                       ("qC", setup.q_polys["qC"]),
                       ("s1", setup.sigma_polys[0]),
                       ("s2", setup.sigma_polys[1]),
                       ("s3", setup.sigma_polys[2])):
        co[name] = coset_fft(poly, m, shift)
    # z(omega X) on the coset: rotate poly coefficients by omega powers
    z_shift = [z_poly[i] * pow(omega, i, R) % R for i in range(len(z_poly))]
    co["zw"] = coset_fft(z_shift, m, shift)
    # L1(X) = (X^n - 1) / (n (X - 1))
    dom4 = _domain(m)
    zh = []
    n_inv = pow(n, R - 2, R)
    xm1_inv = _batch_inverse([(shift * dom4[i] - 1) % R for i in range(m)])
    for i in range(m):
        x = shift * dom4[i] % R
        zh.append((pow(x, n, R) - 1) % R)
    l1 = [zh[i] * n_inv % R * xm1_inv[i] % R for i in range(m)]
    zh_inv = _batch_inverse(zh)

    t_evals = []
    for i in range(m):
        x = shift * dom4[i] % R
        gate = (co["qM"][i] * co["a"][i] % R * co["b"][i]
                + co["qL"][i] * co["a"][i] + co["qR"][i] * co["b"][i]
                + co["qO"][i] * co["c"][i] + co["qC"][i] + co["pi"][i]) % R
        perm = ((co["a"][i] + beta * x + gamma)
                * (co["b"][i] + beta * K1 * x + gamma) % R
                * ((co["c"][i] + beta * K2 * x + gamma) % R) % R
                * co["z"][i]
                - (co["a"][i] + beta * co["s1"][i] + gamma)
                * (co["b"][i] + beta * co["s2"][i] + gamma) % R
                * ((co["c"][i] + beta * co["s3"][i] + gamma) % R) % R
                * co["zw"][i]) % R
        bound = (co["z"][i] - 1) * l1[i] % R
        num = (gate + alpha * perm + alpha * alpha % R * bound) % R
        t_evals.append(num * zh_inv[i] % R)
    t_poly = coset_ifft(t_evals, shift)
    assert all(v == 0 for v in t_poly[3 * n:]), "quotient degree overflow"
    t_lo, t_mid, t_hi = t_poly[:n], t_poly[n:2 * n], t_poly[2 * n:3 * n]
    comms["t_lo"] = bn.kate_commit(setup.crs, t_lo)
    comms["t_mid"] = bn.kate_commit(setup.crs, t_mid)
    comms["t_hi"] = bn.kate_commit(setup.crs, t_hi)
    for k in ("t_lo", "t_mid", "t_hi"):
        fs.absorb_point(comms[k])
    zeta = fs.challenge()

    polys = {"a": a_poly, "b": b_poly, "c": c_poly,
             "qL": setup.q_polys["qL"], "qR": setup.q_polys["qR"],
             "qO": setup.q_polys["qO"], "qM": setup.q_polys["qM"],
             "qC": setup.q_polys["qC"],
             "s1": setup.sigma_polys[0], "s2": setup.sigma_polys[1],
             "s3": setup.sigma_polys[2],
             "t_lo": t_lo, "t_mid": t_mid, "t_hi": t_hi, "z": z_poly}
    evals = {name: poly_eval(polys[name], zeta) for name in _EVAL_NAMES}
    evals["z_omega"] = poly_eval(z_poly, zeta * omega % R)
    for name in _EVAL_NAMES:
        fs.absorb_fr(evals[name])
    fs.absorb_fr(evals["z_omega"])
    v = fs.challenge()

    # batched opening at zeta
    agg = [0] * n
    vp = 1
    agg_y = 0
    for name in _EVAL_NAMES:
        p = polys[name]
        for i in range(len(p)):
            agg[i] = (agg[i] + vp * p[i]) % R
        agg_y = (agg_y + vp * evals[name]) % R
        vp = vp * v % R
    w_zeta, y_chk = bn.kate_open(setup.crs, agg, zeta)
    assert y_chk == agg_y
    w_zeta_omega, y2 = bn.kate_open(setup.crs, z_poly, zeta * omega % R)
    assert y2 == evals["z_omega"]

    return PlonkProof(public_inputs=[int(x) % R for x in public_inputs],
                      comms=comms, evals=evals,
                      w_zeta=w_zeta, w_zeta_omega=w_zeta_omega)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

def plonk_verify(vk: PlonkVerificationKey, proof: PlonkProof,
                 strict: bool = None) -> bool:
    try:
        n = vk.n
        dom_omega = bn.fr_root_of_unity(n.bit_length() - 1)
        if len(proof.public_inputs) != len(vk.public_gates):
            return False
        ev = {k: int(x) % R for k, x in proof.evals.items()}
        if set(ev) != set(_EVAL_NAMES) | {"z_omega"}:
            return False

        fs = _FS()
        for x in proof.public_inputs:
            fs.absorb_fr(x)
        for k in ("a", "b", "c"):
            fs.absorb_point(proof.comms[k])
        beta = fs.challenge()
        gamma = fs.challenge()
        fs.absorb_point(proof.comms["z"])
        alpha = fs.challenge()
        for k in ("t_lo", "t_mid", "t_hi"):
            fs.absorb_point(proof.comms[k])
        zeta = fs.challenge()
        for name in _EVAL_NAMES:
            fs.absorb_fr(ev[name])
        fs.absorb_fr(ev["z_omega"])
        v = fs.challenge()

        # scalar identity at zeta
        zh = (pow(zeta, n, R) - 1) % R
        if zh == 0:
            return False
        n_inv = pow(n, R - 2, R)
        l1 = zh * n_inv % R * pow((zeta - 1) % R, R - 2, R) % R
        pi_at = 0
        for g, x in zip(vk.public_gates, proof.public_inputs):
            lg = (zh * n_inv % R * pow(dom_omega, g, R) % R
                  * pow((zeta - pow(dom_omega, g, R)) % R, R - 2, R)) % R
            pi_at = (pi_at - int(x) * lg) % R
        gate = (ev["qM"] * ev["a"] % R * ev["b"] + ev["qL"] * ev["a"]
                + ev["qR"] * ev["b"] + ev["qO"] * ev["c"] + ev["qC"]
                + pi_at) % R
        perm = ((ev["a"] + beta * zeta + gamma)
                * (ev["b"] + beta * K1 * zeta + gamma) % R
                * ((ev["c"] + beta * K2 * zeta + gamma) % R) % R * ev["z"]
                - (ev["a"] + beta * ev["s1"] + gamma)
                * (ev["b"] + beta * ev["s2"] + gamma) % R
                * ((ev["c"] + beta * ev["s3"] + gamma) % R) % R
                * ev["z_omega"]) % R
        bound = (ev["z"] - 1) * l1 % R
        lhs = (gate + alpha * perm + alpha * alpha % R * bound) % R
        zn = pow(zeta, n, R)
        t_at = (ev["t_lo"] + zn * ev["t_mid"] + zn * zn % R * ev["t_hi"]) % R
        if lhs != t_at * zh % R:
            return False

        # batched KZG opening at zeta
        all_comms = dict(proof.comms)
        all_comms.update(vk.q_comms)
        all_comms["s1"], all_comms["s2"], all_comms["s3"] = vk.sigma_comms
        agg_c = None
        agg_y = 0
        vp = 1
        for name in _EVAL_NAMES:
            agg_c = bn.g1_add(agg_c, bn.g1_mul(all_comms[name], vp))
            agg_y = (agg_y + vp * ev[name]) % R
            vp = vp * v % R
        if not bn.kate_verify(vk.g2_powers, agg_c, zeta, agg_y,
                              proof.w_zeta):
            return False
        if not bn.kate_verify(vk.g2_powers, proof.comms["z"],
                              zeta * dom_omega % R, ev["z_omega"],
                              proof.w_zeta_omega):
            return False
        return True
    except (KeyError, TypeError, ValueError, IndexError) as e:
        # structural-error guard (prover/guard.py): reject malformed proofs
        # observably; strict mode re-raises so internal bugs surface.
        from ..prover import guard
        from . import tracing
        if guard.strict_default() if strict is None else strict:
            raise
        tracing.count("verify_structural_reject")
        tracing.count(f"verify_structural_reject/{type(e).__name__}")
        return False
