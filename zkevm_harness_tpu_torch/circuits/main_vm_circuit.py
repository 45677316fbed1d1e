"""MainVM circuit (type 1, stage A): per-cycle VM transition proofs.

The reference's vm_main circuit
(circuit_definitions/src/circuit_definitions/base_layer/vm_main.rs:29-110,
130 copy columns, specialized gates) proves EraVM cycles against the
VmWitnessOracle's per-cycle replay. This is the framework's counterpart for
the structured ISA (vm/interpreter.py), one ROW per cycle:

  - the register file lives as 15 x NLIMB u(L)-bit limb columns; operand
    values are muxed from one-hot register selectors or immediate limbs;
  - PROVEN semantics (stage A): BinOp add/sub (exact limb adds with
    boolean carries + eq/lt flag updates through a zero-sum inverse
    gadget), Nop, Jump, JumpIfEq (on the carried flag state), register
    writeback, pc/timestamp chains, and the log/memory-query side effects
    of StorageWrite/StorageRead/Event/L1-Event/HeapWrite/HeapRead —
    each such row folds (op, timestamp, key/addr, value) into a Horner
    fingerprint accumulator, with READ results entering as oracle-provided
    witness values bound by the same accumulator (exactly how the RAM
    permutation / log circuits consume them);
  - every executed row is bound to the block's CODE by a third
    accumulator over the decoded fields (pc, opcode id, operand selectors,
    immediates, jump target) — challenge-after-commit over the traced
    instruction stream;
  - NEAR-CALL/RET are proven via a fold/unfold STACK ACCUMULATOR (stage
    B): an NCALL row folds <return pc, handler, depth> into AS under a
    Fiat-Shamir gamma; every row that pops a local frame must unfold the
    matching tuple (AS = AS'*gamma + tuple), with RET pinning the next pc
    to the restored return point and RETP (panic) to the popped frame's
    handler. The block-level balance requirement (AS back to its seed,
    depth to 0 — asserted by the decomposer and exposed through the
    boundary PIs) makes LIFO matching sound under Schwartz-Zippel; depth
    tags prevent cross-level matches. Panic unwinds from non-Ret rows
    (ergs exhaustion, invalid opcode, kernel/pointer violations) unfold
    through the same SPOP flag while staying EXT for pc semantics.
    (Reference: the callstack sponge simulator, circuit_encodings
    callstack_entry.rs:181 + callstack_handler.rs.)
  - stage C (round 3): DIV is fully proven (limb-convolution mul identity
    with byte-decomposed carries + remainder bound); fat-pointer
    PADD/PSHR/PPACK are proven over the page|start|length segments with a
    pointer-tag register file (PTRB); Context/Precompile/PtrRead results
    are CTX rows — value oracle-provided, but pc/flags/every OTHER
    register proven preserved;
  - remaining EXT rows are exactly the FRAME switches (far call/ret,
    panic unwinds): their register file is oracle-provided pending the
    far-call stack argument (witness side already simulated,
    witness/callstack_sim.py);
  - public inputs: challenges, the four accumulator boundaries, depth
    boundaries, pc/ts boundaries, validity, the FULL register file and
    its pointer tags at the first and last row (the snapshot FSM binding
    of oracle.rs:1164-1420).

Geometry: tests run u8 limbs x 16 (u128 registers, 2^8 range table);
production uses u16 x 16 (full u256) at 2^16+ rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..prover import plonkish as pk

P = gl.P
NREGS = 15

# opcode classes (stage A + stage B near-call/ret + stage C div/ctx)
OP_NOP, OP_ADD, OP_SUB, OP_JUMP, OP_JEQ = 0, 1, 2, 3, 4
OP_HEAPW, OP_HEAPR, OP_STOW, OP_STOR = 5, 6, 7, 8
OP_EVT, OP_EVTL1, OP_NCALL = 9, 10, 11
OP_RET, OP_RETP, OP_EXT = 12, 13, 14
# stage C: OP_CTX = single-writeback rows (Context/Precompile/PtrRead
# result registers: the written VALUE is oracle data, but pc/flags/every
# OTHER register are proven preserved — no more free-form register writes);
# OP_DIV = full unsigned divmod semantics in-gates (v0 = q*v1 + r with
# r < v1, or q = r = 0 with the eq flag when v1 == 0 — the reference
# constrains mul/div through its ALU gadgets, vm_main.rs:29-110);
# OP_PADD/OP_PSHR/OP_PPACK = fat-pointer arithmetic in-gates over the
# page|start|length segments with a pointer-tag register file (PTRB): the
# source must be tagged pointer, delta <= length via borrow chains, the
# result is tagged pointer (reference ptr.add/sub/pack,
# zkevm_circuits ptr opcodes via vm_main.rs).
OP_CTX, OP_DIV, OP_PADD, OP_PSHR, OP_PPACK = 15, 16, 17, 18, 19
# stage D (round 4): the remaining ALU BinOps leave EXT —
#   OP_MUL: low-256 product via the SAME limb-convolution identity as DIV
#     (v0*v1 = res + 2^256*hi, hi in the REM columns, carries in MCL/MCH);
#   OP_SHL/OP_SHR: dynamic shifts as multiplication/division by a PROVEN
#     power of two (POW2 = one-hot limb-shift x one-hot intra-limb shift;
#     shr reuses the full divmod machinery with divisor POW2, shl the mul
#     identity) — the shift amount is pinned to v1's low byte;
#   OP_AND/OP_OR/OP_XOR: c-bit chunk decompositions looked up in ONE
#     (a, b, a^b) table; and/or derive algebraically from xor
#     (a+b = xor + 2*and, or = xor + and), so one table serves all three.
# (Reference constrains every ALU opcode in vm_main.rs:29-110 via
# zkevm_circuits' mul/div/shift/binop gadgets — same statements here,
# restructured for one shared convolution gate block.)
OP_MUL, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR = 20, 21, 22, 23, 24, 25
# stage E (round 4): FAR-call frame switches leave EXT — OP_FCALL folds
# <ret_pc, handler, depth, FAR-tag> into the stack accumulator (the same
# fold/unfold argument near calls use, with a tag lane preventing
# near/far cross-matching), pins pc' = 0 and preserves every register
# except an optional calldata fat pointer in r1 (value oracle like CTX,
# tag proven); OP_FRET/OP_FRETP unfold with the tag and pin pc' to the
# restored return point / handler. The only remaining EXT rows are
# mid-instruction panic unwinds (they still unfold through spop/fpop).
OP_FCALL, OP_FRET, OP_FRETP = 26, 27, 28
# stage F (round 4): OP_PREAD binds fat-pointer reads through the memory
# fingerprint — page/index derive IN-GATES from the pointer's segments
# (page = V0[64:96], index = start + offset with a proven carry chain into
# the REM lanes), the read VALUE rides RES into the same accumulator the
# RAM-permutation circuit consumes, and out-of-bounds reads PROVE
# offset >= length (or a nonzero high offset) and force RES = 0. The CTX
# escape hatch now covers only Context/Precompile VALUES.
OP_PREAD = 29
# stage G (round 4): mid-instruction panic unwinds (ergs exhaustion,
# invalid opcode, kernel/fat-pointer violations) leave EXT — OP_PANIC is a
# pop row (spop/fpop required) whose aborted instruction never executed:
# pc' = the popped frame's handler (like RETP/FRETP), the register file,
# pointer tags and flags are PROVEN preserved (the writeback gates apply
# with no destination selected), and no log/memory fold fires. OP_EXT now
# matches NO decoder path — it remains only as the explicit escape hatch
# for genuinely unknown instructions (vm/interpreter.py would refuse to
# execute them anyway). Reference: panics route through the same callstack
# unwind the ret path uses (zk_evm cycle.rs panic handling; callstack
# sponge witness circuit_encodings callstack_entry.rs:181).
OP_PANIC = 30
# round 5: the TERMINAL halt row (the root-frame Ret that finishes the
# block) has its own opcode — OP_HALT proves pc' = pc (the padding rows
# carry the exit pc, so the boundary PI pins the halt point) plus the
# same register/pointer/flag preservation as any no-writeback row.
# OP_EXT is now purely the unknown-instruction escape hatch: NO decoder
# or witness path emits it (vm/interpreter.py refuses unknown opcodes).
OP_HALT = 31
NOPS = 32
_PTR_OPS = (OP_PADD, OP_PSHR, OP_PPACK)
_LOG_OPS = (OP_STOW, OP_STOR, OP_EVT, OP_EVTL1)
_MEM_OPS = (OP_HEAPW, OP_HEAPR)
_BW_OPS = (OP_AND, OP_OR, OP_XOR)


@dataclasses.dataclass(frozen=True)
class VmGeometry:
    log_n: int
    limb_bits: int = 16
    num_limbs: int = 16

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def capacity(self) -> int:
        """cycles per instance (cycles_per_vm_snapshot analogue)."""
        return self.n

    @property
    def bw_chunk_bits(self) -> int:
        """Bitwise-op chunk width c: the (a, b, a^b) lookup table has
        2^(2c) rows and must fit the trace domain (and c <= min(L, 8))."""
        c = 1
        for cand in (2, 4, 8):
            if cand <= min(self.limb_bits, 8) and (1 << (2 * cand)) <= self.n:
                c = cand
        return c

    @property
    def bw_chunks_per_limb(self) -> int:
        return self.limb_bits // self.bw_chunk_bits


def _cols(geo: VmGeometry) -> Dict[str, int]:
    NL = geo.num_limbs
    off, w = {}, 0

    def reg(name, k):
        nonlocal w
        off[name] = w
        w += k

    reg("REG", NREGS * NL)
    reg("PC", 1)
    reg("TS", 1)
    reg("OP", NOPS)
    reg("DST", NREGS)
    reg("S0SEL", NREGS)
    reg("S0IMM", 1)
    reg("S1SEL", NREGS)
    reg("S1IMM", 1)
    reg("IMM0", NL)
    reg("IMM1", NL)
    reg("TGT", 1)
    reg("HDL", 1)     # instruction handler field (NCALL; code-stream data)
    reg("RPC", 1)     # pop hint: the pushed return pc
    reg("PHD", 1)     # pop hint: the popped frame's handler
    reg("SPOP", 1)    # this row pops a local frame (stack argument)
    reg("FPOP", 1)    # this row pops a FAR frame (stage E tag lane)
    reg("DEPTH", 1)   # near-call stack depth entering the row
    reg("PG", 1)      # heap-query page (folded into the mem fingerprint)
    reg("ADR", 3)     # log address lanes (folded into the log fingerprint)
    reg("V0", NL)
    reg("V1", NL)
    reg("RES", NL)
    reg("CAR", NL)
    # div columns (stage C): remainder, second destination, mul-carry byte
    # decomposition (conv carries < NL*2^L fit MCL + 2^L*MCH with both
    # lookup-checked), remainder-compare difference + its borrow booleans,
    # zero-divisor flag + inverse hint
    reg("REM", NL)
    reg("DST2", NREGS)
    reg("PTRB", NREGS)  # pointer-tag register file (fat-pointer discipline)
    reg("MCL", 2 * NL - 2)
    reg("MCH", 2 * NL - 2)
    reg("DIF", NL)
    reg("DCAR", NL)
    reg("ZB", 1)
    reg("ZINV", 1)
    # stage D: bitwise chunk decompositions (c-bit chunks of V0/V1 and of
    # the xor result, each triple looked up in the (a, b, a^b) table) and
    # the shift machinery (one-hot limb shift, one-hot intra-limb shift,
    # the proven power-of-two limbs, v1-limb-0 chunks pinning the shift s)
    CH = geo.bw_chunks_per_limb
    reg("B0", NL * CH)
    reg("B1", NL * CH)
    reg("BX", NL * CH)
    reg("LS", 256 // geo.limb_bits)
    reg("BS", geo.limb_bits)
    reg("POW2", NL)
    reg("VBC", CH)
    reg("EQF", 1)     # flag state entering the row
    reg("LTF", 1)
    reg("SINV", 1)    # inverse hint for the zero-sum flag gadget
    reg("PCH", 6 + 2 * NL)   # challenge powers (max fingerprint width)
    reg("GC", 1)      # code gamma
    reg("GL", 1)      # log gamma
    reg("GM", 1)      # mem gamma
    reg("GS", 1)      # stack gamma
    reg("AC", 1)      # code accumulator
    reg("AL", 1)      # log accumulator
    reg("AM", 1)      # mem accumulator
    reg("AS", 1)      # near-call stack accumulator (fold/unfold)
    reg("V", 1)       # row validity
    off["_width"] = w
    return off


K_WRAP = 0      # row n-1 marker
K_FIRST = 1     # row 0 marker
NUM_CONST = 2


def main_vm_ir(geo: VmGeometry) -> pk.PlonkishIR:
    NL, L = geo.num_limbs, geo.limb_bits
    n = geo.n
    off = _cols(geo)
    NPOW = 6 + 2 * NL

    def _gates(alg, w, w_next, c, sel=None):
        out = []
        wrap, first = c[K_WRAP], c[K_FIRST]
        notwrap = _one_minus(alg, wrap)

        def W(name, i=0):
            return w[off[name] + i]

        def Wn(name, i=0):
            return w_next[off[name] + i]

        op = [W("OP", k) for k in range(NOPS)]
        dst = [W("DST", i) for i in range(NREGS)]
        dst2 = [W("DST2", i) for i in range(NREGS)]
        s0 = [W("S0SEL", i) for i in range(NREGS)]
        s1 = [W("S1SEL", i) for i in range(NREGS)]
        s0i, s1i = W("S0IMM"), W("S1IMM")
        v = W("V")
        ext = op[OP_EXT]
        dv = op[OP_DIV]
        zb = W("ZB")

        spop = W("SPOP")
        fpop = W("FPOP")
        notext = _one_minus(alg, ext)

        # --- booleanity ---------------------------------------------------
        if sel is None or sel == 0:
            for b in (op + dst + dst2 + s0 + s1
                      + [s0i, s1i, v, W("EQF"), W("LTF"), spop, fpop, zb]
                      + [W("CAR", j) for j in range(NL)]
                      + [W("DCAR", j) for j in range(NL)]
                      + [W("LS", k) for k in range(256 // L)]
                      + [W("BS", t) for t in range(L)]):
                out.append(alg.sub(alg.mul(b, b), b))
            # pop/push exclusivity + RET/RETP rows must pop the right kind
            pushes = alg.add(op[OP_NCALL], op[OP_FCALL])
            out.append(alg.mul(spop, pushes))
            out.append(alg.mul(fpop, pushes))
            out.append(alg.mul(spop, fpop))
            out.append(alg.mul(op[OP_RET], _one_minus(alg, spop)))
            out.append(alg.mul(op[OP_RETP], _one_minus(alg, spop)))
            out.append(alg.mul(op[OP_FRET], _one_minus(alg, fpop)))
            out.append(alg.mul(op[OP_FRETP], _one_minus(alg, fpop)))
            # stage G: a panic-unwind row must pop exactly one frame (near
            # or far) and selects NO destination (its register preservation
            # then follows from the ordinary writeback gates)
            out.append(alg.mul(op[OP_PANIC],
                               _one_minus(alg, alg.add(spop, fpop))))
            pdsum = alg.add(dst[0], dst2[0])
            for i in range(1, NREGS):
                pdsum = alg.add(pdsum, alg.add(dst[i], dst2[i]))
            out.append(alg.mul(op[OP_PANIC], pdsum))
            # exactly one opcode on valid rows, none on padding
            ssum = op[0]
            for k in range(1, NOPS):
                ssum = alg.add(ssum, op[k])
            out.append(alg.sub(ssum, v))
            # at most one selection per selector family
            for fam in (dst, s0, s1):
                t = fam[0]
                for x in fam[1:]:
                    t = alg.add(t, x)
                out.append(alg.mul(t, alg.add_int(alg.mul_int(t, P - 1), 1)))

            # --- operand muxes -------------------------------------------------
            for j in range(NL):
                m0 = alg.mul(s0i, W("IMM0", j))
                m1 = alg.mul(s1i, W("IMM1", j))
                for i in range(NREGS):
                    m0 = alg.add(m0, alg.mul(s0[i], W("REG", i * NL + j)))
                    m1 = alg.add(m1, alg.mul(s1[i], W("REG", i * NL + j)))
                out.append(alg.sub(W("V0", j), m0))
                out.append(alg.sub(W("V1", j), m1))

        # --- add/sub limb chains -------------------------------------------
        if sel is None or sel == 1:
            # add: V0 + V1 = RES + 2^256*car ; sub: RES + V1 = V0 + 2^256*car
            for j in range(NL):
                cin = W("CAR", j - 1) if j else None
                lhs_a = alg.add(W("V0", j), W("V1", j))
                lhs_s = alg.add(W("RES", j), W("V1", j))
                if cin is not None:
                    lhs_a = alg.add(lhs_a, cin)
                    lhs_s = alg.add(lhs_s, cin)
                rhs_a = alg.add(W("RES", j), alg.mul_int(W("CAR", j), 1 << L))
                rhs_s = alg.add(W("V0", j), alg.mul_int(W("CAR", j), 1 << L))
                out.append(alg.mul(op[OP_ADD], alg.sub(lhs_a, rhs_a)))
                out.append(alg.mul(op[OP_SUB], alg.sub(lhs_s, rhs_s)))

            # --- flags ----------------------------------------------------
            # eq is set from the RESULT by every ALU op (add/sub/div plus
            # stage D mul/and/or/xor/shl/shr — the interpreter's
            # `vm.flags.eq = r == 0`); lt is set by add (carry-out) and sub
            # (borrow), forced 0 by div, and PRESERVED by everything else.
            binop = alg.add(op[OP_ADD], op[OP_SUB])
            eqset = alg.add(binop, dv)
            for k in (OP_MUL, OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR):
                eqset = alg.add(eqset, op[k])
            ssum_res = W("RES", 0)
            for j in range(1, NL):
                ssum_res = alg.add(ssum_res, W("RES", j))
            # eq_new = 1 - S*SINV with S*eq_new == 0: S != 0 forces eq_new = 0,
            # S == 0 forces eq_new = 1 (limbs are u(L) so S == 0 <=> RES == 0);
            # for div RES is the quotient, so eq == (q == 0) — matching the
            # interpreter (incl. the div-by-zero case where q is forced 0)
            eq_new = _one_minus(alg, alg.mul(ssum_res, W("SINV")))
            out.append(alg.mul(eqset, alg.mul(ssum_res, eq_new)))
            carry_flag = alg.mul(eqset, alg.sub(Wn("EQF"), eq_new))
            out.append(alg.mul(notwrap, carry_flag))
            out.append(alg.mul(notwrap, alg.mul(binop,
                                                alg.sub(Wn("LTF"),
                                                        W("CAR", NL - 1)))))
            out.append(alg.mul(notwrap, alg.mul(dv, Wn("LTF"))))  # div: lt = 0
            keepf_eq = _one_minus(alg, alg.add(eqset, ext))
            keepf_lt = _one_minus(alg, alg.add(alg.add(binop, dv), ext))
            out.append(alg.mul(notwrap, alg.mul(
                keepf_eq, alg.sub(Wn("EQF"), W("EQF")))))
            out.append(alg.mul(notwrap, alg.mul(
                keepf_lt, alg.sub(Wn("LTF"), W("LTF")))))

        # --- register writeback --------------------------------------------
        if sel is None or sel == 2:
            # dst writes RES (quotient for div), dst2 (div only) writes REM;
            # every unselected register is PRESERVED — single-writeback rows
            # (OP_CTX: context/precompile results) leave only their one
            # destination oracle-provided.
            for i in range(NREGS):
                out.append(alg.mul(dst[i], dst2[i]))  # disjoint destinations
                for j in range(NL):
                    keep = _one_minus(alg, alg.add(dst[i], dst2[i]))
                    upd = alg.add(alg.add(alg.mul(dst[i], W("RES", j)),
                                          alg.mul(dst2[i], W("REM", j))),
                                  alg.mul(keep, W("REG", i * NL + j)))
                    out.append(alg.mul(notwrap, alg.mul(
                        notext, alg.sub(Wn("REG", i * NL + j), upd))))

        # --- div semantics (stage C) ---------------------------------------
        if sel is None or sel == 3:
            # dst2 appears exactly on div rows (one register)
            d2sum = dst2[0]
            for i in range(1, NREGS):
                d2sum = alg.add(d2sum, dst2[i])
            out.append(alg.sub(d2sum, dv))
            # div rows must select a quotient destination too
            dsum = dst[0]
            for i in range(1, NREGS):
                dsum = alg.add(dsum, dst[i])
            out.append(alg.mul(dv, alg.add_int(dsum, P - 1)))
            # zero-divisor flag: S1 = sum(V1 limbs); zb == (S1 == 0)
            s1sum = W("V1", 0)
            for j in range(1, NL):
                s1sum = alg.add(s1sum, W("V1", j))
            out.append(alg.mul(dv, alg.mul(s1sum, zb)))
            out.append(alg.mul(dv, alg.sub(zb, _one_minus(
                alg, alg.mul(s1sum, W("ZINV"))))))
            nzb = _one_minus(alg, zb)
            dvnz = alg.mul(dv, nzb)
            # --- unified limb-convolution identity (stage C div + stage D
            # mul/shl/shr). One gate block proves, with op-muxed operands:
            #   div:  RES(q)*V1   + REM == V0            (exact, no high part)
            #   shr:  RES(q)*POW2 + REM == V0            (exact, no high part)
            #   mul:  V0*V1   == RES + 2^256*REM(=hi)
            #   shl:  V0*POW2 == RES + 2^256*REM(=hi)
            # carries mc_k = MCL_k + 2^L*MCH_k (both lookup-checked). REM
            # serves as remainder on the q-side ops and as the discarded
            # high half on the product-side ops (disjoint by op).
            mulop, shlop, shrop = op[OP_MUL], op[OP_SHL], op[OP_SHR]
            shiftop = alg.add(shlop, shrop)
            qside = alg.add(dv, shrop)
            pside = alg.add(mulop, shlop)
            convsel = alg.add(alg.add(dvnz, mulop), shiftop)

            def A_(i):
                return alg.add(alg.mul(qside, W("RES", i)),
                               alg.mul(pside, W("V0", i)))

            def B_(j):
                return alg.add(alg.mul(alg.add(dv, mulop), W("V1", j)),
                               alg.mul(shiftop, W("POW2", j)))

            for k in range(2 * NL - 1):
                conv = None
                for i in range(max(0, k - NL + 1), min(NL, k + 1)):
                    tt = alg.mul(A_(i), B_(k - i))
                    conv = tt if conv is None else alg.add(conv, tt)
                lhs = conv
                if k < NL:
                    lhs = alg.add(lhs, alg.mul(qside, W("REM", k)))
                if k > 0:
                    mc_prev = alg.add(W("MCL", k - 1),
                                      alg.mul_int(W("MCH", k - 1), 1 << L))
                    lhs = alg.add(lhs, mc_prev)
                if k < NL:
                    rhs = alg.add(alg.mul(qside, W("V0", k)),
                                  alg.mul(pside, W("RES", k)))
                else:
                    rhs = alg.mul(pside, W("REM", k - NL))
                if k < 2 * NL - 2:
                    mc_k = alg.add(W("MCL", k),
                                   alg.mul_int(W("MCH", k), 1 << L))
                    rhs = alg.add(rhs, alg.mul_int(mc_k, 1 << L))
                out.append(alg.mul(convsel, alg.sub(lhs, rhs)))
            # div-by-zero forces q = r = 0 (eq flag follows from eq_new)
            for j in range(NL):
                out.append(alg.mul(dv, alg.mul(zb, W("RES", j))))
                out.append(alg.mul(dv, alg.mul(zb, W("REM", j))))
            # remainder range: REM + DIF + 1 == divisor exactly (borrow chain
            # with boolean DCAR, final carry zero) => REM < divisor, where
            # the divisor is V1 for div and POW2 for shr
            cmpsel = alg.add(dvnz, shrop)
            for j in range(NL):
                cin = W("DCAR", j - 1) if j else None
                lhs = alg.add(W("REM", j), W("DIF", j))
                if j == 0:
                    lhs = alg.add_int(lhs, 1)
                if cin is not None:
                    lhs = alg.add(lhs, cin)
                m_j = alg.add(alg.mul(dv, W("V1", j)),
                              alg.mul(shrop, W("POW2", j)))
                rhs = alg.add(m_j, alg.mul_int(W("DCAR", j), 1 << L))
                out.append(alg.mul(cmpsel, alg.sub(lhs, rhs)))
            out.append(alg.mul(cmpsel, W("DCAR", NL - 1)))

        # --- fat-pointer ops (stage C) --------------------------------------
        if sel is None or sel == 4:
            # layout (vm/interpreter.pack_fat_pointer): length bits 0..32,
            # start 32..64, page 64..96, bits 96..128 zero, metadata >= 128
            padd, pshr, ppck = op[OP_PADD], op[OP_PSHR], op[OP_PPACK]
            ptrw = alg.add(alg.add(padd, pshr), ppck)
            B32 = 32 // L
            ptrb = [W("PTRB", i) for i in range(NREGS)]
            for b in ptrb:
                out.append(alg.sub(alg.mul(b, b), b))
            # pointer source: the s0-selected register is tagged, never an imm
            src_tag = None
            for i in range(NREGS):
                t = alg.mul(s0[i], ptrb[i])
                src_tag = t if src_tag is None else alg.add(src_tag, t)
            out.append(alg.mul(ptrw, alg.add_int(src_tag, P - 1)))
            out.append(alg.mul(ptrw, s0i))
            shr = alg.add(padd, pshr)
            # delta fits 32 bits (interpreter requires delta <= length < 2^32)
            for j in range(B32, NL):
                out.append(alg.mul(shr, W("V1", j)))
            # length' = length - delta: RES[len] + V1 + borrow == V0[len]
            for j in range(B32):
                cin = W("CAR", j - 1) if j else None
                lhs = alg.add(W("RES", j), W("V1", j))
                if cin is not None:
                    lhs = alg.add(lhs, cin)
                rhs = alg.add(W("V0", j), alg.mul_int(W("CAR", j), 1 << L))
                out.append(alg.mul(shr, alg.sub(lhs, rhs)))
            out.append(alg.mul(shr, W("CAR", B32 - 1)))  # no underflow
            # start' = start + delta (padd) / start (pshr)
            for j in range(B32):
                cin = W("DCAR", j - 1) if j else None
                lhs = alg.add(W("V0", B32 + j), W("V1", j))
                if cin is not None:
                    lhs = alg.add(lhs, cin)
                rhs = alg.add(W("RES", B32 + j),
                              alg.mul_int(W("DCAR", j), 1 << L))
                out.append(alg.mul(padd, alg.sub(lhs, rhs)))
                out.append(alg.mul(pshr, alg.sub(W("RES", B32 + j),
                                                 W("V0", B32 + j))))
            out.append(alg.mul(padd, W("DCAR", B32 - 1)))  # no 32-bit overflow
            # page preserved, bits 96..128 zero, metadata >= 128 preserved
            for j in range(2 * B32, 3 * B32):
                out.append(alg.mul(shr, alg.sub(W("RES", j), W("V0", j))))
            for j in range(3 * B32, 4 * B32):
                out.append(alg.mul(shr, W("RES", j)))
            for j in range(4 * B32, NL):
                out.append(alg.mul(shr, alg.sub(W("RES", j), W("V0", j))))
            # ptr.pack: v1 low 128 bits must be zero; result = v1.hi | v0.lo
            for j in range(4 * B32):
                out.append(alg.mul(ppck, W("V1", j)))
                out.append(alg.mul(ppck, alg.sub(W("RES", j), W("V0", j))))
            for j in range(4 * B32, NL):
                out.append(alg.mul(ppck, alg.sub(W("RES", j), W("V1", j))))
            # pointer-tag writeback: ptr ops AND far-call/ret fat-pointer
            # writes (calldata in r1 / returndata in r1) tag their
            # destination, every other writing op clears it, unselected
            # registers carry their tag (EXT rows excluded like the values)
            tagw = alg.add(ptrw, alg.add(op[OP_FCALL], op[OP_FRET]))
            for i in range(NREGS):
                keep = _one_minus(alg, alg.add(dst[i], dst2[i]))
                upd = alg.add(alg.mul(dst[i], tagw), alg.mul(keep, ptrb[i]))
                out.append(alg.mul(notwrap, alg.mul(
                    notext, alg.sub(Wn("PTRB", i), upd))))

        # --- pc / ts chains -------------------------------------------------
        if sel is None or sel == 5:
            pc, tgt, eqf = W("PC"), W("TGT"), W("EQF")
            pc_seq = alg.add_int(pc, 1)
            # near calls enter their target; far calls enter the callee at
            # pc 0; the matching RET/FRET restores the return point through
            # the stack argument below
            s_jmp = alg.add(op[OP_JUMP], op[OP_NCALL])
            fcall = op[OP_FCALL]
            pc_next = alg.add(alg.mul(s_jmp, tgt),
                              alg.add(alg.mul(op[OP_JEQ],
                                              alg.add(alg.mul(eqf, tgt),
                                                      alg.mul(_one_minus(alg, eqf),
                                                              pc_seq))),
                                      alg.mul(_one_minus(alg,
                                                         alg.add(alg.add(
                                                             s_jmp, fcall),
                                                             op[OP_JEQ])),
                                              pc_seq)))
            # sequential chain applies to non-EXT rows that are not pops
            # (RET/RETP/FRET/FRETP and stage-G PANIC pin pc_next through
            # the stack unfold; HALT pins pc\' = pc below)
            pc_chained = _one_minus(alg, alg.add(
                alg.add(alg.add(ext, op[OP_HALT]), op[OP_PANIC]),
                alg.add(alg.add(op[OP_RET], op[OP_RETP]),
                        alg.add(op[OP_FRET], op[OP_FRETP]))))
            out.append(alg.mul(notwrap, alg.mul(v, alg.mul(
                pc_chained, alg.sub(Wn("PC"), pc_next)))))
            # the halt row freezes pc: the padding rows carry it into the
            # exit-boundary PI, so the proven block ends AT the halt
            out.append(alg.mul(notwrap, alg.mul(v, alg.mul(
                op[OP_HALT], alg.sub(Wn("PC"), pc)))))
            # padding rows carry pc so the boundary PI is pinned
            out.append(alg.mul(notwrap, alg.mul(_one_minus(alg, v),
                                                alg.sub(Wn("PC"), pc))))
            ts_step = alg.add(W("TS"), alg.mul_int(v, 2))
            out.append(alg.mul(notwrap, alg.sub(Wn("TS"), ts_step)))
            # validity only drops
            out.append(alg.mul(notwrap, alg.mul(_one_minus(alg, v), Wn("V"))))

            # --- fingerprints ----------------------------------------------------
            pch = [W("PCH", j) for j in range(NPOW)]
            for j in range(NPOW):
                out.append(alg.sub(Wn("PCH", j), pch[j]))
            for nm in ("GC", "GL", "GM", "GS"):
                out.append(alg.sub(Wn(nm), W(nm)))
            for j in range(NPOW - 1):
                out.append(alg.mul(first, alg.sub(pch[j + 1],
                                                  alg.mul(pch[j], pch[0]))))

            def horner(gate, acc_nm, gamma_nm, fields):
                t = None
                for j, f in enumerate(fields):
                    term = alg.mul(pch[j], f)
                    t = term if t is None else alg.add(t, term)
                upd = alg.add(alg.mul(W(acc_nm), W(gamma_nm)), t)
                out.append(alg.mul(notwrap, alg.mul(
                    gate, alg.sub(Wn(acc_nm), upd))))
                out.append(alg.mul(notwrap, alg.mul(
                    _one_minus(alg, gate), alg.sub(Wn(acc_nm), W(acc_nm)))))

            opid = None
            for k in range(NOPS):
                t = alg.mul_int(op[k], k + 1)
                opid = t if opid is None else alg.add(opid, t)
            dstid = None
            for i in range(NREGS):
                t = alg.mul_int(dst[i], i + 1)
                dstid = t if dstid is None else alg.add(dstid, t)
            dst2id = None
            for i in range(NREGS):
                t = alg.mul_int(dst2[i], i + 1)
                dst2id = t if dst2id is None else alg.add(dst2id, t)
            s0id = alg.mul_int(s0i, NREGS + 1)
            s1id = alg.mul_int(s1i, NREGS + 1)
            for i in range(NREGS):
                s0id = alg.add(s0id, alg.mul_int(s0[i], i + 1))
                s1id = alg.add(s1id, alg.mul_int(s1[i], i + 1))
            code_fields = ([W("PC"), opid,
                            alg.add(alg.add(dstid, alg.mul_int(s0id, 16)),
                                    alg.mul_int(dst2id, 512)),
                            alg.add(s1id, alg.mul_int(W("TGT"), 32)),
                            W("HDL")]
                           + [W("IMM0", j) for j in range(NL)]
                           + [W("IMM1", j) for j in range(NL)])
            horner(v, "AC", "GC", code_fields)

            s_log = None
            for k in _LOG_OPS:
                s_log = op[k] if s_log is None else alg.add(s_log, op[k])
            stor = op[OP_STOR]
            log_value = [alg.add(alg.mul(_one_minus(alg, stor), W("V1", j)),
                                 alg.mul(stor, W("RES", j))) for j in range(NL)]
            # address lanes bind WHICH context logged (the queue circuits'
            # encodings carry address/shard/tx; without these lanes a MainVM
            # proof could bind a different context's stream — ADVICE r2)
            log_fields = ([opid, W("TS"), W("ADR", 0), W("ADR", 1), W("ADR", 2)]
                          + [W("V0", j) for j in range(NL)] + log_value)
            horner(s_log, "AL", "GL", log_fields)

            s_mem = alg.add(op[OP_HEAPW], op[OP_HEAPR])
            heapr = op[OP_HEAPR]
            mem_value = [alg.add(alg.mul(_one_minus(alg, heapr), W("V1", j)),
                                 alg.mul(heapr, W("RES", j))) for j in range(NL)]
            # the page lane binds WHICH memory page (RAM-permutation encodings
            # sort by (page, index, timestamp))
            mem_fields = ([op[OP_HEAPW], W("TS"), W("PG")]
                          + [W("V0", j) for j in range(NL)] + mem_value)
            # stage F: IN-BOUNDS PtrRead rows fold a READ of (page, start +
            # offset) with the RES value into the SAME accumulator; the
            # index limbs live in REM (proven by the stage-F carry chain).
            # Three-way AM update replaces the two-way horner: heap op /
            # in-bounds pread / carry.
            pread_inb = alg.mul(op[OP_PREAD], _one_minus(alg, zb))
            t_mem = None
            for j, f in enumerate(mem_fields):
                term = alg.mul(pch[j], f)
                t_mem = term if t_mem is None else alg.add(t_mem, term)
            zero_lane = alg.mul_int(W("V"), 0)  # rw_flag = 0 (read)
            pr_fields = ([zero_lane, W("TS"), W("PG")]
                         + [W("REM", j) for j in range(NL)]
                         + [W("RES", j) for j in range(NL)])
            t_pr = None
            for j, f in enumerate(pr_fields):
                term = alg.mul(pch[j], f)
                t_pr = term if t_pr is None else alg.add(t_pr, term)
            am, am_n, gm = W("AM"), Wn("AM"), W("GM")
            out.append(alg.mul(notwrap, alg.mul(s_mem, alg.sub(
                am_n, alg.add(alg.mul(am, gm), t_mem)))))
            out.append(alg.mul(notwrap, alg.mul(pread_inb, alg.sub(
                am_n, alg.add(alg.mul(am, gm), t_pr)))))
            keep_m = _one_minus(alg, alg.add(s_mem, pread_inb))
            out.append(alg.mul(notwrap, alg.mul(keep_m,
                                                alg.sub(am_n, am))))

            # --- near-call stack argument (fold/unfold accumulator) ------------
            # push (NCALL): AS' = AS*GS + <ret_pc, handler, depth>; a pop row
            # must UNFOLD the matching tuple: AS = AS'*GS + <RPC, HDL, depth'>.
            # With the block-level balance requirement (AS returns to its seed,
            # DEPTH to zero) this is sound LIFO matching under Schwartz-Zippel:
            # mismatched tuples cannot cancel. RET pins pc' to the restored
            # return point, RETP to the popped frame's handler. Depth tags make
            # cross-level matches fail. (Reference: callstack as sponge-hashed
            # simulator state, circuit_encodings callstack_entry.rs:181.)
            # pushes: near calls AND far calls, with a FAR tag lane in the
            # folded tuple so near/far frames can never cross-match
            push = alg.add(op[OP_NCALL], fcall)
            popf = alg.add(spop, fpop)
            depth, depth_n = W("DEPTH"), Wn("DEPTH")
            as_, as_n = W("AS"), Wn("AS")
            gs = W("GS")
            t_push = alg.add(alg.add(alg.mul(pch[0], alg.add_int(pc, 1)),
                                     alg.mul(pch[3], fcall)),
                             alg.add(alg.mul(pch[1], W("HDL")),
                                     alg.mul(pch[2], depth)))
            out.append(alg.mul(notwrap, alg.mul(push, alg.sub(
                as_n, alg.add(alg.mul(as_, gs), t_push)))))
            out.append(alg.mul(notwrap, alg.mul(push, alg.sub(
                depth_n, alg.add_int(depth, 1)))))
            t_pop = alg.add(alg.add(alg.mul(pch[0], W("RPC")),
                                    alg.mul(pch[3], fpop)),
                            alg.add(alg.mul(pch[1], W("PHD")),
                                    alg.mul(pch[2], depth_n)))
            out.append(alg.mul(notwrap, alg.mul(popf, alg.sub(
                as_, alg.add(alg.mul(as_n, gs), t_pop)))))
            out.append(alg.mul(notwrap, alg.mul(popf, alg.sub(
                alg.add_int(depth_n, 1), depth))))
            keep_s = _one_minus(alg, alg.add(push, popf))
            out.append(alg.mul(notwrap, alg.mul(keep_s, alg.sub(as_n, as_))))
            out.append(alg.mul(notwrap, alg.mul(keep_s,
                                                alg.sub(depth_n, depth))))
            # pop pc semantics (near and far)
            out.append(alg.mul(notwrap, alg.mul(op[OP_RET],
                                                alg.sub(Wn("PC"), W("RPC")))))
            out.append(alg.mul(notwrap, alg.mul(op[OP_RETP],
                                                alg.sub(Wn("PC"), W("PHD")))))
            out.append(alg.mul(notwrap, alg.mul(op[OP_FRET],
                                                alg.sub(Wn("PC"), W("RPC")))))
            out.append(alg.mul(notwrap, alg.mul(op[OP_FRETP],
                                                alg.sub(Wn("PC"), W("PHD")))))
            # stage G: a panic unwind resumes the parent at the popped
            # frame's exception handler (interpreter._unwind_panic)
            out.append(alg.mul(notwrap, alg.mul(op[OP_PANIC],
                                                alg.sub(Wn("PC"), W("PHD")))))

        # --- stage D: bitwise chunks + dynamic-shift machinery --------------
        if sel is None or sel == 6:
            CH = geo.bw_chunks_per_limb
            cbits = geo.bw_chunk_bits
            andop, orop, xorop = op[OP_AND], op[OP_OR], op[OP_XOR]
            shlop, shrop = op[OP_SHL], op[OP_SHR]
            bw = alg.add(alg.add(andop, orop), xorop)
            shiftop = alg.add(shlop, shrop)
            # chunk recomposition binds the looked-up (a, b, a^b) triples to
            # the operand limbs; and/or derive from xor via
            # a + b = (a^b) + 2*(a&b) and a|b = (a^b) + (a&b), i.e.
            # 2*and = s0 + s1 - x and 2*or = s0 + s1 + x — no extra tables.
            for j in range(NL):
                s0sum = s1sum = xsum = None
                for i in range(CH):
                    w0 = alg.mul_int(W("B0", j * CH + i), 1 << (cbits * i))
                    w1 = alg.mul_int(W("B1", j * CH + i), 1 << (cbits * i))
                    wx = alg.mul_int(W("BX", j * CH + i), 1 << (cbits * i))
                    s0sum = w0 if s0sum is None else alg.add(s0sum, w0)
                    s1sum = w1 if s1sum is None else alg.add(s1sum, w1)
                    xsum = wx if xsum is None else alg.add(xsum, wx)
                out.append(alg.mul(bw, alg.sub(W("V0", j), s0sum)))
                out.append(alg.mul(bw, alg.sub(W("V1", j), s1sum)))
                out.append(alg.mul(xorop, alg.sub(W("RES", j), xsum)))
                both = alg.add(s0sum, s1sum)
                out.append(alg.mul(andop, alg.sub(
                    alg.mul_int(W("RES", j), 2), alg.sub(both, xsum))))
                out.append(alg.mul(orop, alg.sub(
                    alg.mul_int(W("RES", j), 2), alg.add(both, xsum))))
            # shifts: s = v1 & 0xFF decomposes as s = L*q + t with one-hot
            # limb shift LS_q and intra-limb shift BS_t; POW2 = 2^s as limbs
            # (POW2_j = LS_j * 2^t) feeds the shared convolution identity.
            NSH = 256 // L
            ls = [W("LS", k) for k in range(NSH)]
            bs = [W("BS", t) for t in range(L)]
            lsum = ls[0]
            for x in ls[1:]:
                lsum = alg.add(lsum, x)
            bsum = bs[0]
            for x in bs[1:]:
                bsum = alg.add(bsum, x)
            out.append(alg.sub(lsum, shiftop))
            out.append(alg.sub(bsum, shiftop))
            tp = None
            for t in range(L):
                term = alg.mul_int(bs[t], 1 << t)
                tp = term if tp is None else alg.add(tp, term)
            for j in range(NL):
                out.append(alg.sub(W("POW2", j), alg.mul(ls[j], tp)))
            # v1 limb 0 = its chunk decomposition; s = the low 8 bits of it
            vbsum = None
            s_lo = None
            for i in range(CH):
                term = alg.mul_int(W("VBC", i), 1 << (cbits * i))
                vbsum = term if vbsum is None else alg.add(vbsum, term)
                if cbits * i < 8:
                    s_lo = term if s_lo is None else alg.add(s_lo, term)
            out.append(alg.mul(shiftop, alg.sub(W("V1", 0), vbsum)))
            s_sel = None
            for k in range(NSH):
                term = alg.mul_int(ls[k], L * k)
                s_sel = term if s_sel is None else alg.add(s_sel, term)
            for t in range(L):
                s_sel = alg.add(s_sel, alg.mul_int(bs[t], t))
            out.append(alg.mul(shiftop, alg.sub(s_sel, s_lo)))

            # --- stage F: fat-pointer read binding ---------------------------
            pread = op[OP_PREAD]
            B32 = 32 // L
            # source must be a TAGGED pointer register, never an immediate
            ptrb6 = [W("PTRB", i) for i in range(NREGS)]
            s0_6 = [W("S0SEL", i) for i in range(NREGS)]
            src_tag6 = None
            for i in range(NREGS):
                t6 = alg.mul(s0_6[i], ptrb6[i])
                src_tag6 = t6 if src_tag6 is None else alg.add(src_tag6, t6)
            out.append(alg.mul(pread, alg.add_int(src_tag6, P - 1)))
            out.append(alg.mul(pread, W("S0IMM")))
            # page lane = the pointer's page segment (bits 64..96)
            pg_sum = None
            for k in range(B32):
                t6 = alg.mul_int(W("V0", 2 * B32 + k), 1 << (L * k))
                pg_sum = t6 if pg_sum is None else alg.add(pg_sum, t6)
            out.append(alg.mul(pread, alg.sub(W("PG"), pg_sum)))
            # zh = [offset has nonzero high limbs] via an inverse gadget
            s_hi = None
            for k in range(B32, NL):
                s_hi = W("V1", k) if s_hi is None else alg.add(s_hi,
                                                               W("V1", k))
            zh = alg.mul(s_hi, W("ZINV"))
            out.append(alg.mul(pread, alg.mul(s_hi, _one_minus(alg, zh))))
            inb = alg.mul(pread, _one_minus(alg, zb))
            # in-bounds: the offset fits 32 bits...
            for k in range(B32, NL):
                out.append(alg.mul(inb, W("V1", k)))
            # ...index = start + offset with a boolean carry chain into REM
            for j in range(B32):
                cin = W("CAR", j - 1) if j else None
                lhs = alg.add(W("V0", B32 + j), W("V1", j))
                if cin is not None:
                    lhs = alg.add(lhs, cin)
                rhs = alg.add(W("REM", j), alg.mul_int(W("CAR", j), 1 << L))
                out.append(alg.mul(inb, alg.sub(lhs, rhs)))
            out.append(alg.mul(inb, alg.sub(W("REM", B32),
                                            W("CAR", B32 - 1))))
            for k in range(B32 + 1, NL):
                out.append(alg.mul(inb, W("REM", k)))
            # high DIF limbs unused on pread rows
            for k in range(B32, NL):
                out.append(alg.mul(pread, W("DIF", k)))
            # in-bounds: offset + DIF + 1 == length (=> offset < length)
            for j in range(B32):
                cin = W("DCAR", j - 1) if j else None
                lhs = alg.add(W("V1", j), W("DIF", j))
                if j == 0:
                    lhs = alg.add_int(lhs, 1)
                if cin is not None:
                    lhs = alg.add(lhs, cin)
                rhs = alg.add(W("V0", j), alg.mul_int(W("DCAR", j), 1 << L))
                out.append(alg.mul(inb, alg.sub(lhs, rhs)))
            out.append(alg.mul(inb, W("DCAR", B32 - 1)))
            # out-of-bounds with a 32-bit offset: length + DIF == offset
            # (=> offset >= length); a nonzero high offset (zh = 1) is
            # out-of-bounds by itself
            oobl = alg.mul(alg.mul(pread, zb), _one_minus(alg, zh))
            for j in range(B32):
                cin = W("DCAR", j - 1) if j else None
                lhs = alg.add(W("V0", j), W("DIF", j))
                if cin is not None:
                    lhs = alg.add(lhs, cin)
                rhs = alg.add(W("V1", j), alg.mul_int(W("DCAR", j), 1 << L))
                out.append(alg.mul(oobl, alg.sub(lhs, rhs)))
            out.append(alg.mul(oobl, W("DCAR", B32 - 1)))
            # out-of-bounds reads yield ZERO (the interpreter's semantics)
            for j in range(NL):
                out.append(alg.mul(pread, alg.mul(zb, W("RES", j))))
        return out

    import functools as _ft
    _parts = tuple(_ft.partial(_gates, sel=k) for k in range(7))

    def eval_gates(alg, w, w_next, c):
        return _gates(alg, w, w_next, c, sel=None)

    # per-part constraint counts, probed once with a host algebra over
    # dummy values (keeps the alpha-power layout and num_gate_constraints
    # in exact sync with the emitted gates — no hand-maintained formula
    # drift)
    class _CountAlg:
        def add(self, a, b):
            return 0

        sub = mul = add
        def mul_int(self, a, c):
            return 0

        add_int = mul_int

    _dummy_w = [0] * off["_width"]
    _dummy_c = [0] * NUM_CONST
    _ca = _CountAlg()
    part_counts = tuple(len(pf(_ca, _dummy_w, _dummy_w, _dummy_c))
                        for pf in _parts)

    n_constraints = (
        (NOPS + 4 * NREGS + 8 + 2 * NL)  # booleans (+spop+fpop+zb+dst2+dcar)
        + (256 // L) + L                  # LS/BS shift-selector booleans
        + 7 + 2                           # pop/push exclusivity (near+far)
                                          # + stage G panic pop/no-dst
        + 1 + 3                           # op sum + selector sums
        + 2 * NL                          # muxes
        + 2 * NL                          # add/sub chains
        + 6                               # flags (+div lt-zero)
        + NREGS * NL + NREGS              # writeback + dst/dst2 disjoint
        + 2 + 2                           # dst2 sum, div dst sum, zb gadget
        + (2 * NL - 1)                    # unified convolution limbs
        + 2 * NL                          # div-by-zero forcing
        + NL + 1                          # remainder compare chain
        + 2 * NREGS + 3 * NL + 4 * (32 // L) + 4  # ptr ops + PTRB file
        + 5                               # pc (+pad carry, halt pin), ts, validity
        + NPOW + 4 + (NPOW - 1)           # fp constancy (4 gammas) + chain
        + 6                               # 3 accumulators x (update+carry)
        + 10 + 1                          # stack push/pop/carry + pop pc
                                          # + stage G panic pc pin
        + 6 * NL + 4                      # stage D bitwise chunks + shifts
        + 4 * NL + 6                      # stage F pread binding (part 6)
        + 1)                              # stage F 3-way AM update (part 5)
    assert sum(part_counts) == n_constraints, (part_counts, n_constraints)

    pis: List[Tuple[int, int]] = [
        (off["PCH"], 0), (off["GC"], 0), (off["GL"], 0), (off["GM"], 0),
        (off["GS"], 0),
        (off["AC"], 0), (off["AC"], n - 1),
        (off["AL"], 0), (off["AL"], n - 1),
        (off["AM"], 0), (off["AM"], n - 1),
        (off["AS"], 0), (off["AS"], n - 1),
        (off["DEPTH"], 0), (off["DEPTH"], n - 1),
        (off["PC"], 0), (off["PC"], n - 1),
        (off["TS"], 0), (off["TS"], n - 1),
        (off["V"], 0),
        (off["EQF"], 0), (off["LTF"], 0),
    ]
    for i in range(NREGS):
        for j in range(NL):
            pis.append((off["REG"] + i * NL + j, 0))
    for i in range(NREGS):
        for j in range(NL):
            pis.append((off["REG"] + i * NL + j, n - 1))
    # pointer-tag boundaries (snapshot FSM covers tags like values)
    for i in range(NREGS):
        pis.append((off["PTRB"] + i, 0))
    for i in range(NREGS):
        pis.append((off["PTRB"] + i, n - 1))

    table = np.arange(1 << L, dtype=object).reshape(-1, 1)
    lookup_cols = ([off["RES"] + j for j in range(NL)]
                   + [off["REM"] + j for j in range(NL)]
                   + [off["DIF"] + j for j in range(NL)]
                   + [off["MCL"] + k for k in range(2 * NL - 2)]
                   + [off["MCH"] + k for k in range(2 * NL - 2)])
    lookup_sets = [(0, (c,)) for c in lookup_cols]
    # stage D: the (a, b, a^b) chunk table — one table proves xor AND the
    # c-bit ranges of all three chunk columns; and/or derive in-gates
    cbits = geo.bw_chunk_bits
    CH = geo.bw_chunks_per_limb
    xor_table = np.zeros(((1 << (2 * cbits)), 3), dtype=object)
    idx = 0
    for a in range(1 << cbits):
        for bvv in range(1 << cbits):
            xor_table[idx] = (a, bvv, a ^ bvv)
            idx += 1
    chunk_table = np.arange(1 << cbits, dtype=object).reshape(-1, 1)
    for k in range(NL * CH):
        lookup_sets.append((1, (off["B0"] + k, off["B1"] + k,
                                off["BX"] + k)))
    for i in range(CH):
        lookup_sets.append((2, (off["VBC"] + i,)))

    # stratify: derived part degrees (2,4,4,6,4,6,5) put only two parts on
    # the full 8-coset domain; everything else (incl. the full-width copy
    # NTTs) runs on <= 4 cosets — proofs bit-identical (plonkish.stratify)
    return pk.stratify(pk.PlonkishIR(
        log_n=geo.log_n, num_witness=off["_width"], num_const=NUM_CONST,
        gate_degree=6, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis),
        lookup_tables=(table, xor_table, chunk_table),
        lookup_sets=tuple(lookup_sets),
        eval_gates_parts=_parts, gate_part_counts=part_counts))


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


def _const_rows(geo: VmGeometry) -> np.ndarray:
    n = geo.n
    rows = np.zeros((n, NUM_CONST), dtype=object)
    rows[n - 1, K_WRAP] = 1
    rows[0, K_FIRST] = 1
    return rows


def main_vm_setup(ir: pk.PlonkishIR, geo: VmGeometry,
                  cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    const = _const_rows(geo).T
    return pk.build_setup(ir, const, pk.CopyWiring.identity(), cfg,
                          device=device)


# ---------------------------------------------------------------------------
# Witness generation (consumes witness/main_vm.py row payloads)
# ---------------------------------------------------------------------------

def _limbs(v: int, NL: int, L: int) -> List[int]:
    assert 0 <= int(v) < (1 << (NL * L)), "value exceeds register width"
    return [(int(v) >> (L * i)) & ((1 << L) - 1) for i in range(NL)]


def _addr_lanes(addr: int) -> List[int]:
    """A 160-bit address as 3 Goldilocks lanes (54 bits each) — must match
    witness.main_vm._addr_lanes."""
    m = (1 << 54) - 1
    a = int(addr)
    return [(a >> (54 * i)) & m for i in range(3)]


def main_vm_witness(ir: pk.PlonkishIR, geo: VmGeometry, inst,
                    device=None) -> gl.GF:
    """inst: witness.main_vm.VmCircuitInstance. The trace is filled on the
    host (numpy uint64) and handed to `device` in one copy; `None` means the
    CUDA card."""
    device = gl.resolve_device(device)
    NL, L = geo.num_limbs, geo.limb_bits
    n = geo.n
    off = _cols(geo)
    NPOW = 6 + 2 * NL
    # uint64 (all values canonical < P): gl.from_int's vectorized path skips
    # per-element boxing — the object-dtype fill was ~10 s per instance
    W = np.zeros((ir.num_witness, n), dtype=np.uint64)

    ch = int(inst.challenge) % P
    pw = ch
    for j in range(NPOW):
        W[off["PCH"] + j, :] = pw
        pw = pw * ch % P
    for nm, val in (("GC", inst.gamma_code), ("GL", inst.gamma_log),
                    ("GM", inst.gamma_mem), ("GS", inst.gamma_stack)):
        W[off[nm], :] = int(val) % P

    accs = [int(a) % P for a in inst.acc_in]  # code, log, mem, stack
    gammas = [int(inst.gamma_code) % P, int(inst.gamma_log) % P,
              int(inst.gamma_mem) % P, int(inst.gamma_stack) % P]
    gs_inv = pow(gammas[3], P - 2, P)
    pows = [int(v) for v in
            [pow(ch, j + 1, P) for j in range(NPOW)]]

    def fields_fold(fields):
        t = 0
        for j, f in enumerate(fields):
            t = (t + pows[j] * (int(f) % P)) % P
        return t

    def fold(which, fields):
        accs[which] = (accs[which] * gammas[which]
                       + fields_fold(fields)) % P

    depth = int(inst.depth_in)
    rows = inst.rows
    assert len(rows) <= n
    for r in range(len(rows)):
        W[off["AC"], r] = accs[0]
        W[off["AL"], r] = accs[1]
        W[off["AM"], r] = accs[2]
        W[off["AS"], r] = accs[3]
        W[off["DEPTH"], r] = depth
        if True:
            row = rows[r]
            for i in range(NREGS):
                W[off["REG"] + i * NL:off["REG"] + (i + 1) * NL, r] = \
                    _limbs(row.regs[i], NL, L)
            W[off["PC"], r] = row.pc
            W[off["TS"], r] = row.ts
            for i, tag in enumerate(row.ptrs or (False,) * NREGS):
                W[off["PTRB"] + i, r] = 1 if tag else 0
            W[off["EQF"], r] = 1 if row.flags[0] else 0
            W[off["LTF"], r] = 1 if row.flags[1] else 0
            W[off["OP"] + row.op, r] = 1
            if row.dst:
                W[off["DST"] + row.dst - 1, r] = 1
            for (kind, val, selnm, immnm, imflag) in (
                    (row.s0_kind, row.s0_val, "S0SEL", "IMM0", "S0IMM"),
                    (row.s1_kind, row.s1_val, "S1SEL", "IMM1", "S1IMM")):
                if kind == "imm":
                    W[off[imflag], r] = 1
                    W[off[immnm]:off[immnm] + NL, r] = _limbs(val, NL, L)
                elif kind == "reg" and val:
                    W[off[selnm] + val - 1, r] = 1
            W[off["TGT"], r] = row.tgt
            W[off["HDL"], r] = row.handler
            W[off["RPC"], r] = row.pop_ret_pc
            W[off["PHD"], r] = row.pop_handler
            W[off["SPOP"], r] = 1 if row.spop else 0
            W[off["FPOP"], r] = 1 if row.fpop else 0
            v0 = row.v0 & ((1 << (NL * L)) - 1)
            v1 = row.v1 & ((1 << (NL * L)) - 1)
            W[off["V0"]:off["V0"] + NL, r] = _limbs(v0, NL, L)
            W[off["V1"]:off["V1"] + NL, r] = _limbs(v1, NL, L)
            res = int(row.res) & ((1 << (NL * L)) - 1)
            res_l = _limbs(res, NL, L)
            W[off["RES"]:off["RES"] + NL, r] = res_l
            if row.op in (OP_ADD, OP_SUB):
                v0l, v1l = _limbs(v0, NL, L), _limbs(v1, NL, L)
                cin = 0
                for j in range(NL):
                    if row.op == OP_ADD:
                        t = v0l[j] + v1l[j] + cin          # = res + 2^L*cout
                    else:
                        t = res_l[j] + v1l[j] + cin        # = v0 + 2^L*cout
                    base = res_l[j] if row.op == OP_ADD else v0l[j]
                    cout, rem = divmod(t - base, 1 << L)
                    assert rem == 0 and cout in (0, 1), "carry chain broke"
                    W[off["CAR"] + j, r] = cout
                    cin = cout
                S = sum(res_l)
                W[off["SINV"], r] = pow(S, P - 2, P) if S else 0
            elif row.op in (OP_PADD, OP_PSHR):
                v1l = _limbs(v1, NL, L)
                res_full = int(row.res)
                res_lf = _limbs(res_full, NL, L)
                v0l = _limbs(v0, NL, L)
                B32 = 32 // L
                # length borrow chain: RES[len] + V1 + b = V0[len]
                cin = 0
                for j in range(B32):
                    t = res_lf[j] + v1l[j] + cin
                    cout, rr = divmod(t - v0l[j], 1 << L)
                    assert rr == 0 and cout in (0, 1)
                    W[off["CAR"] + j, r] = cout
                    cin = cout
                assert cin == 0, "ptr length underflow"
                if row.op == OP_PADD:
                    cin = 0
                    for j in range(B32):
                        t = v0l[B32 + j] + v1l[j] + cin
                        cout, rr = divmod(t - res_lf[B32 + j], 1 << L)
                        assert rr == 0 and cout in (0, 1)
                        W[off["DCAR"] + j, r] = cout
                        cin = cout
                    assert cin == 0, "ptr start overflow"
            elif row.op == OP_DIV:
                assert row.dst2, "div needs a remainder destination"
                W[off["DST2"] + row.dst2 - 1, r] = 1
                q, b_val, rm = int(row.res), v1, int(row.rem)
                v0l, v1l = _limbs(v0, NL, L), _limbs(b_val, NL, L)
                q_l, r_l2 = _limbs(q, NL, L), _limbs(rm, NL, L)
                W[off["REM"]:off["REM"] + NL, r] = r_l2
                S = sum(q_l)
                W[off["SINV"], r] = pow(S, P - 2, P) if S else 0
                S1 = sum(v1l)
                W[off["ZB"], r] = 1 if S1 == 0 else 0
                W[off["ZINV"], r] = pow(S1, P - 2, P) if S1 else 0
                if b_val != 0:
                    assert q * b_val + rm == v0 and rm < b_val
                    # mul-identity carries
                    mc_prev = 0
                    for k in range(2 * NL - 1):
                        conv = sum(q_l[i] * v1l[k - i]
                                   for i in range(max(0, k - NL + 1),
                                                  min(NL, k + 1)))
                        lhs = conv + (r_l2[k] if k < NL else 0) + mc_prev
                        base = v0l[k] if k < NL else 0
                        if k < 2 * NL - 2:
                            mc, rr = divmod(lhs - base, 1 << L)
                            assert rr == 0 and 0 <= mc < (NL + 1) << L
                            W[off["MCL"] + k, r] = mc & ((1 << L) - 1)
                            W[off["MCH"] + k, r] = mc >> L
                            mc_prev = mc
                        else:
                            assert lhs == base, "mul identity broke"
                    # remainder compare: REM + DIF + 1 == V1
                    dif = b_val - rm - 1
                    dif_l = _limbs(dif, NL, L)
                    W[off["DIF"]:off["DIF"] + NL, r] = dif_l
                    cin = 1
                    for j in range(NL):
                        t = r_l2[j] + dif_l[j] + cin
                        cout, rr = divmod(t - v1l[j], 1 << L)
                        assert rr == 0 and cout in (0, 1)
                        W[off["DCAR"] + j, r] = cout
                        cin = cout
                    assert cin == 0, "remainder compare overflowed"
            elif row.op in (OP_MUL, OP_SHL, OP_SHR):
                # stage D: shared convolution identity witnesses
                full_mask = (1 << (NL * L)) - 1
                if row.op in (OP_SHL, OP_SHR):
                    s = v1 & 0xFF
                    pow2 = 1 << s
                    W[off["LS"] + s // L, r] = 1
                    W[off["BS"] + s % L, r] = 1
                    p2l = _limbs(pow2, NL, L)
                    for j in range(NL):
                        W[off["POW2"] + j, r] = p2l[j]
                    cbits = geo.bw_chunk_bits
                    CH = geo.bw_chunks_per_limb
                    limb0 = v1 & ((1 << L) - 1)
                    for i in range(CH):
                        W[off["VBC"] + i, r] = \
                            (limb0 >> (cbits * i)) & ((1 << cbits) - 1)
                if row.op == OP_MUL:
                    a_int, b_int, c_add, low_int = v0, v1, 0, res
                    hi = (v0 * v1) >> (NL * L)
                elif row.op == OP_SHL:
                    a_int, b_int, c_add, low_int = v0, pow2, 0, res
                    hi = (v0 * pow2) >> (NL * L)
                else:  # shr: q*2^s + rem == v0 exactly
                    rem_v = v0 & (pow2 - 1)
                    a_int, b_int, c_add, low_int = res, pow2, rem_v, v0
                    hi = None
                    rem_l = _limbs(rem_v, NL, L)
                    for j in range(NL):
                        W[off["REM"] + j, r] = rem_l[j]
                    # remainder compare vs POW2: REM + DIF + 1 == POW2
                    dif = pow2 - rem_v - 1
                    dif_l = _limbs(dif, NL, L)
                    cin = 1
                    for j in range(NL):
                        W[off["DIF"] + j, r] = dif_l[j]
                        t = rem_l[j] + dif_l[j] + cin
                        cout, rr = divmod(t - p2l[j], 1 << L)
                        assert rr == 0 and cout in (0, 1)
                        W[off["DCAR"] + j, r] = cout
                        cin = cout
                    assert cin == 0, "shr remainder compare overflowed"
                if hi is not None:
                    hi_l = _limbs(hi & full_mask, NL, L)
                    for j in range(NL):
                        W[off["REM"] + j, r] = hi_l[j]
                a_l = _limbs(a_int & full_mask, NL, L)
                b_l = _limbs(b_int & full_mask, NL, L)
                low_l = _limbs(low_int & full_mask, NL, L)
                addc_l = _limbs(c_add & full_mask, NL, L)
                mc_prev = 0
                for k in range(2 * NL - 1):
                    conv = sum(a_l[i] * b_l[k - i]
                               for i in range(max(0, k - NL + 1),
                                              min(NL, k + 1)))
                    lhs = conv + mc_prev
                    if k < NL and row.op == OP_SHR:
                        lhs += addc_l[k]
                    if k < NL:
                        base = (low_l[k] if row.op == OP_SHR
                                else _limbs(res & full_mask, NL, L)[k])
                    else:
                        base = (0 if row.op == OP_SHR
                                else _limbs(hi & full_mask, NL, L)[k - NL])
                    if k < 2 * NL - 2:
                        mc, rr = divmod(lhs - base, 1 << L)
                        assert rr == 0 and 0 <= mc < (NL + 1) << L, \
                            "stage-D conv carry out of range"
                        W[off["MCL"] + k, r] = mc & ((1 << L) - 1)
                        W[off["MCH"] + k, r] = mc >> L
                        mc_prev = mc
                    else:
                        assert lhs == base, "stage-D conv identity broke"
                S = sum(_limbs(res & full_mask, NL, L))
                W[off["SINV"], r] = pow(S, P - 2, P) if S else 0
            elif row.op in (OP_AND, OP_OR, OP_XOR):
                cbits = geo.bw_chunk_bits
                CH = geo.bw_chunks_per_limb
                cm = (1 << cbits) - 1
                xr = v0 ^ v1
                for j in range(NL):
                    for i in range(CH):
                        sh = L * j + cbits * i
                        W[off["B0"] + j * CH + i, r] = (v0 >> sh) & cm
                        W[off["B1"] + j * CH + i, r] = (v1 >> sh) & cm
                        W[off["BX"] + j * CH + i, r] = (xr >> sh) & cm
                S = sum(res_l)
                W[off["SINV"], r] = pow(S, P - 2, P) if S else 0
            W[off["V"], r] = 1
            # fingerprints
            opid = row.op + 1
            dstid = row.dst
            s0id = (NREGS + 1 if row.s0_kind == "imm"
                    else (row.s0_val if row.s0_kind == "reg" else 0))
            s1id = (NREGS + 1 if row.s1_kind == "imm"
                    else (row.s1_val if row.s1_kind == "reg" else 0))
            imm0 = row.s0_val if row.s0_kind == "imm" else 0
            imm1 = row.s1_val if row.s1_kind == "imm" else 0
            code_fields = ([row.pc, opid, dstid + 16 * s0id + 512 * row.dst2,
                            s1id + 32 * row.tgt, row.handler]
                           + _limbs(imm0, NL, L) + _limbs(imm1, NL, L))
            fold(0, code_fields)
            if row.op in (OP_STOW, OP_STOR, OP_EVT, OP_EVTL1):
                value = res if row.op == OP_STOR else v1
                adr = _addr_lanes(row.addr)
                W[off["ADR"]:off["ADR"] + 3, r] = adr
                fold(1, [opid, row.ts] + adr + _limbs(v0, NL, L)
                     + _limbs(value, NL, L))
            if row.op in (OP_HEAPW, OP_HEAPR):
                value = res if row.op == OP_HEAPR else v1
                W[off["PG"], r] = int(row.page) % P
                fold(2, [1 if row.op == OP_HEAPW else 0, row.ts,
                         int(row.page)]
                     + _limbs(v0, NL, L) + _limbs(value, NL, L))
            if row.op == OP_PREAD:
                # stage F: page/index/compare witnesses + the mem fold
                B32 = 32 // L
                length = v0 & 0xFFFFFFFF
                start = (v0 >> 32) & 0xFFFFFFFF
                v0l = _limbs(v0, NL, L)
                off_l = _limbs(v1, NL, L)
                W[off["PG"], r] = int(row.page) % P
                s_hi = sum(off_l[B32:])
                W[off["ZINV"], r] = pow(s_hi, P - 2, P) if s_hi else 0
                oob = not (v1 < length)
                W[off["ZB"], r] = 1 if oob else 0
                if not oob:
                    idx = start + v1
                    idx_l = _limbs(idx, NL, L)
                    for j in range(NL):
                        W[off["REM"] + j, r] = idx_l[j]
                    cin = 0
                    for j in range(B32):
                        t = v0l[B32 + j] + off_l[j] + cin
                        cout, rr = divmod(t - idx_l[j], 1 << L)
                        assert rr == 0 and cout in (0, 1)
                        W[off["CAR"] + j, r] = cout
                        cin = cout
                    assert idx_l[B32] == cin, "pread index carry broke"
                    dif = length - v1 - 1
                    dif_l = _limbs(dif, NL, L)
                    cin = 1
                    for j in range(B32):
                        W[off["DIF"] + j, r] = dif_l[j]
                        t = off_l[j] + dif_l[j] + cin
                        cout, rr = divmod(t - v0l[j], 1 << L)
                        assert rr == 0 and cout in (0, 1)
                        W[off["DCAR"] + j, r] = cout
                        cin = cout
                    assert cin == 0, "pread bound compare broke"
                    fold(2, [0, row.ts, int(row.page)] + idx_l
                         + _limbs(res, NL, L))
                elif s_hi == 0:
                    # low offset >= length: length + DIF == offset
                    dif = v1 - length
                    dif_l = _limbs(dif, NL, L)
                    cin = 0
                    for j in range(B32):
                        W[off["DIF"] + j, r] = dif_l[j]
                        t = v0l[j] + dif_l[j] + cin
                        cout, rr = divmod(t - off_l[j], 1 << L)
                        assert rr == 0 and cout in (0, 1)
                        W[off["DCAR"] + j, r] = cout
                        cin = cout
                    assert cin == 0, "pread oob compare broke"
            if row.op in (OP_NCALL, OP_FCALL):
                fold(3, [row.pc + 1, row.handler, depth,
                         1 if row.op == OP_FCALL else 0])
                depth += 1
            elif row.spop or row.fpop:
                depth -= 1
                t = fields_fold([row.pop_ret_pc, row.pop_handler, depth,
                                 1 if row.fpop else 0])
                accs[3] = (accs[3] - t) * gs_inv % P
    # padding rows carry the exit state — one broadcast per column instead
    # of a per-row python loop over the (n - len(rows)) tail
    pad = slice(len(rows), n)
    W[off["AC"], pad] = accs[0]
    W[off["AL"], pad] = accs[1]
    W[off["AM"], pad] = accs[2]
    W[off["AS"], pad] = accs[3]
    W[off["DEPTH"], pad] = int(inst.depth_out)
    for i in range(NREGS):
        limbs_i = _limbs(inst.exit_regs[i], NL, L)
        for j in range(NL):
            W[off["REG"] + i * NL + j, pad] = limbs_i[j]
    W[off["PC"], pad] = inst.exit_pc
    W[off["TS"], pad] = inst.exit_ts
    for i, tag in enumerate(getattr(inst, "exit_ptrs", (False,) * NREGS)):
        W[off["PTRB"] + i, pad] = 1 if tag else 0
    W[off["EQF"], pad] = 1 if inst.exit_flags[0] else 0
    W[off["LTF"], pad] = 1 if inst.exit_flags[1] else 0
    return gl.from_int(W, device)


def expected_public_inputs(geo: VmGeometry, inst) -> List[int]:
    """PI vector matching main_vm_ir's cell order, computed host-side."""
    from ..witness.main_vm import replay_accumulators
    NL, L = geo.num_limbs, geo.limb_bits
    acc_out = replay_accumulators(geo, inst)
    out = [int(inst.challenge) % P, int(inst.gamma_code) % P,
           int(inst.gamma_log) % P, int(inst.gamma_mem) % P,
           int(inst.gamma_stack) % P]
    for a_in, a_out in zip(inst.acc_in, acc_out):
        out += [int(a_in) % P, int(a_out) % P]
    out += [int(inst.depth_in), int(inst.depth_out)]
    first = inst.rows[0] if inst.rows else None
    out += [first.pc if first else inst.exit_pc,
            inst.exit_pc,
            first.ts if first else inst.exit_ts,
            inst.exit_ts,
            1 if inst.rows else 0,
            (1 if first.flags[0] else 0) if first else
            (1 if inst.exit_flags[0] else 0),
            (1 if first.flags[1] else 0) if first else
            (1 if inst.exit_flags[1] else 0)]
    entry_regs = inst.rows[0].regs if inst.rows else inst.exit_regs
    for regs in (entry_regs, inst.exit_regs):
        for i in range(NREGS):
            out += _limbs(regs[i], NL, L)
    exit_ptrs = tuple(getattr(inst, "exit_ptrs", (False,) * NREGS))
    entry_ptrs = (tuple(inst.rows[0].ptrs) if inst.rows and inst.rows[0].ptrs
                  else exit_ptrs if not inst.rows else (False,) * NREGS)
    for tags in (entry_ptrs, exit_ptrs):
        out += [1 if t else 0 for t in tags]
    return out
