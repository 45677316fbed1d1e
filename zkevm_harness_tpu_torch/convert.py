"""State carried between the JAX package and this port, as numpy arrays.

The JAX package stores a field element as a (lo, hi) pair of uint32 planes;
the port stores one int64 holding the u64 bit pattern. This module converts
field arrays (an AIR's execution trace among them: `tensor_from_pairs`,
`pairs_from_tensor`), a `PlonkishSetup`, and a `PlonkishProof` or a
`StarkProof` (through the shared JSON) in both directions, and
a BN254 PLONK proof and VK and the EIP-4844 witness chain to and from JSON.
MainVM instances, artifacts and a tracer's queries, and the instance payloads
of the hash and storage-application circuits, are plain Python ints (or
object arrays of them) in dataclasses of the same field names in both
packages, so their carrier is a field-by-field rebuild into the port's
classes, or into the classes a caller names. A JAX dense copy permutation
becomes the port's `CopyWiring`, and a block's artifacts of either package
become one JSON summary (`block_artifacts_summary`). It imports neither `jax` nor the JAX package: the caller hands over numpy arrays
(`np.asarray(gf.lo)`, `np.asarray(gf.hi)`) and gets numpy arrays back, so the
tests can run both packages on the same data.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .ops import goldilocks as gl
from .ops import merkle as mk
from .prover import plonkish as pk
from .circuits import decommitter_circuit as dcc
from .circuits import linear_hasher_circuit as lhc
from .circuits import storage_application_circuit as sac
from .utils import serde
from .witness import main_vm as wmv
from .witness import precompile_circuits as wpc
from .witness import precompile_rounds as wpr
from .witness import sorters as wsort

Pairs = Tuple[np.ndarray, np.ndarray]  # (lo, hi) uint32 planes


# -- field arrays -----------------------------------------------------------

def pairs_to_u64(lo, hi) -> np.ndarray:
    """(lo, hi) uint32 planes -> uint64 values hi * 2^32 + lo."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return lo | (hi << np.uint64(32))


def u64_to_pairs(u) -> Pairs:
    """uint64 values -> (lo, hi) uint32 planes."""
    u = np.asarray(u, dtype=np.uint64)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def tensor_from_pairs(lo, hi, device=None) -> torch.Tensor:
    """(lo, hi) uint32 planes -> the port's int64 field tensor."""
    return gl.from_u64(pairs_to_u64(lo, hi), device)


def pairs_from_tensor(t: torch.Tensor) -> Pairs:
    """The port's int64 field tensor -> (lo, hi) uint32 planes."""
    return u64_to_pairs(gl.to_u64(t))


# -- setup ------------------------------------------------------------------

def setup_to_numpy(setup: pk.PlonkishSetup) -> Dict:
    """A port `PlonkishSetup` as plain numpy: (lo, hi) planes for the column
    blocks and every tree level, the padded tables and the cap as they are."""
    return {
        "const_cols": pairs_from_tensor(setup.const_cols),
        "sigma_cols": pairs_from_tensor(setup.sigma_cols),
        "table_cols": pairs_from_tensor(setup.table_cols),
        "table_np": tuple(setup.table_np),
        "tree_levels": [pairs_from_tensor(lv) for lv in setup.tree.levels],
        "cap_np": setup.cap_np,
    }


def setup_from_numpy(const_cols: Pairs, sigma_cols: Pairs, table_cols: Pairs,
                     table_np: Sequence[np.ndarray],
                     tree_levels: Sequence[Pairs],
                     device=None) -> pk.PlonkishSetup:
    """A port `PlonkishSetup` from the numpy arrays of a JAX `PlonkishSetup`
    (`np.asarray` of each `.lo`/`.hi`; `tree_levels` from `setup.tree.levels`).
    Nothing is recomputed: the tree is taken as given."""
    levels = tuple(tensor_from_pairs(lo, hi, device) for lo, hi in tree_levels)
    tree = mk.MerkleTree(levels)
    return pk.PlonkishSetup(
        const_cols=tensor_from_pairs(*const_cols, device),
        sigma_cols=tensor_from_pairs(*sigma_cols, device),
        table_cols=tensor_from_pairs(*table_cols, device),
        table_np=tuple(np.asarray(t, dtype=object) for t in table_np),
        tree=tree, cap_np=gl.to_ints(tree.cap))


# -- proofs -----------------------------------------------------------------

def proof_to_json(proof):
    """A `PlonkishProof` of either package -> the shared JSON structure."""
    return serde.proof_to_json(proof)


def proof_from_json(data, registry=None):
    """The shared JSON structure -> a proof. `registry` maps dataclass names
    to classes: the port's by default, the JAX package's
    `serde.default_registry()` to get a JAX proof."""
    return serde.proof_from_json(
        data, serde.default_registry() if registry is None else registry)


def proof_to_package(proof, registry=None):
    """Re-type a proof of one package as the other's, through the JSON."""
    return proof_from_json(proof_to_json(proof), registry)


# A compression proof and its VK are a `PlonkishProof` and a list of ints, so
# they take the same conversion (`proof_to_json` / `proof_from_json`).


# -- BN254 PLONK proofs and VKs, the EIP-4844 witness chain ------------------
# A PLONK proof's and VK's curve points are Python ints: a G1 point (x, y), a
# G2 point ((x0, x1), (y0, y1)), None the point at infinity. JSON keeps the
# ints and turns the tuples into lists; reading restores the tuples (the
# curve code compares points as tuples).

def _point(v):
    if v is None:
        return None
    return tuple(_point(x) if isinstance(x, list) else int(x) for x in v)


def _listed(v):
    if isinstance(v, (tuple, list)):
        return [_listed(x) for x in v]
    return v if v is None else int(v)


def plonk_proof_to_json(proof) -> Dict:
    """A `PlonkProof` of either package -> a JSON structure."""
    return {"public_inputs": [int(x) for x in proof.public_inputs],
            "comms": {k: _listed(v) for k, v in proof.comms.items()},
            "evals": {k: int(v) for k, v in proof.evals.items()},
            "w_zeta": _listed(proof.w_zeta),
            "w_zeta_omega": _listed(proof.w_zeta_omega)}


def plonk_proof_from_json(data, cls=None):
    """The JSON structure -> a `PlonkProof` (the port's, or `cls`)."""
    if cls is None:
        from .utils.plonk import PlonkProof as cls
    return cls(public_inputs=[int(x) for x in data["public_inputs"]],
               comms={k: _point(v) for k, v in data["comms"].items()},
               evals={k: int(v) for k, v in data["evals"].items()},
               w_zeta=_point(data["w_zeta"]),
               w_zeta_omega=_point(data["w_zeta_omega"]))


def plonk_vk_to_json(vk) -> Dict:
    """A `PlonkVerificationKey` of either package -> a JSON structure."""
    return {"n": int(vk.n),
            "q_comms": {k: _listed(v) for k, v in vk.q_comms.items()},
            "sigma_comms": _listed(vk.sigma_comms),
            "public_gates": [int(g) for g in vk.public_gates],
            "g2_powers": _listed(vk.g2_powers)}


def plonk_vk_from_json(data, cls=None):
    """The JSON structure -> a `PlonkVerificationKey` (the port's, or
    `cls`)."""
    if cls is None:
        from .utils.plonk import PlonkVerificationKey as cls
    return cls(n=int(data["n"]),
               q_comms={k: _point(v) for k, v in data["q_comms"].items()},
               sigma_comms=tuple(_point(v) for v in data["sigma_comms"]),
               public_gates=[int(g) for g in data["public_gates"]],
               g2_powers=tuple(_point(v) for v in data["g2_powers"]))


def eip4844_witness_to_json(witness) -> Dict:
    """`generate_eip4844_witness`'s (chunks, linear_hash, versioned_hash,
    output_hash) -> hex strings."""
    chunks, linear_hash, versioned_hash, output_hash = witness
    return {"chunks": [c.hex() for c in chunks],
            "linear_hash": linear_hash.hex(),
            "versioned_hash": versioned_hash.hex(),
            "output_hash": output_hash.hex()}


def eip4844_witness_from_json(data) -> Tuple:
    return ([bytes.fromhex(c) for c in data["chunks"]],
            bytes.fromhex(data["linear_hash"]),
            bytes.fromhex(data["versioned_hash"]),
            bytes.fromhex(data["output_hash"]))


# -- MainVM witness objects -------------------------------------------------

def _fields_of(cls, src) -> Dict:
    return {f.name: getattr(src, f.name) for f in dataclasses.fields(cls)}


def vm_instance_from(inst) -> wmv.VmCircuitInstance:
    """A `VmCircuitInstance` of either package as the port's, rows included."""
    kw = _fields_of(wmv.VmCircuitInstance, inst)
    kw["rows"] = [wmv.VmRow(**_fields_of(wmv.VmRow, r)) for r in inst.rows]
    return wmv.VmCircuitInstance(**kw)


def vm_artifacts_from(art) -> wmv.VmCircuitArtifacts:
    """A `VmCircuitArtifacts` of either package as the port's."""
    kw = _fields_of(wmv.VmCircuitArtifacts, art)
    kw["instances"] = [vm_instance_from(i) for i in art.instances]
    return wmv.VmCircuitArtifacts(**kw)


def tracer_queries(tracer) -> Dict:
    """What a `WitnessTracer` of either package recorded, as plain Python
    (dicts keyed by field name): equal tracers give equal values."""
    plain = dataclasses.asdict
    return {
        "cycles": tracer.cycle_counter,
        "memory": [(c, plain(q)) for c, q in tracer.memory_queries],
        "log": [(c, plain(q)) for c, q in
                tracer.callstack_with_aux_data.forward],
        "rollbacks": [(c, plain(q)) for c, q in
                      tracer.callstack_with_aux_data.unapplied_rollbacks()],
        "decommittments": [(c, plain(q)) for c, q in
                           tracer.decommittment_queries],
        "bytecodes": {h: list(w) for h, w in
                      tracer.decommitted_bytecodes.items()},
        "precompiles": [(c, plain(q), d, r) for c, q, d, r in
                        tracer.precompile_calls],
        "refunds": [(c, plain(q), r) for c, q, r in tracer.refunds],
        "frame_pops": {c: {k: v for k, v in info.items() if k != "frame"}
                       for c, info in tracer.frame_pops.items()},
        "cycle_states": list(tracer.cycle_states),
        "final_state": tracer.final_state,
    }


# -- instance payloads of the hash circuits ---------------------------------

def _rebuild(cls, src, **override):
    """`src` (a dataclass of either package) as `cls`, field by field;
    numpy arrays are copied as object arrays of Python ints."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = override[f.name] if f.name in override else getattr(src, f.name)
        if isinstance(v, np.ndarray):
            v = np.array([int(x) for x in v.ravel()],
                         dtype=object).reshape(v.shape)
        kw[f.name] = v
    return cls(**kw)


def round_function_instance_from(
        inst, cls=wpc.RoundFunctionInstanceWitness,
        invocation_cls=wpr.RoundFunctionInvocation):
    """A keccak / SHA-256 `RoundFunctionInstanceWitness` of either package
    as `cls` (the port's by default), its invocations as
    `invocation_cls`."""
    return _rebuild(cls, inst, invocations=[
        _rebuild(invocation_cls, inv) for inv in inst.invocations])


def hasher_inputs_from(inst, cls=lhc.HasherInstanceInputs):
    """An L1-messages hasher `HasherInstanceInputs` of either package as
    `cls` (the port's by default)."""
    return _rebuild(cls, inst)


def decommitter_inputs_from(inst, cls=dcc.DecommitterInstanceInputs):
    """A code-decommitter `DecommitterInstanceInputs` of either package as
    `cls` (the port's by default)."""
    return _rebuild(cls, inst)


def decommitts_instance_from(inst, cls=wsort.DecommittsCircuitInstance):
    """A decommitments-sorter `DecommittsCircuitInstance` of either package
    as `cls` (the port's by default)."""
    return _rebuild(cls, inst)


# -- ecrecover and storage application --------------------------------------

def copy_wiring_from_dense(perm) -> pk.CopyWiring:
    """The JAX package's dense (num_witness, n, 2) successor array of a copy
    permutation (an `FFLayout.permutation`, the result of `apply_copy_cycles`)
    as the port's `CopyWiring`: the moved cells and their successors, flat
    col * n + row, in cell order."""
    perm = np.asarray(perm)
    width, n, _ = perm.shape
    flat = perm[:, :, 0].astype(np.int64) * n + perm[:, :, 1]
    ident = np.arange(width * n, dtype=np.int64).reshape(width, n)
    moved = flat != ident
    return pk.CopyWiring(ident[moved], flat[moved])


def path_inputs_from(inst, cls=sac.PathInstanceInputs):
    """A storage-application `PathInstanceInputs` of either package as `cls`
    (the port's by default)."""
    return cls(leaf_preimage=bytes(inst.leaf_preimage),
               path_bits=[int(b) for b in inst.path_bits],
               siblings=[bytes(x) for x in inst.siblings])


# -- block artifacts --------------------------------------------------------

def _ints(v):
    """Nested lists / tuples / arrays / tensors of integers as nested lists
    of Python ints (bools as 0 / 1, bytes as hex)."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).hex()
    if isinstance(v, torch.Tensor):
        return [int(x) for x in gl.to_u64(v).ravel()]
    if isinstance(v, np.ndarray):
        return [_ints(x) for x in v.tolist()] if v.ndim else int(v)
    if isinstance(v, (list, tuple)):
        return [_ints(x) for x in v]
    if hasattr(v, "tolist"):      # an array of another library
        return _ints(np.asarray(v))
    return int(v)


def _log_query(q):
    return [int(getattr(q, f)) for f in (
        "timestamp", "tx_number_in_block", "aux_byte", "shard_id", "address",
        "key", "read_value", "written_value", "rw_flag", "rollback",
        "is_service")]


def _queue(q):
    return {"length": len(q), "tail": [int(v) for v in q.tail]}


def block_artifacts_summary(art, geometry, public_inputs) -> Dict:
    """What `create_artifacts_from_tracer` of either package made of a block,
    as JSON-ready nested lists of ints: the queues' lengths and tails, the
    demuxed and deduplicated streams, the instance counts and recursion
    queues, the callstack sponge witness, the storage roots and paths, the
    ecrecover invocations, and per base circuit type the decomposer's
    instance count, challenges and every instance's expected public inputs
    (`public_inputs` is that package's
    `layers.real_base_instance_public_inputs`). Equal artifacts give equal
    summaries."""
    from .witness.oracle import block_payloads
    cs = art.callstack_witness
    sa = art.storage_application
    out = {
        "log_queue": _queue(art.log_queue),
        "memory_queue": _queue(art.memory_queue),
        "sorted_memory_queue": _queue(art.sorted_memory_queue),
        "demuxed": {k: [[int(c)] + _log_query(q) for c, q in v]
                    for k, v in sorted(art.demuxed.items())},
        "deduplicated": {
            "storage": [_log_query(q) for q in art.deduplicated_storage],
            "events": [_log_query(q) for q in art.deduplicated_events],
            "l1": [_log_query(q) for q in art.deduplicated_l1_messages]},
        "per_circuit": {str(t): [a.num_instances, a.capacity]
                        for t, a in sorted(art.per_circuit.items())},
        "recursion_queues": {str(t): _queue(q) for t, q in
                             sorted(art.recursion_queues.items())},
        "callstack": {
            "ops": [[o.cycle, int(o.is_push), o.depth_before,
                     _ints(o.encoding), _ints(o.state_before),
                     _ints(o.state_after)] for o in cs.ops],
            "boundaries": [[b.cycle, int(b.is_push), b.depth,
                            b.state.forward_length,
                            _ints(b.state.forward_tail),
                            b.state.rollback_length]
                           for b in cs.log_boundaries],
            "final_state": _ints(cs.final_state),
            "max_depth": cs.max_depth},
        "storage_application": {
            "initial_root": sa.initial_root.hex(),
            "final_root": sa.final_root.hex(),
            "paths": [[p.leaf_preimage.hex(), _ints(p.path_bits),
                       hashlib.sha256(b"".join(p.siblings)).hexdigest()]
                      for pair in sa.instances for p in pair],
            "instances": [[w.initial_root.hex(), w.final_root.hex(),
                           w.initial_next_enumeration_index,
                           w.final_next_enumeration_index, len(w.queries)]
                          for w in sa.query_witnesses]},
        "ecrecover": [[w.index, int(w.start_flag), int(w.completion_flag),
                       [[inv.msg_hash.hex(), inv.v, inv.r, inv.s,
                         _ints(inv.recovered_point or ()),
                         (inv.address or b"").hex(), int(inv.success)]
                        for inv in w.invocations]] for w in art.ecrecover],
        "types": {},
    }
    for ctype, (insts, challenges, cap) in sorted(
            block_payloads(art, geometry).items()):
        out["types"][str(ctype)] = {
            "instances": len(insts), "capacity": cap,
            "challenges": _ints(challenges) if challenges is not None
            else None,
            "public_inputs": [_ints(public_inputs(ctype, w, challenges, cap))
                              for w in insts]}
    return out


# -- the block proving flow -------------------------------------------------

def block_proving_summary(res, dag, aux_values) -> Dict:
    """What `harness.run_block` of either package made of a block, as
    JSON-ready nested lists of ints: the proof DAG (`dag`, that package's
    `build_block_dag` over the result's recursion queues: every task's key
    and its dependencies' keys, in order), each type's CircuitMaker (every
    instance's closed-form input and public-input digest, the recursion
    queue's length and tail), the scheduler witness with its aux values,
    and each DAG record's kind and `real` flag. Equal flows give equal
    summaries."""
    sw = res.scheduler_witness
    makers = {}
    for t, cm in sorted(res.circuit_makers.items()):
        makers[str(t)] = {
            "queue": _queue(cm.queue),
            "instances": [[i.index, int(i.closed_form_input.start_flag),
                           int(i.closed_form_input.completion_flag),
                           _ints(i.closed_form_input.compact_form()),
                           _ints(i.public_input)] for i in cm.instances]}
    first_last = {str(t): [None if i is None else i.index for i in fl]
                  for t, fl in sorted(sw.first_last_closed_form_inputs
                                      .items())}
    return {
        "cycles": int(res.cycles),
        "dag": [[list(t.key()), [list(d.key()) for d in t.deps]]
                for t in dag],
        "records": [[list(k), rec.get("kind"), bool(rec.get("real"))]
                    for k, rec in res.dag_results.items()],
        "makers": makers,
        "scheduler_witness": {
            "block_number": int(sw.block_number),
            "bootloader_heap_initial_content": _ints(
                sw.bootloader_heap_initial_content),
            "events_queue_state": [_ints(sw.events_queue_state.tail),
                                   int(sw.events_queue_state.length)],
            "memory_queue_state": [_ints(sw.memory_queue_state.tail),
                                   int(sw.memory_queue_state.length)],
            "rollup_state_diff_for_compression":
                sw.aux_output.rollup_state_diff_for_compression.hex(),
            "l1_messages_linear_hash":
                sw.aux_output.l1_messages_linear_hash.hex(),
            "first_last": first_last,
            "aux_values": [int(v) for v in aux_values]},
    }



# -- the circuit builder ----------------------------------------------------

def builder_gates(bld) -> Tuple[np.ndarray, np.ndarray]:
    """A `CircuitBuilder`'s gates of either package as (G, 5) uint64
    q-constants (qm, ql, qr, qo, qc) and (G, 3) int64 wires (a, b, c; -1
    where unused)."""
    if hasattr(bld, "gate_arrays"):
        return bld.gate_arrays()
    q = np.array([[int(g.qm), int(g.ql), int(g.qr), int(g.qo), int(g.qc)]
                  for g in bld.gates], dtype=np.uint64).reshape(-1, 5)
    w = np.array([[g.a, g.b, g.c] for g in bld.gates],
                 dtype=np.int64).reshape(-1, 3)
    return q, w


def built_circuit_arrays(built) -> Tuple[np.ndarray, pk.CopyWiring]:
    """A `BuiltCircuit` of either package as its (num_const, n) uint64 const
    columns and its copy permutation as a `CopyWiring` in cell order."""
    const = np.asarray(built.const_cols).astype(np.uint64)
    if hasattr(built, "wiring"):
        order = np.argsort(built.wiring.cells, kind="stable")
        wiring = pk.CopyWiring(built.wiring.cells[order],
                               built.wiring.succ[order])
    else:
        wiring = copy_wiring_from_dense(built.permutation)
    return const, wiring


# -- DAG records and data sources -------------------------------------------
# A DAG record (`{"kind", "real", "proof", "vk", ...}`) goes to and from JSON
# through `proof_to_json` / `proof_from_json` like a proof: the encoder
# takes any nesting of dicts, lists and proof dataclasses.

def data_source_from(src, registry=None):
    """An `InMemoryDataSource` of either package as the port's (or, with the
    JAX package's `serde.default_registry()`, as one whose proofs are that
    package's): every stored VK, proof and DAG record, through the JSON."""
    from .utils.data_source import InMemoryDataSource
    out = InMemoryDataSource()
    for key, value in src._store.items():
        out.set(proof_from_json(json_roundtrip(proof_to_json(value)),
                                registry), *key)
    return out


def json_roundtrip(obj):
    """`obj` through a JSON text and back (what a file store keeps)."""
    import json
    return json.loads(json.dumps(obj))


def plonk_statement_digests(builder, wires, public_inputs) -> Dict:
    """SHA-256 digests of a PLONK statement built by either package's
    `PlonkBuilder` and filled: its selectors, its wiring, its public gates
    and its assignment (the three wire columns and the public inputs). Two
    statements with equal digests are the same circuit over the same
    values."""
    def digest(*cols) -> str:
        h = hashlib.sha256()
        for col in cols:
            h.update(",".join(str(int(v)) for v in col).encode())
            h.update(b"\n")
        return h.hexdigest()

    return dict(
        n_gates=len(builder.qL),
        selectors=digest(builder.qL, builder.qR, builder.qO, builder.qM,
                         builder.qC),
        wiring=digest(builder.wa, builder.wb, builder.wc),
        public_gates=digest(builder.public_gates),
        assignment=digest(*wires, public_inputs))


def builder_circuit_digests(builder, built) -> Dict:
    """SHA-256 digests of a finalized `CircuitBuilder` of either package:
    its gates (q-constants and wires) with its permutations and public
    variables, and the circuit it lowered to (shape, public-input cells,
    const columns and copy wiring). Two builders with equal digests made
    the same circuit."""
    q, w = builder_gates(builder)
    gates = hashlib.sha256()
    for arr in (q.astype("<u8"), w.astype("<i8"),
                np.asarray([v for p in builder.perms for half in p
                            for v in half], dtype="<i8"),
                np.asarray(builder.pi_vars, dtype="<i8")):
        gates.update(arr.tobytes())
        gates.update(b"|")
    const, wiring = built_circuit_arrays(built)
    circuit = hashlib.sha256()
    ir = built.ir
    circuit.update(repr((ir.log_n, ir.num_witness, ir.num_const,
                         [tuple(int(x) for x in c)
                          for c in ir.public_input_cells])).encode())
    for arr in (const.astype("<u8"), wiring.cells.astype("<i8"),
                wiring.succ.astype("<i8")):
        circuit.update(arr.tobytes())
        circuit.update(b"|")
    return dict(gates=int(q.shape[0]), permutations=len(builder.perms),
                gates_sha256=gates.hexdigest(),
                circuit_sha256=circuit.hexdigest())


def field_values_sha256(values) -> str:
    """SHA-256 of a field array's canonical u64 values, little-endian in
    C order: a port tensor, or a JAX (lo, hi) pair as numpy planes."""
    if isinstance(values, torch.Tensor):
        u = gl.to_u64(values)
    else:
        u = pairs_to_u64(*values)
    return hashlib.sha256(np.ascontiguousarray(u, dtype="<u8")
                          .tobytes()).hexdigest()
