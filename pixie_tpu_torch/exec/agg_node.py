"""Hash-aggregate node via dense gids + segment reductions.

Port of pixie_tpu/exec/agg_node.py. Ref: src/carnot/exec/agg_node.{h,cc} —
the reference keeps an absl hash map of RowTuple->AggHashValue with
per-group UDA object instances, updated row-at-a-time, emitting on eos/eow,
with a partial-aggregate serialize path for the PEM->Kelvin split.

Here group keys densify on the host to int32 gids (GroupEncoder); each UDA
state is torch tensors with a leading [capacity] group axis on the node's
device (the engine's: the DeviceExecutor's device, else ``Carnot(device=)``,
resolved when the node prepares), updated by one ``uda.update(state, gids,
col)`` per batch, so on the card a host-side aggregation runs the UDAs'
kernels (H1-H3, H5-H11, H25, H26) on CUDA tensors; a ``host_state`` UDA
(kmeans) keeps its state on the CPU and finalizes on the node's device.
Capacity grows by doubling (concat
with ``uda.init(extra)``, the merge identity by UDA contract). The PARTIAL
stage emits a StateBatch (keys + state tensors); the MERGE stage scatters
incoming states onto its own gids and folds them with ``uda.merge``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch.exec.exec_node import ExecNode
from pixie_tpu_torch.exec.group_encoder import GroupEncoder
from pixie_tpu_torch.plan.expressions import ColumnRef, expr_data_type
from pixie_tpu_torch.plan.operators import AggOp, AggStage
from pixie_tpu_torch.table.column import DictColumn, StringDictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.types.dtypes import host_dtype

INITIAL_CAPACITY = 256


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a UDA state (a tensor or array, or a dict
    of them), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _as_tensor(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.from_numpy(np.array(leaf, copy=True, order="C")).to(device)


@dataclasses.dataclass
class StateBatch:
    """Partial-aggregate handoff between fragments (ref: the serialized
    partial-agg row batches of partial_op_mgr.h:94). Carries group keys in
    gid order plus per-value states (torch tensors) sliced to num_groups."""

    key_columns: list  # per group col: np.ndarray or DictColumn, len num_groups
    states: dict[str, Any]  # out_name -> state with leading [num_groups]
    num_groups: int
    group_names: tuple[str, ...]
    eow: bool = False
    eos: bool = False
    # Producer-side latched dictionaries for string_state UDAs, keyed by the
    # UDA's output name; the merge stage translates incoming code states
    # through these into its own latch (codes are agent-local otherwise).
    arg_dicts: dict = dataclasses.field(default_factory=dict)

    # -- wire format (the reference's: an npz of numpy leaves plus a repr'd
    # descriptor, so either package reads what the other writes) -----------
    def to_bytes(self) -> bytes:
        import io

        arrays: dict[str, np.ndarray] = {}
        counter = iter(range(1 << 30))

        def attach(arr: np.ndarray) -> str:
            # Opaque names: path-derived keys can collide.
            name = f"a{next(counter)}"
            arrays[name] = arr
            return name

        def enc(obj):
            if isinstance(obj, torch.Tensor):
                return {"arr": attach(obj.detach().cpu().numpy())}
            if isinstance(obj, np.ndarray):
                return {"arr": attach(obj)}
            if isinstance(obj, dict):
                return {"dict": {k: enc(v) for k, v in obj.items()}}
            if isinstance(obj, (tuple, list)):
                return {"seq": [enc(v) for v in obj], "tuple": isinstance(obj, tuple)}
            return {"val": obj}

        keys = []
        for i, col in enumerate(self.key_columns):
            if isinstance(col, DictColumn):
                arrays[f"k{i}"] = np.asarray(col.decode().tolist(), dtype="U")
                keys.append({"kind": "str", "arr": f"k{i}"})
            else:
                arrays[f"k{i}"] = np.asarray(col)
                keys.append({"kind": "plain", "arr": f"k{i}"})
        dicts = {}
        for name, d in self.arg_dicts.items():
            arrays[f"d:{name}"] = np.asarray(list(d.values()), dtype="U")
            dicts[name] = f"d:{name}"
        meta = {
            "num_groups": int(self.num_groups),
            "group_names": list(self.group_names),
            "eow": bool(self.eow),
            "eos": bool(self.eos),
            "keys": keys,
            "states": {name: enc(tree) for name, tree in self.states.items()},
            "arg_dicts": dicts,
        }
        buf = io.BytesIO()
        np.savez_compressed(
            buf, __meta__=np.frombuffer(repr(meta).encode(), dtype=np.uint8), **arrays
        )
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "StateBatch":
        """The batch ``to_bytes`` wrote, its state leaves as CPU tensors."""
        import ast
        import io

        with np.load(io.BytesIO(data), allow_pickle=False) as npz:
            meta = ast.literal_eval(bytes(npz["__meta__"]).decode())

            def dec(node):
                if "arr" in node:
                    return torch.from_numpy(np.array(npz[node["arr"]]))
                if "dict" in node:
                    return {k: dec(v) for k, v in node["dict"].items()}
                if "seq" in node:
                    seq = [dec(v) for v in node["seq"]]
                    return tuple(seq) if node["tuple"] else seq
                return node["val"]

            key_columns = []
            for k in meta["keys"]:
                arr = npz[k["arr"]]
                if k["kind"] == "str":
                    d = StringDictionary()
                    key_columns.append(DictColumn(d.encode(arr.astype(object)), d))
                else:
                    key_columns.append(arr)
            arg_dicts = {
                name: StringDictionary(list(npz[path].astype(object)))
                for name, path in meta["arg_dicts"].items()
            }
            return cls(
                key_columns=key_columns,
                states={name: dec(node) for name, node in meta["states"].items()},
                num_groups=meta["num_groups"],
                group_names=tuple(meta["group_names"]),
                eow=meta["eow"],
                eos=meta["eos"],
                arg_dicts=arg_dicts,
            )

    def __reduce__(self):
        # Pickling rides the explicit wire format.
        return (StateBatch.from_bytes, (self.to_bytes(),))


@dataclasses.dataclass
class _AggSpec:
    out_name: str
    uda: Any
    arg_names: tuple[str, ...]


class AggNode(ExecNode):
    def __init__(self, op: AggOp, output_relation: Relation, node_id: int):
        super().__init__(op, output_relation, node_id)
        self.op: AggOp = op
        self._specs: list[_AggSpec] = []
        self._encoder = GroupEncoder()
        self._capacity = INITIAL_CAPACITY if op.groups else 1
        self._states: dict[str, Any] = {}
        self._device: Optional[torch.device] = None
        self._key_dicts: dict[str, Optional[StringDictionary]] = {}
        # name -> (live source dictionary, snapshot length at latch time)
        self._key_dict_sources: dict[str, tuple] = {}

    # -- lifecycle ----------------------------------------------------------
    def prepare_impl(self, exec_state) -> None:
        """The states go on the engine's device, resolved now (so a fragment
        with no aggregation never needs a device)."""
        self._device = exec_state.compute_device()
        self._states = {
            s.out_name: s.uda.init(self._capacity, self._state_device(s)) for s in self._specs
        }

    def _state_device(self, spec) -> torch.device:
        """Where ``spec``'s state lives: the CPU for a ``host_state`` UDA,
        else the node's device."""
        return torch.device("cpu") if spec.uda.host_state else self._device

    def set_input_relation(self, rel: Relation, registry) -> None:
        if self.op.stage == AggStage.MERGE and self.op.pre_agg_relation is not None:
            rel = self.op.pre_agg_relation  # resolve UDAs as PARTIAL did
        self._specs = []
        for out_name, agg in self.op.values:
            arg_types = [expr_data_type(a, rel, registry) for a in agg.args]
            uda = registry.lookup_uda(agg.name, arg_types)
            if uda is None:
                raise ValueError(
                    f"no aggregate {agg.name}({', '.join(t.name for t in arg_types)})"
                )
            names = []
            for a in agg.args:
                if not isinstance(a, ColumnRef):
                    raise ValueError(
                        "aggregate args must be column refs (the compiler "
                        "hoists computed args into a Map)"
                    )
                names.append(a.name)
            self._specs.append(_AggSpec(out_name, uda, tuple(names)))

    # -- consume ------------------------------------------------------------
    def consume_next_impl(self, exec_state, batch, parent_index: int) -> None:
        if isinstance(batch, StateBatch):
            self._consume_states(batch)
            if batch.eos or (batch.eow and self.op.windowed):
                self._emit(exec_state, eow=batch.eow, eos=batch.eos)
            return
        if batch.num_rows:
            host_gids = torch.from_numpy(self._gids_for(batch))
            gids = host_gids.to(self._device)
            self._ensure_capacity(self._encoder.num_groups or 1)
            for spec in self._specs:
                dev = self._state_device(spec)
                g = host_gids if dev.type == "cpu" else gids
                if spec.uda.reads_args:
                    cols = [
                        self._arg_tensor(batch, n, spec.uda.string_args, dev)
                        for n in spec.arg_names
                    ]
                else:
                    cols = [g]  # count: never reads its column
                self._states[spec.out_name] = spec.uda.update(
                    self._states[spec.out_name], g, *cols
                )
        if batch.eos or (batch.eow and self.op.windowed):
            self._emit(exec_state, eow=batch.eow, eos=batch.eos)

    def _latch_key_column(self, name: str, col):
        """Latch a PRIVATE snapshot of the first dictionary seen per string
        key column; re-encode cross-dictionary batches (e.g. across a union)
        into it so codes stay comparable. Codes below the snapshot length are
        stable (dictionaries are append-only), so the single-table case skips
        the re-encode."""
        if isinstance(col, DictColumn):
            existing = self._key_dicts.get(name)
            if existing is None:
                src = col.dictionary
                existing = StringDictionary(src.values())
                self._key_dicts[name] = existing
                self._key_dict_sources[name] = (src, len(existing))
            src_info = self._key_dict_sources.get(name)
            if (
                src_info is not None
                and col.dictionary is src_info[0]
                and (len(col.codes) == 0 or int(col.codes.max()) < src_info[1])
            ):
                return DictColumn(col.codes, existing)
            if col.dictionary is not existing:
                col = DictColumn(existing.encode(col.decode()), existing)
        return col

    def _gids_for(self, batch: RowBatch) -> np.ndarray:
        if not self.op.groups:
            return np.zeros(batch.num_rows, np.int32)
        key_cols = [self._latch_key_column(g, batch.col(g)) for g in self.op.groups]
        return self._encoder.encode(key_cols)

    def _arg_tensor(self, batch: RowBatch, name: str, mode: str, device):
        """An argument column on ``device``: strings as the content hashes of
        their values (``"hash"``), as codes of the latched dictionary
        (``"code"``), or decoded (``"values"``: a numpy object array that
        stays on the host)."""
        col = batch.col(name)
        if isinstance(col, DictColumn):
            if mode == "values":
                return col.decode()
            if mode == "hash":
                arr = col.dictionary.content_hashes().view(np.int64)[col.codes]
            else:
                arr = self._latch_key_column(name, col).codes
        else:
            arr = np.asarray(col)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def _ensure_capacity(self, needed: int) -> None:
        while self._capacity < needed:
            extra = self._capacity
            for spec in self._specs:
                self._states[spec.out_name] = tree_map(
                    lambda a, b: torch.cat([a, b]),
                    self._states[spec.out_name],
                    spec.uda.init(extra, self._state_device(spec)),
                )
            self._capacity += extra

    # -- merge stage --------------------------------------------------------
    def _consume_states(self, sb: StateBatch) -> None:
        if sb.num_groups == 0:
            return
        if self.op.groups:
            key_cols = [
                self._latch_key_column(g, col) for g, col in zip(sb.group_names, sb.key_columns)
            ]
            idx = self._encoder.encode(key_cols)
        else:
            idx = np.zeros(sb.num_groups, np.int32)
        self._ensure_capacity(self._encoder.num_groups or 1)
        for spec in self._specs:
            dev = self._state_device(spec)
            idx_t = torch.from_numpy(idx.astype(np.int64)).to(dev)
            incoming = tree_map(lambda a: _as_tensor(a, dev), sb.states[spec.out_name])
            if spec.uda.string_state and spec.out_name in sb.arg_dicts:
                incoming = self._translate_state_codes(
                    spec.arg_names[0], incoming, sb.arg_dicts[spec.out_name]
                )
            aligned = tree_map(
                lambda z, inc: z.index_put_((idx_t,), inc.to(z.dtype)),
                spec.uda.init(self._capacity, dev),
                incoming,
            )
            self._states[spec.out_name] = spec.uda.merge(self._states[spec.out_name], aligned)

    def _translate_state_codes(self, name: str, codes: torch.Tensor, incoming_dict):
        """Map a code-valued state from the producer's dictionary into this
        node's latch (adopting the producer's dictionary when nothing is
        latched yet). Sentinel/out-of-range codes pass through untouched."""
        existing = self._key_dicts.get(name)
        if existing is None:
            self._key_dicts[name] = incoming_dict
            return codes
        if existing is incoming_dict:
            return codes
        out = codes.cpu().numpy().copy()
        valid = (out >= 0) & (out < len(incoming_dict))
        if valid.any():
            out[valid] = existing.encode(incoming_dict.decode(out[valid].astype(np.int32)))
        return torch.from_numpy(out).to(codes.device)

    # -- emit ---------------------------------------------------------------
    def _num_out_groups(self) -> int:
        if self.op.groups:
            return self._encoder.num_groups
        return 1  # group-by-none emits one row even on empty input (ref)

    def _emit(self, exec_state, eow: bool, eos: bool) -> None:
        n = self._num_out_groups()
        if self.op.stage == AggStage.PARTIAL:
            sliced = {
                s.out_name: tree_map(lambda a: a[:n], self._states[s.out_name])
                for s in self._specs
            }
            arg_dicts = {}
            for s in self._specs:
                if s.uda.string_state:
                    d = self._key_dicts.get(s.arg_names[0])
                    if d is not None:
                        # Copy: the consumer may encode into this dictionary
                        # (merge translation); never hand out our latch.
                        arg_dicts[s.out_name] = StringDictionary(d.values())
            self.send(
                exec_state,
                StateBatch(
                    key_columns=self._key_columns(),
                    states=sliced,
                    num_groups=n,
                    group_names=self.op.groups,
                    eow=eow,
                    eos=eos,
                    arg_dicts=arg_dicts,
                ),
            )
        else:
            self.send(exec_state, self._finalized_batch(n, eow=eow, eos=eos))
        if eow and not eos:
            self._reset_window()

    def _key_columns(self) -> list:
        arrays = self._encoder.key_arrays()
        if not arrays and self.op.groups:
            # Zero rows ever consumed: the output relation still has one
            # (empty) column per group key.
            arrays = [np.empty(0, np.int64) for _ in self.op.groups]
        cols = []
        for g, arr in zip(self.op.groups, arrays):
            d = self._key_dicts.get(g)
            if d is not None:
                cols.append(DictColumn(arr.astype(np.int32), d))
            elif (
                self.output_relation.has_column(g)
                and self.output_relation.col(g).data_type == DataType.STRING
            ):
                cols.append(DictColumn(arr.astype(np.int32), StringDictionary()))
            else:
                cols.append(arr)
        return cols

    def _finalized_batch(self, n: int, eow: bool, eos: bool) -> RowBatch:
        out_cols: list = []
        rel = self.output_relation
        for g, col in zip(self.op.groups, self._key_columns()):
            if isinstance(col, DictColumn):
                out_cols.append(col)
            else:
                out_cols.append(np.asarray(col, dtype=host_dtype(rel.col(g).data_type)))
        for spec in self._specs:
            state = tree_map(lambda a: a[:n], self._states[spec.out_name])
            if spec.uda.host_state:
                out = spec.uda.finalize(state, self._device)
            else:
                out = spec.uda.finalize(state)
            if isinstance(out, torch.Tensor):
                out = out.cpu().numpy()
            schema = rel.col(spec.out_name)
            if schema.data_type == DataType.STRING:
                if spec.uda.string_state:
                    latched = self._key_dicts.get(spec.arg_names[0])
                    codes = np.asarray(out)
                    if latched is None:
                        vals = np.full(len(codes), "", dtype=object)
                    else:
                        vals = latched.decode(codes)
                else:
                    vals = np.asarray(out, dtype=object)
                d = StringDictionary()
                out_cols.append(DictColumn(d.encode(vals), d))
            else:
                out_cols.append(np.asarray(out, dtype=host_dtype(schema.data_type)))
        return RowBatch(rel, out_cols, eow=eow, eos=eos)

    def _reset_window(self) -> None:
        self._encoder.reset()
        self._key_dicts.clear()
        self._key_dict_sources.clear()
        self._capacity = INITIAL_CAPACITY if self.op.groups else 1
        self._states = {
            s.out_name: s.uda.init(self._capacity, self._state_device(s)) for s in self._specs
        }
