"""Splitter + coordinator: logical plan → per-agent distributed plan.

Port of pixie_tpu/distributed/planner.py (host code, no device). Ref:
splitter/splitter.h:52,111 (cut at blocking ops), partial_op_mgr.h:36,77,94
(partial-agg rewrite when UDAs serialize — all of ours do by construction),
coordinator/coordinator.h:47,86 (fragment→agent assignment + source
pruning). A PEM fragment's ``Agg(PARTIAL)`` folds on its engine's
DeviceExecutor, which ships the states as a StateBatch to the Kelvin
fragment's ``Agg(MERGE)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pixie_tpu_torch.plan.operators import (
    AggOp,
    AggStage,
    BridgeSinkOp,
    BridgeSourceOp,
    JoinOp,
    LimitOp,
    MapOp,
    FilterOp,
    MemorySourceOp,
    Operator,
    UnionOp,
)
from pixie_tpu_torch.plan.plan import Plan, PlanFragment
from pixie_tpu_torch.types import Relation


@dataclasses.dataclass(frozen=True)
class AgentInfo:
    """One data-bearing engine instance (ref: distributedpb CarnotInfo)."""

    agent_id: str
    tables: frozenset  # table names this agent holds locally
    is_kelvin: bool = False


@dataclasses.dataclass
class DistributedState:
    """Topology snapshot the coordinator plans against
    (ref: coordinator.h DistributedState; broker tracker supplies it)."""

    agents: list[AgentInfo]

    def pems(self) -> list[AgentInfo]:
        return [a for a in self.agents if not a.is_kelvin]

    def kelvin(self) -> Optional[AgentInfo]:
        for a in self.agents:
            if a.is_kelvin:
                return a
        return None


class DistributedPlanner:
    """Plan(logical_plan, state) → distributed Plan with per-agent
    fragments wired through bridges (ref: distributed_planner.h:65-83)."""

    def __init__(self, registry, table_relations: dict[str, Relation]):
        self.registry = registry
        self.table_relations = dict(table_relations)

    def plan(self, logical: Plan, state: DistributedState) -> Plan:
        (frag,) = logical.fragments  # compiler emits one logical fragment
        kelvin = state.kelvin()
        if kelvin is None:
            raise ValueError("distributed planning requires a kelvin agent")

        source_tables = {
            frag.node(n).table_name
            for n in frag.nodes()
            if isinstance(frag.node(n), MemorySourceOp)
        }
        # Source pruning (prune_unavailable_sources_rule): only agents
        # holding every needed table run the pre-blocking fragment.
        pems = [
            a for a in state.pems() if source_tables <= set(a.tables)
        ]
        if not pems:
            raise ValueError(
                f"no agent holds tables {sorted(source_tables)}"
            )

        cut = self._find_cut(frag)
        out = Plan(logical.query_id)
        if cut is None:
            # No blocking agg on a single source chain: PEMs run everything
            # up to the sinks' parents and forward rows; Kelvin unions and
            # runs the sinks (plus any blocking ops like join/limit).
            self._split_forwarding(frag, out, pems, kelvin)
        else:
            self._split_partial_agg(frag, cut, out, pems, kelvin)
        return out

    # -- cut discovery ------------------------------------------------------
    def _find_cut(self, frag: PlanFragment) -> Optional[int]:
        """The blocking agg to cut at: a FULL non-windowed AggOp whose
        ancestors are a single-source map/filter chain (the shape
        partial_op_mgr rewrites). Joins/unions upstream disable the
        partial-agg split (ref: splitter falls back to plain cut)."""
        for nid in frag.topo_order():
            op = frag.node(nid)
            if not (
                isinstance(op, AggOp)
                and op.stage == AggStage.FULL
                and not op.windowed
            ):
                continue
            cur = nid
            ok = True
            while True:
                parents = frag.parents(cur)
                if len(parents) != 1:
                    ok = False
                    break
                cur = parents[0]
                pop = frag.node(cur)
                if isinstance(pop, MemorySourceOp):
                    break
                if not isinstance(pop, (MapOp, FilterOp)):
                    ok = False
                    break
            if ok:
                return nid
        return None

    # -- partial-agg split (partial_op_mgr.h:94) ----------------------------
    def _split_partial_agg(
        self, frag: PlanFragment, agg_nid: int, out: Plan, pems, kelvin
    ) -> None:
        agg_op: AggOp = frag.node(agg_nid)
        bridge_id = f"agg-{agg_nid}"
        ancestors = self._ancestors(frag, agg_nid)
        rels = frag.resolve_relations(
            self.registry, lambda op: self.table_relations[op.table_name]
        )
        pre_agg_rel = rels[frag.parents(agg_nid)[0]]

        # Per-PEM fragment: chain → Agg(PARTIAL) → BridgeSink.
        for a in pems:
            f = out.add_fragment(instance=a.agent_id)
            mapping: dict[int, int] = {}
            for nid in frag.topo_order():
                if nid not in ancestors:
                    continue
                mapping[nid] = f.add(
                    frag.node(nid), [mapping[p] for p in frag.parents(nid)]
                )
            partial = f.add(
                dataclasses.replace(agg_op, stage=AggStage.PARTIAL),
                [mapping[frag.parents(agg_nid)[0]]],
            )
            f.add(BridgeSinkOp(bridge_id), [partial])

        # Kelvin fragment: BridgeSource → Agg(MERGE) → suffix.
        kf = out.add_fragment(instance=kelvin.agent_id)
        merge_in_rel = agg_op.merge_input_relation(pre_agg_rel)
        bsrc = kf.add(BridgeSourceOp(bridge_id, merge_in_rel))
        merge = kf.add(
            dataclasses.replace(
                agg_op, stage=AggStage.MERGE, pre_agg_relation=pre_agg_rel
            ),
            [bsrc],
        )
        mapping = {agg_nid: merge}
        for nid in frag.topo_order():
            if nid == agg_nid or nid in ancestors:
                continue
            mapping[nid] = kf.add(
                frag.node(nid), [mapping[p] for p in frag.parents(nid)]
            )

    # -- plain forwarding split (no partial-able agg) -----------------------
    def _split_forwarding(
        self, frag: PlanFragment, out: Plan, pems, kelvin
    ) -> None:
        """PEMs run the non-blocking prefix of each source chain and forward
        rows; Kelvin runs blocking ops (join/union/limit/agg) + sinks.

        The cut line: a node stays on the PEM side while it is a
        MemorySource or a Map/Filter with a single parent on the PEM side.
        Everything else (joins, unions, aggs over multi-parent shapes,
        limits, sinks) runs on Kelvin (ref: splitter.h blocking-op cut).
        """
        pem_side: set[int] = set()
        for nid in frag.topo_order():
            op = frag.node(nid)
            parents = frag.parents(nid)
            if isinstance(op, MemorySourceOp):
                pem_side.add(nid)
            elif (
                isinstance(op, (MapOp, FilterOp))
                and len(parents) == 1
                and parents[0] in pem_side
                and len(frag.children(parents[0])) == 1
            ):
                pem_side.add(nid)
        # Boundary nodes: pem-side nodes with a consumer off the pem side
        # (or that are sinks' parents).
        boundary = [
            nid for nid in pem_side
            if any(c not in pem_side for c in frag.children(nid))
        ]
        rels = frag.resolve_relations(
            self.registry, lambda op: self.table_relations[op.table_name]
        )
        for a in pems:
            f = out.add_fragment(instance=a.agent_id)
            mapping: dict[int, int] = {}
            for nid in frag.topo_order():
                if nid not in pem_side:
                    continue
                mapping[nid] = f.add(
                    frag.node(nid), [mapping[p] for p in frag.parents(nid)]
                )
            for b in boundary:
                f.add(BridgeSinkOp(f"fwd-{b}"), [mapping[b]])
        kf = out.add_fragment(instance=kelvin.agent_id)
        mapping = {}
        for b in boundary:
            mapping[b] = kf.add(BridgeSourceOp(f"fwd-{b}", rels[b]))
        for nid in frag.topo_order():
            if nid in pem_side:
                continue
            mapping[nid] = kf.add(
                frag.node(nid), [mapping[p] for p in frag.parents(nid)]
            )

    @staticmethod
    def _ancestors(frag: PlanFragment, nid: int) -> set:
        out: set[int] = set()
        stack = list(frag.parents(nid))
        while stack:
            p = stack.pop()
            if p not in out:
                out.add(p)
                stack.extend(frag.parents(p))
        return out
