"""TableStore: name/id -> Table registry with tablet support.

Ref: src/table_store/table/table_store.h:79 — maps table name and table id to
Table objects, with optional per-tablet addressing (tablet partitioning is the
reference's key-sharding mechanism; on TPU the analogous sharding happens at
the device-mesh layer, but tablets are kept for ingest-side partitioning).
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

from pixie_tpu_torch.table.table import Table
from pixie_tpu_torch.types import Relation

DEFAULT_TABLET = ""


class TableStore:
    def __init__(self):
        self._lock = threading.RLock()
        # (name, tablet_id) -> Table
        self._tables: dict[tuple[str, str], Table] = {}
        self._relations: dict[str, Relation] = {}
        self._ids: dict[int, str] = {}
        self._next_id = 1
        # Registration hooks: fn(name, table), fired after a table
        # registers (r8: the engine attaches the device executor's
        # compile prewarm here). Best-effort — a failing listener must
        # never fail table creation, but for a NotImplementedError: a flag
        # that asks for an unported part (the resident ring's spill or
        # replicas) must not run without it.
        self._listeners: list = []

    def add_create_listener(self, fn) -> None:
        """Register fn(name, table) to run after every add_table."""
        with self._lock:
            self._listeners.append(fn)

    def add_table(
        self,
        name: str,
        table: Table,
        tablet_id: str = DEFAULT_TABLET,
        table_id: Optional[int] = None,
    ) -> int:
        with self._lock:
            table.name = table.name or name
            self._tables[(name, tablet_id)] = table
            self._relations[name] = table.relation
            tid = table_id if table_id is not None else self._next_id
            self._next_id = max(self._next_id, tid + 1)
            self._ids[tid] = name
            listeners = list(self._listeners)
        # Outside the lock: listeners may call back into the store.
        for fn in listeners:
            try:
                fn(name, table)
            except NotImplementedError:
                raise
            except Exception:
                import logging

                logging.getLogger("pixie_tpu_torch.table").warning(
                    "table-create listener failed for %r", name,
                    exc_info=True,
                )
        return tid

    def create_table(self, name: str, relation: Relation, **kwargs) -> Table:
        t = Table(relation, name=name, **kwargs)
        self.add_table(name, t)
        return t

    def get_table(
        self, name_or_id, tablet_id: str = DEFAULT_TABLET
    ) -> Optional[Table]:
        with self._lock:
            name = (
                self._ids.get(name_or_id)
                if isinstance(name_or_id, int)
                else name_or_id
            )
            return self._tables.get((name, tablet_id))

    def get_relation(self, name: str) -> Optional[Relation]:
        with self._lock:
            return self._relations.get(name)

    def has_table(self, name: str) -> bool:
        with self._lock:
            return name in self._relations

    def table_names(self) -> list[str]:
        with self._lock:
            return sorted(self._relations)

    def tablets(self, name: str) -> list[str]:
        with self._lock:
            return sorted(t for (n, t) in self._tables if n == name)

    def tables(self) -> Iterable[Table]:
        with self._lock:
            return list(self._tables.values())

    def compact_all(self) -> int:
        n = 0
        for t in self.tables():
            n += t.compact()
        return n

    def relation_map(self) -> dict[str, Relation]:
        """Schema map handed to the compiler (ref: schema::Schema)."""
        with self._lock:
            return dict(self._relations)
