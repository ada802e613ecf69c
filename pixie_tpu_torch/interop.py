"""Carry the reference's "weights" across: UDA states and tables.

For this system the state that a model's weights stand for is the UDA state
of a fold and the tables it folds. ``state_from_numpy``/``state_to_numpy``
convert between a reference UDA state, given as a pytree of numpy arrays (an
array, or a dict of arrays such as variance's and stddev's {n, sum, sumsq}),
and the port's state of torch tensors;
``state_batch_from_reference`` carries a whole partial aggregate (the
reference's StateBatch: group keys, numpy states, latched dictionaries)
into the port's StateBatch, so a port MERGE stage can consume it;
``table_from_columns`` fills the port's TableStore from the same numpy dict
that fills the reference's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pixie_tpu_torch.exec.agg_node import StateBatch, tree_map
from pixie_tpu_torch.table.column import DictColumn, StringDictionary
from pixie_tpu_torch.table.table import Table
from pixie_tpu_torch.table.table_store import TableStore
from pixie_tpu_torch.types import Relation


def state_from_numpy(uda, leaves: Any, device="cpu"):
    """Reference state (numpy pytree) -> the port's state on ``device``.
    Raises when its structure or dtypes differ from ``uda.init``'s."""
    template = uda.init(1, "cpu")
    if isinstance(template, dict):
        if not isinstance(leaves, dict) or set(leaves) != set(template):
            raise ValueError(
                f"{uda.name} state has keys {sorted(template)}, got "
                f"{sorted(leaves) if isinstance(leaves, dict) else type(leaves)}"
            )
        return {k: _leaf(uda, k, leaves[k], template[k], device) for k in template}
    return _leaf(uda, None, leaves, template, device)


def _leaf(uda, key, value, template: torch.Tensor, device) -> torch.Tensor:
    arr = np.array(value, copy=True, order="C")
    t = torch.from_numpy(arr)
    if t.dtype != template.dtype or t.dim() != template.dim():
        raise TypeError(
            f"{uda.name} state{'' if key is None else '[' + key + ']'}: "
            f"expected {template.dtype} with {template.dim()} dims, got "
            f"{arr.dtype} {arr.shape}"
        )
    return t.to(device)


def state_to_numpy(uda, state):
    """The port's state -> the reference's numpy pytree."""
    if isinstance(state, dict):
        return {k: v.detach().cpu().numpy() for k, v in state.items()}
    return state.detach().cpu().numpy()


def state_batch_from_reference(sb, device="cpu") -> StateBatch:
    """A reference StateBatch -> the port's, its states as tensors on
    ``device``. Key columns and latched dictionaries are rebuilt from their
    codes and values (the reference's DictColumn and StringDictionary carry
    the same ``codes``, ``dictionary`` and ``values()``)."""
    keys = []
    for col in sb.key_columns:
        if hasattr(col, "codes"):
            keys.append(DictColumn(
                np.asarray(col.codes, dtype=np.int32), StringDictionary(col.dictionary.values())
            ))
        else:
            keys.append(np.asarray(col))
    states = {
        name: tree_map(
            lambda a: torch.from_numpy(np.array(a, copy=True, order="C")).to(device), st
        )
        for name, st in sb.states.items()
    }
    return StateBatch(
        key_columns=keys,
        states=states,
        num_groups=int(sb.num_groups),
        group_names=tuple(sb.group_names),
        eow=bool(sb.eow),
        eos=bool(sb.eos),
        arg_dicts={name: StringDictionary(d.values()) for name, d in sb.arg_dicts.items()},
    )


def table_from_columns(
    store: TableStore, name: str, relation: Relation, pydict: dict, **kwargs
) -> Table:
    """Create table ``name`` in ``store`` and write ``pydict`` (column name
    -> numpy array or list; strings as object arrays) into it."""
    table = store.create_table(name, relation, **kwargs)
    table.write_pydict(pydict)
    return table
