"""Collection UDAs: ``any`` (ref: pixie_tpu/udf/builtins/collections.py).

``any`` keeps one observed value per group, deterministically the max: of
the values for floats and ints, of the dictionary codes for strings and of
0/1 for bools. A string state holds codes of the table's dictionary, which
the device fold decodes at finalize. On the card its update is H11 over the
values widened to int64 (f64 for floats); the reference reduces codes and
bools in int32 and widens once per block, which gives the same states.
"""

from __future__ import annotations

import torch

from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import UDA, MergeKind

F = DataType.FLOAT64
I = DataType.INT64
S = DataType.STRING
B = DataType.BOOLEAN
T = DataType.TIME64NS


def register(r: Registry) -> None:
    def any_uda(arg_t):
        dtype = torch.float64 if arg_t == F else torch.int64
        ident = segment._identity_for(dtype, is_min=False)

        def fin(st):
            return torch.where(st == ident, torch.zeros_like(st), st)

        return UDA(
            name="any",
            arg_types=(arg_t,),
            out_type=arg_t,
            init=lambda g, device: torch.full((g,), ident, dtype=dtype, device=device),
            update=lambda st, gids, col, mask=None: segment.segment_minmax(
                st, col.to(dtype), gids, mask, is_min=False
            ),
            merge=lambda a, b: segment.minmax_pick(a, b, is_min=False),
            finalize=fin,
            merge_kind=MergeKind.PMAX,
            out_semantic=lambda sems: sems[0] if sems else None,
            # String state holds codes that must decode back to the value.
            string_args="code",
            string_state=(arg_t == S),
            doc="An arbitrary (deterministic: max) value from the group.",
        )

    for t in (F, I, S, B, T):
        r.register_uda(any_uda(t))
