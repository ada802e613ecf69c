"""The cross-shard merge of the fold's states (K18).

Counterpart of pixie_tpu/parallel/pipeline.py ``_merge_states`` (:5605),
the collective half of the reference's program tail: after every shard has
folded its rows, the presence counts are psummed, and each UDA's state by
its merge kind: PSUM / PMAX / PMIN elementwise over the shards, TREE by
gathering the states and merging them pairwise with the UDA's merge in
device order. On one shard it is the identity.

Here the merge runs at the root, shard 0's device. Each shard's leaves come
to the root (a device-to-device copy after an event on the source's stream;
none for a shard already on the root), then:

- the elementwise leaves (presence included) are grouped by (dtype, merge
  kind), each group's leaves concatenated per shard into one [D, L] stack,
  and reduced over the shard axis in flat order 0..D-1 by ONE launch of H29
  (``kernels.merge_states``) on the card or by ``merge_stack_plain`` on the
  CPU;
- a TREE state merges as ``acc = g[0]; acc = merge(acc, g[i])`` for
  i = 1..D-1 (pipeline.py:5628-5635): H8 for t-digests, H26 for reservoirs.

A fixed order makes the merge deterministic: nothing is reduced in an order
a library picks. Integer sums wrap mod 2^64, f64 sums add in flat order (as
the reference's psum adds on its CPU mesh), and f64 max/min follow Fault-5
(NaN propagates, -0.0 < +0.0), the in-shard lanes' order, so a merged state
does not depend on how the rows were cut into shards (ROADMAP Fault-17).
"""

from __future__ import annotations

from typing import Optional

import torch

from pixie_tpu_torch.ops import kernels, segment
from pixie_tpu_torch.udf.udf import MergeKind

_ELEMENTWISE = {MergeKind.PSUM: "sum", MergeKind.PMAX: "max", MergeKind.PMIN: "min"}


def merge_stack_plain(stack: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain version of H29: [L] = the ``kind`` ("sum", "max", "min") of a
    [D, L] stack over its shard axis, folded in order d = 0..D-1 from
    ``stack[0]``: int64 sums wrap, f64 sums are IEEE adds in that order,
    f64 max/min take ``segment.minmax_pick`` (H11's order) step by step."""
    acc = stack[0].clone()
    for d in range(1, stack.shape[0]):
        x = stack[d]
        if kind == "sum":
            acc = acc + x
        elif stack.dtype == torch.float64:
            acc = segment.minmax_pick(acc, x, kind == "min")
        else:
            acc = torch.minimum(acc, x) if kind == "min" else torch.maximum(acc, x)
    return acc


def merge_stack(stack: torch.Tensor, kind: str) -> torch.Tensor:
    """The reduction of a [D, L] stack over its shards: H29 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if stack.is_cuda:
        return kernels.merge_states(stack.contiguous(), kind)
    return merge_stack_plain(stack, kind)


def to_root(t: torch.Tensor, root: torch.device) -> torch.Tensor:
    """``t`` on ``root``: itself when it is there already, else a copy that
    waits on an event of the source's current stream."""
    if t.device == root:
        return t
    if t.is_cuda and root.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(root).wait_event(ready)
    return t.to(root, non_blocking=True)


def merge_leaves(shard_leaves: list, kinds: list, root: torch.device) -> list:
    """Merged leaves on ``root``: ``shard_leaves[s][i]`` is shard s's leaf i
    (any shape), ``kinds[i]`` its reduction ("sum", "max", "min"). Leaves of
    one (dtype, kind) merge through ONE [D, L] stack and ONE reduction."""
    n = len(kinds)
    if len(shard_leaves) == 1:
        return list(shard_leaves[0])
    groups: dict = {}
    for i, kind in enumerate(kinds):
        groups.setdefault((shard_leaves[0][i].dtype, kind), []).append(i)
    out: list = [None] * n
    for (dtype, kind), idx in groups.items():
        L = sum(shard_leaves[0][i].numel() for i in idx)
        stack = torch.empty((len(shard_leaves), L), dtype=dtype, device=root)
        for s, shard in enumerate(shard_leaves):
            parts = [shard[i].reshape(-1) for i in idx]
            if parts[0].device == root:  # concatenated straight into its row
                torch.cat(parts, out=stack[s])
            else:
                stack[s].copy_(to_root(torch.cat(parts), root))
        merged = merge_stack(stack, kind)
        off = 0
        for i in idx:
            shape = shard_leaves[0][i].shape
            size = shard_leaves[0][i].numel()
            out[i] = merged[off : off + size].reshape(shape)
            off += size
    return out


def _leaves(state) -> list:
    """A state's leaves in sorted key order (one tensor: itself)."""
    return [state[k] for k in sorted(state)] if isinstance(state, dict) else [state]


def _rebuild(like, leaves: list):
    if isinstance(like, dict):
        return dict(zip(sorted(like), leaves))
    return leaves[0]


def merge_states(specs, shard_states: list, shard_presence: list,
                 root: Optional[torch.device] = None) -> tuple:
    """(merged states, merged presence) on ``root`` (shard 0's device by
    default) from each shard's fold: ``shard_states[s]`` holds one state per
    spec ``(out, arg, uda)``, ``shard_presence[s]`` the shard's int64
    presence counts. One shard: the identity."""
    if len(shard_states) == 1:
        return list(shard_states[0]), shard_presence[0]
    root = root if root is not None else shard_presence[0].device
    elem_leaves: list = [[] for _ in shard_states]
    kinds: list = []
    layout: list = []  # per spec: ("tree", None) or ("elem", (first, count))
    for j, (_, _, uda) in enumerate(specs):
        kind = _ELEMENTWISE.get(uda.merge_kind)
        if kind is None:
            layout.append(("tree", None))
            continue
        leaves0 = _leaves(shard_states[0][j])
        layout.append(("elem", (len(kinds), len(leaves0))))
        kinds.extend([kind] * len(leaves0))
        for s, states in enumerate(shard_states):
            elem_leaves[s].extend(_leaves(states[j]))
    presence_at = len(kinds)
    kinds.append("sum")
    for s, p in enumerate(shard_presence):
        elem_leaves[s].append(p)
    merged = merge_leaves(elem_leaves, kinds, root)
    out = []
    for j, (_, _, uda) in enumerate(specs):
        mode, info = layout[j]
        if mode == "elem":
            first, count = info
            out.append(_rebuild(shard_states[0][j], merged[first : first + count]))
            continue
        gathered = [
            _rebuild(st[j], [to_root(x, root) for x in _leaves(st[j])]) for st in shard_states
        ]
        acc = gathered[0]
        for g in gathered[1:]:
            acc = uda.merge(acc, g)
        out.append(acc)
    return out, merged[presence_at]
