"""Mesh geometry for the sharded fold (pixie_tpu/distributed/mesh.py).

The geometry model is the reference's: a mesh is a tuple of named axes,
outermost first. A flat single-host mesh is ``d:<ndev>``; a multi-host mesh
prefixes a ``hosts`` axis, e.g. ``hosts:2,d:4``. Data shards its leading
(shard) dimension over the FULL axis tuple in row-major order, so shard i is
flat device i whatever the factorization, and the merge reduces over the
flat device order: every factorization of the same device list folds to the
same result. The ``hosts`` axis changes behavior only where code asks for it
(``host_axis``, ``inner_axes``).

The reference builds a ``jax.sharding.Mesh`` and runs one SPMD program over
it. The port has one controller too, and no ``torch.distributed``: a
``Mesh`` here is the axes plus an ordered tuple of ``torch.device``s, one a
shard. The tuple may name distinct cards, or one device several times
(logical shards of one card, as the reference's tests name virtual CPU
devices); a geometry is a geometry either way. ``MeshConfig.build`` checks
the device count exactly as the reference does and never shrinks a geometry
to fit the devices it finds.

The reference's partition rules map each staged lane name to a
``NamedSharding`` and re-place a cached staging when a degradation rung
changes the geometry. The port needs neither: a staged lane puts shard i on
``mesh.devices[i]``, every rung of the ladder is built over the same device
tuple, and the staged cache keys name that tuple, so a staging never has to
move.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence

import torch

from pixie_tpu_torch.device import resolve_device
from pixie_tpu_torch.utils import flags


class MeshGeometryError(RuntimeError):
    """A mesh-geometry failure the executor can recover from.

    ``kind`` drives the recovery policy:

    - ``host_loss`` / ``collective_timeout``: the current geometry is
      suspect; re-plan the fold onto the next degradation rung
      (``MeshConfig.degrade``), which folds to the same result.
    - ``checkpoint_corrupt``: a window checkpoint read back bad; discard it
      and refold from scratch on the surviving geometry.
    - ``signature_mismatch``: a cached program's geometry disagrees with the
      executor's; a caller error, with no degrade retry.
    """

    KINDS = (
        "host_loss",
        "collective_timeout",
        "checkpoint_corrupt",
        "signature_mismatch",
    )

    def __init__(self, kind: str, detail: str = ""):
        assert kind in self.KINDS, kind
        super().__init__(
            f"mesh geometry failure [{kind}]" + (f": {detail}" if detail else "")
        )
        self.kind = kind
        self.detail = detail

    @property
    def recoverable(self) -> bool:
        """True iff retrying on a degraded geometry can help."""
        return self.kind in ("host_loss", "collective_timeout")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes of a geometry over an ordered tuple of devices: shard i is
    ``devices[i]``, the flat row-major index over ``axis_names``."""

    axis_names: tuple
    shape: tuple
    devices: tuple  # tuple[torch.device, ...], len == prod(shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        """Shard 0's device, where the merge and the finalize run."""
        return self.devices[0]

    def distinct_devices(self) -> tuple:
        """The devices in first-seen order, each once."""
        return tuple(dict.fromkeys(self.devices))


def indexed_device(device) -> torch.device:
    """``device`` with an explicit index on CUDA (``cuda`` is the current
    card), so that it compares equal to its tensors' devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device=None) -> list:
    """The devices a geometry without an explicit device list spans: every
    CUDA card (the reference's ``jax.devices()``), or ``[device]`` when the
    caller names one."""
    if device is not None:
        return [indexed_device(device)]
    resolve_device(None)  # raises without CUDA
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh geometry: ((axis_name, size), ...) outermost first."""

    axes: tuple  # tuple[tuple[str, int], ...]

    def __post_init__(self):
        if not self.axes:
            raise ValueError("MeshConfig needs at least one axis")
        names = [n for n, _ in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")
        for name, size in self.axes:
            if not isinstance(size, int) or size < 1:
                raise ValueError(f"bad mesh axis {name}:{size}")

    @property
    def names(self) -> tuple:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> tuple:
        return tuple(s for _, s in self.axes)

    @property
    def total_devices(self) -> int:
        return int(math.prod(self.shape))

    def signature(self) -> str:
        """The geometry string every program and staged-cache key carries."""
        return ",".join(f"{n}:{s}" for n, s in self.axes)

    @staticmethod
    def flat(ndev: int) -> "MeshConfig":
        return MeshConfig(axes=(("d", int(ndev)),))

    @staticmethod
    def parse(spec: str, ndev: int) -> "MeshConfig":
        """Parse 'hosts:2,d:4' (one size may be -1 = fill remaining)."""
        spec = (spec or "").strip()
        if not spec:
            return MeshConfig.flat(ndev)
        axes = []
        for part in spec.split(","):
            part = part.strip()
            m = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(-?\d+)", part)
            if not m:
                raise ValueError(f"bad mesh axis spec {part!r} in {spec!r}")
            axes.append((m.group(1), int(m.group(2))))
        wild = [i for i, (_, s) in enumerate(axes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed: {spec!r}")
        if wild:
            known = math.prod(s for _, s in axes if s != -1)
            if known <= 0 or ndev % known:
                raise ValueError(
                    f"mesh {spec!r} does not divide {ndev} devices"
                )
            name, _ = axes[wild[0]]
            axes[wild[0]] = (name, ndev // known)
        cfg = MeshConfig(axes=tuple(axes))
        if cfg.total_devices != ndev:
            raise ValueError(
                f"mesh {spec!r} wants {cfg.total_devices} devices, "
                f"have {ndev}"
            )
        return cfg

    @staticmethod
    def of_mesh(mesh: Mesh) -> "MeshConfig":
        """The config of an existing Mesh."""
        return MeshConfig(axes=tuple(zip(tuple(mesh.axis_names), tuple(mesh.shape))))

    @staticmethod
    def from_flags(ndev: int) -> "MeshConfig":
        return MeshConfig.parse(flags.mesh_axes, ndev)

    def degrade(self, lost_hosts: int = 1) -> "Optional[MeshConfig]":
        """Best surviving geometry after losing ``lost_hosts`` hosts.

        Each rung keeps ``total_devices`` and refolds the freed devices into
        the innermost axis, which keeps the answer the same (any
        factorization of the same device list folds alike). Ladder for
        hosts:4,d:2: hosts:2,d:4, then d:8, then None (the host engine).
        A flat mesh has no hosts to shed: None. The surviving host count is
        the largest divisor of ``total_devices`` below the current count and
        at most hosts - lost_hosts; below 2 the mesh collapses to flat."""
        if len(self.axes) < 2:
            return None
        hosts = self.shape[0]
        ndev = self.total_devices
        want = hosts - max(1, int(lost_hosts))
        survivors = 0
        for h in range(min(want, hosts - 1), 1, -1):
            if ndev % h == 0:
                survivors = h
                break
        if survivors < 2:
            return MeshConfig.flat(ndev)
        inner = list(self.axes[1:])
        others = math.prod(s for _, s in inner[:-1])
        per_host = ndev // survivors
        if per_host % others:
            # The per-host share no longer factors through the middle axes:
            # flatten everything inner into the last axis.
            return MeshConfig(
                axes=((self.axes[0][0], survivors), (inner[-1][0], per_host))
            )
        inner[-1] = (inner[-1][0], per_host // others)
        return MeshConfig(axes=((self.axes[0][0], survivors), *inner))

    def ladder(self) -> "list[Optional[MeshConfig]]":
        """The full degradation ladder, this geometry first and ``None``
        (the host engine) last, one ``degrade()`` step a rung."""
        rungs: "list[Optional[MeshConfig]]" = [self]
        cur: "Optional[MeshConfig]" = self
        while cur is not None:
            cur = cur.degrade()
            if cur is not None and cur.signature() == rungs[-1].signature():
                break
            rungs.append(cur)
        if rungs[-1] is not None:
            rungs.append(None)
        return rungs

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        """The Mesh of this geometry over ``devices`` (every CUDA card when
        None). Raises ValueError unless there are exactly ``total_devices``."""
        devs = [indexed_device(d) for d in devices] if devices is not None else local_devices()
        if len(devs) != self.total_devices:
            raise ValueError(
                f"mesh {self.signature()} wants {self.total_devices} "
                f"devices, have {len(devs)}"
            )
        return Mesh(self.names, self.shape, tuple(devs))


def resolve_mesh(mesh: Optional[Mesh] = None, mesh_config: Optional[MeshConfig] = None,
                 devices: Optional[Sequence] = None, device=None):
    """(mesh, config) from whichever the caller has; the flag fills gaps.

    - ``mesh`` given: its config (an explicit mesh wins).
    - ``mesh_config`` given: built over ``devices``, else every CUDA card
      (``[device]`` when the caller names one).
    - ``devices`` given alone: the ``mesh_axes`` geometry over them (flat
      when the flag is empty).
    - none of them: the ``mesh_axes`` flag over every CUDA card (over
      ``[device]`` when named; flat when the flag is empty), as the
      reference's flag spans every local device
      (pixie_tpu/distributed/mesh.py:223-241): ``d:<cards>`` on a machine
      of several cards, ``d:1`` on one card, on a named device, or on
      ``device="cpu"``. Raises without CUDA unless a device is named.
    """
    if mesh is not None:
        return mesh, MeshConfig.of_mesh(mesh)
    if devices is not None:
        devs = list(devices)
        cfg = mesh_config if mesh_config is not None else MeshConfig.from_flags(len(devs))
        return cfg.build(devs), cfg
    devs = local_devices(device)
    cfg = mesh_config if mesh_config is not None else MeshConfig.from_flags(len(devs))
    return cfg.build(devs), cfg


def data_axes(mesh: Mesh) -> tuple:
    """All mesh axis names, outermost first: the data-sharding tuple."""
    return tuple(mesh.axis_names)


def host_axis(mesh: Mesh) -> str:
    """The outermost axis: the shard boundary for partitioned work."""
    return tuple(mesh.axis_names)[0]


def inner_axes(mesh: Mesh) -> tuple:
    """Axes within one host (empty on a 1-axis mesh)."""
    return tuple(mesh.axis_names)[1:]


__all__ = [
    "Mesh",
    "MeshConfig",
    "MeshGeometryError",
    "indexed_device",
    "local_devices",
    "resolve_mesh",
    "data_axes",
    "host_axis",
    "inner_axes",
]
