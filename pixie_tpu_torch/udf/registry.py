"""UDF/UDA/UDTF registry with overload resolution.

Ref: src/carnot/udf/registry.h:101 (Registry), registry.h:44 (RegistryKey:
name + argument types, with implicit INT64->FLOAT64 promotion in lookup),
type_inference.h (semantic rules). The compiler resolves function calls
against this at analysis time; the exec engine fetches definitions by key.
"""

from __future__ import annotations

from typing import Iterable, Optional

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.udf import UDA, UDTF, ScalarUDF


class RegistryKey:
    __slots__ = ("name", "arg_types")

    def __init__(self, name: str, arg_types: Iterable[DataType]):
        self.name = name
        self.arg_types = tuple(arg_types)

    def __hash__(self):
        return hash((self.name, self.arg_types))

    def __eq__(self, other):
        return (self.name, self.arg_types) == (other.name, other.arg_types)

    def __repr__(self):
        args = ",".join(t.name for t in self.arg_types)
        return f"{self.name}({args})"


_WIDENING = {
    DataType.BOOLEAN: (DataType.INT64, DataType.FLOAT64),
    DataType.INT64: (DataType.FLOAT64,),
    DataType.TIME64NS: (DataType.INT64, DataType.FLOAT64),
}


def _promotions(types: tuple[DataType, ...]):
    """Candidate signatures in preference order: exact first, then widening
    (BOOLEAN->INT64->FLOAT64, TIME64NS->INT64->FLOAT64), fewest promotions
    first (ref: registry lookup semantics, registry.h)."""
    import itertools

    options = [(t,) + _WIDENING.get(t, ()) for t in types]
    cands = sorted(
        itertools.product(*options),
        key=lambda cand: sum(a != b for a, b in zip(cand, types)),
    )
    for cand in cands:
        yield cand


class Registry:
    def __init__(self, name: str = "default"):
        self.name = name
        self._scalars: dict[RegistryKey, ScalarUDF] = {}
        self._udas: dict[RegistryKey, UDA] = {}
        self._udtfs: dict[str, UDTF] = {}
        # Names the reference registers that the port does not have yet:
        # the compiler rejects them with "not ported yet".
        self.not_ported: frozenset = frozenset()
        # (name, arg types) overloads of ported names that are not ported.
        self.not_ported_overloads: frozenset = frozenset()

    # -- registration ------------------------------------------------------
    def register_scalar(self, udf: ScalarUDF) -> None:
        self._scalars[RegistryKey(udf.name, udf.arg_types)] = udf

    def register_uda(self, uda: UDA) -> None:
        self._udas[RegistryKey(uda.name, uda.arg_types)] = uda

    def register_udtf(self, udtf: UDTF) -> None:
        self._udtfs[udtf.name] = udtf

    # -- lookup ------------------------------------------------------------
    def lookup_scalar(
        self, name: str, arg_types: Iterable[DataType]
    ) -> Optional[ScalarUDF]:
        for cand in _promotions(tuple(arg_types)):
            udf = self._scalars.get(RegistryKey(name, cand))
            if udf is not None:
                return udf
        return None

    def lookup_uda(self, name: str, arg_types: Iterable[DataType]) -> Optional[UDA]:
        for cand in _promotions(tuple(arg_types)):
            uda = self._udas.get(RegistryKey(name, cand))
            if uda is not None:
                return uda
        return None

    def lookup_udtf(self, name: str) -> Optional[UDTF]:
        return self._udtfs.get(name)

    def has_scalar(self, name: str) -> bool:
        return any(k.name == name for k in self._scalars)

    def has_uda(self, name: str) -> bool:
        return any(k.name == name for k in self._udas)

    def scalar_names(self) -> set[str]:
        return {k.name for k in self._scalars}

    def scalar_overloads(self, name: str):
        """All registered overloads for a scalar name (public accessor so
        callers never reach into _scalars)."""
        return [f for k, f in self._scalars.items() if k.name == name]

    def uda_names(self) -> set[str]:
        return {k.name for k in self._udas}

    def docs(self) -> dict[str, str]:
        """Doc extraction (ref: udf/doc.h)."""
        out = {}
        for k, f in self._scalars.items():
            out[repr(k)] = f.doc
        for k, a in self._udas.items():
            out[repr(k)] = a.doc
        for n, t in self._udtfs.items():
            out[n] = t.doc
        return out


_default: Registry | None = None


def default_registry() -> Registry:
    """The fully-populated builtin registry (ref: funcs/funcs.cc
    RegisterFuncsOrDie). Lazily built to keep import light."""
    global _default
    if _default is None:
        _default = Registry("builtins")
        from pixie_tpu_torch.udf import builtins

        builtins.register_all(_default)
    return _default
