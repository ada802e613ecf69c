"""Builtin function library of the port (ref: pixie_tpu/udf/builtins).

Ported so far: the arithmetic, logical and comparison scalars and the count,
sum, mean, min and max UDAs (math_ops), ``any`` (collections), and the
sketch UDAs ``quantiles``, ``quantiles_tdigest``, ``approx_count_distinct``
and ``count_min`` (sketch_ops). Every other builtin of the reference is
named in NOT_PORTED, and the overloads of ported names that are not ported
yet in NOT_PORTED_OVERLOADS, so the compiler rejects a script that calls
one with "not ported yet" instead of an unknown-function error.
"""

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import Registry

NOT_PORTED = frozenset({
    "DurationNanos", "GetAgentStatus", "GetSchemas", "GetTableStatus",
    "GetTables", "GetUDFList", "Time", "_build_request_path_clusters",
    "_exec_host_num_cpus", "_exec_hostname", "_match_endpoint",
    "_predict_request_path_cluster", "abs", "atof", "atoi",
    "bin", "ceil", "cidrs_contain_ip", "container_id_to_status",
    "contains", "endsWith", "exp", "find", "floor", "has_service_id",
    "has_service_name", "ip_to_pod_id", "ip_to_service_id", "kmeans",
    "kmeans_predict", "length", "ln", "log", "log10", "log2",
    "normalize_mysql", "normalize_pgsql", "nslookup", "pluck",
    "pluck_float64", "pluck_int64", "pod_id_to_namespace",
    "pod_id_to_node_name", "pod_id_to_pod_name", "pod_id_to_service_id",
    "pod_id_to_service_name", "pod_name_to_pod_id",
    "pod_name_to_pod_ip", "pod_name_to_start_time",
    "pod_name_to_status", "pow", "redact_pii_best_effort",
    "regex_match", "regex_replace", "replace", "reservoir_sample",
    "round", "script_reference", "select", "sentencepiece",
    "service_id_to_service_name", "service_name_to_service_id", "sqrt",
    "startsWith", "stddev", "string", "strip", "substring", "toLower",
    "toUpper", "transformer", "trim", "upid_to_asid", "upid_to_cmdline",
    "upid_to_container_id", "upid_to_container_name",
    "upid_to_namespace", "upid_to_node_name", "upid_to_pid",
    "upid_to_pod_id", "upid_to_pod_name", "upid_to_service_id",
    "upid_to_service_name", "uri_parse", "uri_recompose", "variance",
})

# (name, arg types) of the reference's overloads that the port does not
# have: the sketches over STRING, which hash each string's content through
# a per-dictionary LUT on the device.
NOT_PORTED_OVERLOADS = frozenset({
    ("approx_count_distinct", (DataType.STRING,)),
    ("count_min", (DataType.STRING,)),
})


def register_all(registry: Registry) -> None:
    from pixie_tpu_torch.udf.builtins import collections, math_ops, sketch_ops

    math_ops.register(registry)
    collections.register(registry)
    sketch_ops.register(registry)
    registry.not_ported = NOT_PORTED
    registry.not_ported_overloads = NOT_PORTED_OVERLOADS
