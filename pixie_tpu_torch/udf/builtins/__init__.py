"""Builtin function library of the port (ref: pixie_tpu/udf/builtins).

Ported so far: the arithmetic, logical, comparison and math scalars and the
count, sum, mean, min, max, variance and stddev UDAs (math_ops), ``bin``,
``DurationNanos`` and ``Time`` (time_ops), ``select`` (conditionals), the
string and JSON functions (string_ops, json_ops, host), ``any``
(collections), and the sketch UDAs ``quantiles``, ``quantiles_tdigest``,
``approx_count_distinct`` and ``count_min`` (sketch_ops), and the ML
functions ``reservoir_sample``, ``kmeans``, ``kmeans_predict``,
``sentencepiece`` and ``transformer`` (ml_ops). Every other builtin of the
reference (metadata, security, the UDTFs) is named in
NOT_PORTED, and an overload of a ported name that is not ported yet would
be named in NOT_PORTED_OVERLOADS, so the compiler rejects a script that
calls one with "not ported yet" instead of an unknown-function error.
"""

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import Registry

NOT_PORTED = frozenset({
    "GetAgentStatus", "GetSchemas", "GetTableStatus", "GetTables",
    "GetUDFList", "_build_request_path_clusters", "_exec_host_num_cpus",
    "_exec_hostname", "_match_endpoint", "_predict_request_path_cluster",
    "cidrs_contain_ip", "container_id_to_status", "has_service_id",
    "has_service_name", "ip_to_pod_id", "ip_to_service_id",
    "normalize_mysql", "normalize_pgsql", "nslookup",
    "pod_id_to_namespace", "pod_id_to_node_name", "pod_id_to_pod_name",
    "pod_id_to_service_id", "pod_id_to_service_name", "pod_name_to_pod_id",
    "pod_name_to_pod_ip", "pod_name_to_start_time", "pod_name_to_status",
    "redact_pii_best_effort",
    "service_id_to_service_name", "service_name_to_service_id",
    "upid_to_asid", "upid_to_cmdline", "upid_to_container_id",
    "upid_to_container_name", "upid_to_namespace", "upid_to_node_name",
    "upid_to_pid", "upid_to_pod_id", "upid_to_pod_name", "upid_to_service_id",
    "upid_to_service_name", "uri_parse", "uri_recompose",
})

# (name, arg types) of the reference's overloads of ported names that the
# port does not have yet: none.
NOT_PORTED_OVERLOADS: frozenset = frozenset()


def register_all(registry: Registry) -> None:
    from pixie_tpu_torch.udf.builtins import (
        collections,
        conditionals,
        json_ops,
        math_ops,
        ml_ops,
        sketch_ops,
        string_ops,
        time_ops,
    )

    math_ops.register(registry)
    sketch_ops.register(registry)
    string_ops.register(registry)
    json_ops.register(registry)
    conditionals.register(registry)
    time_ops.register(registry)
    collections.register(registry)
    ml_ops.register(registry)
    registry.not_ported = NOT_PORTED
    registry.not_ported_overloads = NOT_PORTED_OVERLOADS
