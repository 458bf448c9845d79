"""Exception hierarchy mirroring the reference's ElasticsearchException tree.

Reference: ``server/src/main/java/org/elasticsearch/ElasticsearchException.java``
and the REST status mapping in ``rest/RestStatus``-carrying exceptions. Each
exception carries an HTTP status so the REST layer can render ES-compatible
error bodies ``{"error": {"type": ..., "reason": ...}, "status": N}``.
"""

from __future__ import annotations


class ElasticsearchError(Exception):
    """Base error. ``status`` is the HTTP status the REST layer returns."""

    status = 500
    error_type = "exception"

    def __init__(self, reason: str = "", **metadata):
        super().__init__(reason)
        self.reason = reason
        self.metadata = metadata

    def to_dict(self) -> dict:
        err = {"type": self.error_type, "reason": self.reason or str(self)}
        err.update(self.metadata)
        return {"error": err, "status": self.status}


class IndexNotFoundError(ElasticsearchError):
    status = 404
    error_type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)
        self.index = index


class ResourceAlreadyExistsError(ElasticsearchError):
    status = 400
    error_type = "resource_already_exists_exception"


class DocumentMissingError(ElasticsearchError):
    status = 404
    error_type = "document_missing_exception"


class VersionConflictError(ElasticsearchError):
    """Reference: ``index/engine/VersionConflictEngineException.java``."""

    status = 409
    error_type = "version_conflict_engine_exception"


class MapperParsingError(ElasticsearchError):
    status = 400
    error_type = "mapper_parsing_exception"


class IllegalArgumentError(ElasticsearchError):
    status = 400
    error_type = "illegal_argument_exception"


class IllegalStateError(ElasticsearchError):
    """Reference: ``java.lang.IllegalStateException`` surfaced through
    ``ElasticsearchException`` (e.g. resize validation in
    ``cluster/metadata/MetadataCreateIndexService.java:1068``)."""

    status = 500
    error_type = "illegal_state_exception"


class ElasticsearchParseError(ElasticsearchError):
    """``ElasticsearchParseException`` — type "parse_exception", distinct
    from ParsingError's "parsing_exception"."""

    status = 400
    error_type = "parse_exception"


class ParsingError(ElasticsearchError):
    """Query DSL / body parse failure (``common/ParsingException.java``)."""

    status = 400
    error_type = "parsing_exception"


class QueryShardError(ElasticsearchError):
    """Reference: ``index/query/QueryShardException.java`` — a query that
    cannot execute against this shard's mapping."""

    status = 400
    error_type = "query_shard_exception"


class SearchPhaseExecutionError(ElasticsearchError):
    status = 500
    error_type = "search_phase_execution_exception"


class ShardNotFoundError(ElasticsearchError):
    status = 404
    error_type = "shard_not_found_exception"


class NodeNotFoundError(ElasticsearchError):
    status = 404
    error_type = "node_not_found_exception"


class CircuitBreakingError(ElasticsearchError):
    """Reference: ``common/breaker/CircuitBreakingException.java`` (429)."""

    status = 429
    error_type = "circuit_breaking_exception"


class ClusterBlockError(ElasticsearchError):
    status = 503
    error_type = "cluster_block_exception"


class InvalidIndexNameError(ElasticsearchError):
    status = 400
    error_type = "invalid_index_name_exception"


class InvalidAliasNameError(ElasticsearchError):
    status = 400
    error_type = "invalid_alias_name_exception"


class SnapshotError(ElasticsearchError):
    status = 500
    error_type = "snapshot_exception"


class SnapshotMissingError(ElasticsearchError):
    status = 404
    error_type = "snapshot_missing_exception"


class PipelineError(ElasticsearchError):
    status = 400
    error_type = "pipeline_processing_exception"


class ResourceNotFoundError(ElasticsearchError):
    status = 404
    error_type = "resource_not_found_exception"


class IndexClosedError(ElasticsearchError):
    status = 400
    error_type = "index_closed_exception"


class XContentParseError(ElasticsearchError):
    """Agg/body parse failures surfaced as x_content_parse_exception."""
    status = 400
    error_type = "x_content_parse_exception"


class ActionRequestValidationError(ElasticsearchError):
    """Request validation failures (action_request_validation_exception)."""
    status = 400
    error_type = "action_request_validation_exception"


def remote_status(e) -> int:
    """HTTP status of any exception, including remote-wrapped ones whose
    class crossed the transport by NAME (RemoteTransportError carries
    ``remote_type``); 0 when unknown."""
    st = getattr(e, "status", None)
    if st is None and hasattr(e, "remote_type"):
        cls = globals().get(getattr(e, "remote_type", "") or "")
        st = getattr(cls, "status", None)
    return int(st or 0)
