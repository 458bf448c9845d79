"""Indexing pressure: a byte budget on concurrent indexing work.

Reference: ``index/IndexingPressure.java:31`` — every bulk/index request
reserves its payload bytes against ``indexing_pressure.memory.limit``
(default 10% heap) for its whole lifetime; requests beyond the budget are
rejected with 429 ``es_rejected_execution_exception`` instead of letting
host memory grow unboundedly. Stats surface under nodes stats
``indexing_pressure.memory``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from .errors import ElasticsearchError

#: default budget — a fixed figure standing in for "10% of heap"
DEFAULT_LIMIT_BYTES = 512 * 1024 * 1024


class EsRejectedExecutionError(ElasticsearchError):
    status = 429
    error_type = "es_rejected_execution_exception"


class IndexingPressure:
    def __init__(self, limit_bytes: int = DEFAULT_LIMIT_BYTES):
        self.limit_bytes = int(limit_bytes)
        self._lock = threading.Lock()
        self.current_bytes = 0
        self.total_bytes = 0
        self.rejections = 0

    @contextmanager
    def coordinating(self, bytes_: int, desc: str = "bulk"):
        """Reserve ``bytes_`` for the scope of one indexing operation;
        raises 429 when the budget is exhausted."""
        bytes_ = max(int(bytes_), 0)
        with self._lock:
            if self.current_bytes + bytes_ > self.limit_bytes:
                self.rejections += 1
                cur = self.current_bytes
                raise EsRejectedExecutionError(
                    f"rejected execution of {desc} ["
                    f"coordinating_and_primary_bytes={cur}, "
                    f"operation_bytes={bytes_}, "
                    f"max_coordinating_and_primary_bytes="
                    f"{self.limit_bytes}]")
            self.current_bytes += bytes_
            self.total_bytes += bytes_
        try:
            yield
        finally:
            with self._lock:
                self.current_bytes -= bytes_

    def stats_doc(self) -> dict:
        def shape(n: int) -> dict:
            return {"combined_coordinating_and_primary_in_bytes": n,
                    "coordinating_in_bytes": n, "primary_in_bytes": 0,
                    "replica_in_bytes": 0, "all_in_bytes": n}
        return {"memory": {
            "current": shape(self.current_bytes),
            "total": dict(shape(self.total_bytes),
                          coordinating_rejections=self.rejections,
                          primary_rejections=0, replica_rejections=0),
            "limit_in_bytes": self.limit_bytes,
        }}


#: process-wide default (same documented-singleton pattern as breakers)
DEFAULT = IndexingPressure()
