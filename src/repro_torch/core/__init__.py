"""Host build plane and batched device query plane of the port, and the
typed Query API surface they answer through (re-exported here as the
reference's ``repro.core`` does)."""

from .query_api import (
    EdgeSet,
    InvalidQueryError,
    Provenance,
    ResultMode,
    TCCSBackend,
    TCCSQuery,
    TCCSResult,
    VersionStore,
    WindowSweep,
)

__all__ = [
    "EdgeSet", "InvalidQueryError", "Provenance", "ResultMode",
    "TCCSBackend", "TCCSQuery", "TCCSResult", "VersionStore", "WindowSweep",
]
