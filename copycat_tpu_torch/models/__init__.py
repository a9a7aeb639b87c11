"""Host runtimes around the device plane."""

from .bulk import BulkDriver, BulkResult, drive_batch  # noqa: F401
from .raft_groups import RaftGroups  # noqa: F401
from .session_client import (  # noqa: F401
    BulkSession,
    BulkSessionClient,
    CommandIndeterminateError,
    SessionEvent,
)
