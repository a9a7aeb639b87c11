"""Host runtimes around the device plane."""

from . import checkpoint  # noqa: F401
from .bulk import BulkDriver, BulkResult, drive_batch  # noqa: F401
from .device_resources import (  # noqa: F401
    DeviceElection,
    DeviceLock,
    DeviceLong,
    DeviceMap,
    DeviceMultiMap,
    DeviceQueue,
    DeviceResourceError,
    DeviceSet,
    DeviceTopic,
    DeviceValue,
)
from .raft_groups import RaftGroups  # noqa: F401
from .session_client import (  # noqa: F401
    BulkSession,
    BulkSessionClient,
    CommandIndeterminateError,
    SessionEvent,
)
