"""Host runtimes around the device plane."""

from .raft_groups import RaftGroups  # noqa: F401
