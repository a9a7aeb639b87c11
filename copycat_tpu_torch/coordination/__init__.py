"""Coordination resources (reference ``coordination/`` module, SURVEY.md §2.1):
lock, leader election, membership group, topic (log pub/sub), message bus
(direct node-to-node messaging with a log-replicated registry)."""

from .lock import DistributedLock
from .election import DistributedLeaderElection
from .group import DistributedMembershipGroup, GroupMember
from .topic import DistributedTopic
from .bus import DistributedMessageBus, Message, MessageConsumer, MessageProducer
from .state import (
    LeaderElectionState,
    LockState,
    MembershipGroupState,
    MessageBusState,
    TopicState,
)

__all__ = [
    "DistributedLock",
    "DistributedLeaderElection",
    "DistributedMembershipGroup",
    "GroupMember",
    "DistributedTopic",
    "DistributedMessageBus",
    "Message",
    "MessageProducer",
    "MessageConsumer",
    "LockState",
    "LeaderElectionState",
    "MembershipGroupState",
    "TopicState",
    "MessageBusState",
]
