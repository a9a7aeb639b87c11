"""Resource SPI (reference ``resource/`` module, SURVEY.md §2.1).

The contract for a distributed object:

- client side: :class:`Resource`/:class:`AbstractResource` wrap every operation
  in a :class:`ResourceCommand`/:class:`ResourceQuery` carrying the configured
  :class:`Consistency` (reference ``AbstractResource.java:73,88``)
- server side: :class:`ResourceStateMachine` + executor unwrap those envelopes
  and dispatch the inner operation (reference ``ResourceStateMachineExecutor.java``)
- ``@resource_info(state_machine=...)`` binds a client resource class to its
  replicated state machine (reference ``ResourceInfo.java:31``)
"""

from .consistency import Consistency
from .operations import DeleteCommand, ResourceCommand, ResourceOperation, ResourceQuery
from .resource import AbstractResource, Resource, resource_info, resource_state_machine_of
from .state_machine import ResourceCommit, ResourceStateMachine, ResourceStateMachineExecutor

__all__ = [
    "Consistency",
    "ResourceCommand",
    "ResourceQuery",
    "ResourceOperation",
    "DeleteCommand",
    "Resource",
    "AbstractResource",
    "resource_info",
    "resource_state_machine_of",
    "ResourceStateMachine",
    "ResourceStateMachineExecutor",
    "ResourceCommit",
]
