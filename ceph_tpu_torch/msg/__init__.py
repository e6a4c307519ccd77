"""Typed, policy-driven message transport (msg/ analog).

The cluster's communication backend (the reference's Messenger tier,
msg/Messenger.h:40): reliable ordered delivery of typed messages between
named entities over TCP, with per-peer-class Policy (lossy clients vs
lossless cluster peers), dispatcher fan-in, loopback fast-dispatch and
config-driven fault injection (ms_inject_socket_failures).

The wire is byte-identical to ceph_tpu's, so daemons and clients of
either package talk to one another — plain TCP here, no DPDK/RDMA
analog.
"""

from .message import Message, MessageRegistry, register_message
from .messenger import (Connection, Dispatcher, EntityAddr, Messenger,
                        Policy, create_messenger)

__all__ = ["Message", "MessageRegistry", "register_message", "Messenger",
           "Connection", "Dispatcher", "Policy", "EntityAddr",
           "create_messenger"]
