"""The leader mon answers commands while paxos proposals keep coming.

The leader holds a command's ack until the commit that carries its
effect, and holds the ack of a command that arrives while a round is in
flight until that round commits (a read then sees every write acked
before it).  It used to flush those held acks only at a commit that left
no proposal queued.  Every cluster-log entry, pg_temp update, beacon or
boot is a paxos value of its own, so under a steady stream of them (an
EC cluster recovering, OSDs and daemons booting) no commit left the
queue empty, and every held ack, a read's included, waited for the
stream to end: new clients' commands timed out, and daemons hunted for
another mon.  ``Monitor._handle_command`` now notes the version each
held ack needs, and ``Monitor._on_commit`` sends it once that version
has committed.  The reference's ``ceph_tpu/mon/monitor.py`` keeps the
old rule.
"""

import threading
import time

import pytest

import ceph_tpu_torch
from ceph_tpu_torch.vstart import MiniCluster

STREAM_S = 30.0              # the proposal stream's length, at most
ANSWER_S = 5.0               # a command answered within this, or late


@pytest.fixture
def cluster():
    prev = ceph_tpu_torch.set_device("cpu")
    c = MiniCluster(num_mons=3, num_osds=1).start()
    try:
        yield c
    finally:
        c.stop()
        ceph_tpu_torch.set_device(prev)


def _stream(mon, stop: threading.Event, until: float) -> None:
    """Cluster-log entries on the leader, so that a proposal is always
    queued behind the round in flight."""
    while not stop.is_set() and time.monotonic() < until:
        with mon.lock:
            while len(mon.paxos.proposals) < 4:
                mon.logmon.log_entry("client.stream", "INF", "entry")
        time.sleep(0.0002)


@pytest.mark.parametrize("cmd", [
    {"prefix": "health"},
    {"prefix": "osd pool create", "pool": "during", "pg_num": 4},
], ids=["read", "write"])
def test_commands_are_answered_under_a_stream_of_proposals(cluster, cmd):
    leader = cluster.leader()
    rados = cluster.client("client.probe")
    stop = threading.Event()
    t = threading.Thread(target=_stream, daemon=True, args=(
        leader, stop, time.monotonic() + STREAM_S))
    t.start()
    try:
        time.sleep(0.5)                      # the stream is running
        v0 = leader.paxos.last_committed
        t0 = time.monotonic()
        rv, out, _ = rados.mon_command(cmd, timeout=STREAM_S + 10)
        took = time.monotonic() - t0
        streaming = t.is_alive()
        commits = leader.paxos.last_committed - v0
    finally:
        stop.set()
        t.join(10)
    assert rv == 0, out
    assert streaming, "the stream ended before the answer: nothing shown"
    assert commits >= 3, f"only {commits} commits while it waited"
    assert took < ANSWER_S, f"answered after {took:.1f} s of the stream"
    if cmd["prefix"] == "osd pool create":
        # acked after the commit that holds it: visible at once
        rv, out, _ = rados.mon_command({"prefix": "osd pool ls"})
        assert "during" in out.split("\n")
