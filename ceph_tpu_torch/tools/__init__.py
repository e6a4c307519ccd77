"""Command-line and offline tools of the PyTorch port (tools/ analog):
the rados, ceph and cephfs-shell CLIs (rados_cli, ceph_cli,
cephfs_shell), crushtool, osdmaptool, monmaptool, authtool, the
objectstore tool, the offline pg log dump (pglog_dump, which the OSD's
admin socket also serves), the Chrome-trace renderer of op dumps
(trace_dump), the rbd tool (rbd_cli), the seeded mixed-door load
harness (loadgen), the static copy and counter audits (copy_audit,
counter_audit) and the kernel timing probe (kernel_probe, run on the
card).  The CLIs run against a port cluster's conf file:

    python -m ceph_tpu_torch.tools.rados_cli -c ceph.conf lspools

Their OSD-side work runs on the card; a CPU run calls
``ceph_tpu_torch.set_device("cpu")`` first, then the tool's ``main``.
"""

from __future__ import annotations


def connect_from_conf(conf_path: str | None, name: str = "client.admin"):
    """Shared CLI bootstrap: conf file -> connected Rados handle."""
    from ..client import Rados
    from ..daemons import load_conf, monmap_from_conf
    conf = load_conf(conf_path, name)
    monmap = monmap_from_conf(conf)
    r = Rados(monmap, name, conf=conf)
    r.connect()
    return r
