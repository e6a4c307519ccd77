"""Command-line tools of the PyTorch port: the offline pg log dump
(pglog_dump, which the OSD's admin socket also serves), the rbd tool
(rbd_cli), the seeded mixed-door load harness (loadgen) and the kernel
timing probe (kernel_probe, run on the card)."""

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
