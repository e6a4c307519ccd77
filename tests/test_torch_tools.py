"""The reference's tests of the admin tools (tests/test_tools.py: the
rados, ceph and cephfs-shell CLIs against a live cluster, crushtool,
osdmaptool, monmaptool, authtool, objectstore_tool, pglog_dump and
trace_dump), run against ceph_tpu_torch on the CPU.

Not run here: ``TestStandaloneDaemons::test_process_level_cluster``
starts ``python -m ceph_tpu_torch.daemons mon|osd`` processes, which
keep the package's default device, the card, and raise without one;
``tests/test_torch_daemons.py`` boots those roles as processes on the
CPU instead."""

from _port_reference import run_reference

run_reference(globals(), "test_tools",
              exclude=("TestStandaloneDaemons::test_process_level_cluster",))


def test_ceph_cli_creates_an_erasure_coded_pool(cluster, conf_file,
                                                tmp_path):
    """The port's ceph CLI takes upstream's `osd pool create <pool>
    <pg_num> <pgp_num> erasure <profile>`: a tpu profile set through the
    CLI, an EC pool on it, and a file through rados put/get byte for
    byte."""
    rc, _ = run_tool(ceph_cli.main,
                     ["-c", conf_file, "osd", "erasure-code-profile",
                      "set", "k2m1cli", "k=2", "m=1", "plugin=tpu",
                      "technique=reed_sol_van"])
    assert rc == 0
    rc, _ = run_tool(ceph_cli.main,
                     ["-c", conf_file, "osd", "pool", "create",
                      "ecclipool", "8", "8", "erasure", "k2m1cli"])
    assert rc == 0
    pool = cluster.leader().osdmon.osdmap.pool_by_name("ecclipool")
    assert pool.is_erasure and pool.erasure_code_profile == "k2m1cli"
    src = tmp_path / "in.bin"
    src.write_bytes(bytes(range(256)) * 333)
    end = time.time() + 30
    while True:
        rc, _ = run_tool(rados_cli.main, ["-c", conf_file, "-p",
                                          "ecclipool", "put", "o", str(src)])
        if rc == 0 or time.time() > end:
            break
        cluster.tick(0.3)
    assert rc == 0
    dst = tmp_path / "out.bin"
    rc, _ = run_tool(rados_cli.main, ["-c", conf_file, "-p", "ecclipool",
                                      "get", "o", str(dst)])
    assert rc == 0 and dst.read_bytes() == src.read_bytes()
