"""The reference's tests of cephx-lite auth: keyring, handshake, signing
(tests/test_auth.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_auth")
