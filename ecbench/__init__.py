"""The benchmark of ceph_tpu_torch's EC object path on one NVIDIA GPU.

See README.md; the command is `python3 -m ecbench --workload <name>
--seed <n> --seconds <s> --trace <0|1>`.
"""
