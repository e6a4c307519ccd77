"""Seconds from the process's start to the window's first op: imports,
the kernel libraries, the payload pool, the codec, the warm-ups, the
set-up the traffic needs and the settling stretch."""


def read(rec):
    return rec["setup_s"]
