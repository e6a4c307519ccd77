"""The entries of the OSD's EC object path that traffic mixes drive.

A mix (`traffic/<mix>.json`) names its entry; the entry is the module
`entries/<entry>.py`, found by that name (`manifest.Cell.entry`), whose
`ENTRY` class runs one op at a time from the op threads.  A new entry is
a new file: no registry lists them.

An entry class gives:

  kind           the name the metric readers see (`rec["entry"]`);
  marks          the `record_function` names around its calls into the
                 port, which label the trace's idle gaps;
  warm_shapes()  every (kind, matrix, padded shape) its traffic reaches;
  prepare()      the set-up its traffic needs beyond the payload pool;
  op(i)          op `i`: (bytes it served, what `check` needs);
  check(kept)    the numbers compared with the reference, each held to 0.

An op's work depends only on its index: the seed picks the bytes, the
order in which the payload pool is visited and, for reads, the order of
lost positions, never sizes, counts or shares.
"""

from __future__ import annotations

import numpy as np

from ecbench.reference import Profile

RESULT_TIMEOUT = 60.0


def warm_buckets(S: int, producers: int, max_batch: int) -> list:
    """Padded stripe counts a coalesced batch of whole S-stripe items
    can reach with `producers` items in flight (next_bucket of every
    j * S the pipeline may coalesce)."""
    out = {1 << (j * S - 1).bit_length() if j * S > 1 else 1
           for j in range(1, producers + 1)
           if j == 1 or j * S <= max_batch}
    return sorted(out)


class Entry:
    """What every entry shares: the port, the codec, the payload pool."""

    kind = ""
    marks: tuple = ()
    lost_n = 0          # shards a read rebuilds per stripe

    def __init__(self, ctx, mix: dict):
        self.ctx = ctx
        self.mix = mix
        cfg = ctx.cfg
        self.profile = Profile.of(cfg["profile"])
        self.k, self.m = self.profile.k, self.profile.m
        self.km = self.k + self.m
        self.object_bytes = int(cfg["object_bytes"])
        self.sinfo = ctx.ecutil.StripeInfo(self.k,
                                           int(cfg["profile"]["stripe_unit"]))
        self.L = self.sinfo.chunk_size
        self.S = self.sinfo.stripe_count(self.object_bytes)
        n = ctx.pool.shape[0]
        self.order = np.random.default_rng([ctx.seed, 1]).permutation(n)
        self.mark = ctx.mark
        self.control = False

    def object_of(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def buckets(self) -> list:
        return warm_buckets(self.S, self.ctx.threads, self.ctx.max_batch)

    def encode_shapes(self) -> list:
        return [("fused", self.ctx.codec.coding_matrix, (S, self.k, self.L))
                for S in self.buckets()]

    def prepare(self) -> None:
        pass
