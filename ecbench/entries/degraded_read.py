"""`degraded_read`: a whole-object read while one data shard is lost.

Each op is `ecutil.decode_object` of one pool object from the k+m-1
shards that survive one lost data shard.  The lost position cycles over
the k data positions in exactly equal shares, each block of k ops a
permutation drawn from the seed.  Set-up writes every pool object's
shards through the port's own encode, as the OSD wrote them before its
peer went down.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ecbench.entries import RESULT_TIMEOUT, Entry
from ecbench.reference import control, encode_object

LOST_TABLE_OPS = 1 << 20        # lost positions drawn ahead, then reused


class DegradedRead(Entry):
    kind = "degraded_read"
    marks = ("ecutil.decode_object",)
    lost_n = 1

    def __init__(self, ctx, mix: dict):
        super().__init__(ctx, mix)
        blocks = -(-LOST_TABLE_OPS // self.k)
        rng = np.random.default_rng([ctx.seed, 2])
        self.lost = rng.permuted(np.tile(np.arange(self.k), (blocks, 1)),
                                 axis=1).reshape(-1)

    def lost_of(self, i: int) -> int:
        return int(self.lost[i % len(self.lost)])

    def warm_shapes(self) -> list:
        codec = self.ctx.codec
        lost = 0        # every pattern's decode rows have one shape
        rows = codec._decode_rows([lost], codec.minimum_to_decode(
            [lost], [c for c in range(self.km) if c != lost]))
        return self.encode_shapes() + [
            ("bytes", rows, (S, self.k, self.L)) for S in self.buckets()]

    def prepare(self) -> None:
        ctx = self.ctx

        def write(idx):
            handle = ctx.ecutil.encode_object_async(
                ctx.codec, self.sinfo, memoryview(ctx.pool[idx]))
            return handle.result(RESULT_TIMEOUT)[0]

        with ThreadPoolExecutor(ctx.threads) as pool:
            self.shards = list(pool.map(write, range(ctx.pool.shape[0])))

    def op(self, i: int):
        ctx = self.ctx
        idx = self.object_of(i)
        lost = self.lost_of(i)
        have = {c: s for c, s in enumerate(self.shards[idx]) if c != lost}
        if self.control:
            out = control.read_without_decode(self.profile, have,
                                              self.object_bytes)
            return self.object_bytes, (idx, lost, [memoryview(out)])
        with self.mark("ecutil.decode_object"):
            rope = ctx.ecutil.decode_object(ctx.codec, self.sinfo, have,
                                            self.object_bytes)
        return self.object_bytes, (idx, lost, rope)

    def check(self, kept: list) -> dict:
        bad_object = bad_survivors = 0
        for idx, lost, rope in kept:
            want = self.ctx.pool[idx]
            segs = [np.frombuffer(s, dtype=np.uint8) for s in rope]
            got = np.concatenate(segs) if segs else np.empty(0, np.uint8)
            if got.size != want.size:
                bad_object += want.size
            else:
                bad_object += int(np.count_nonzero(got != want))
            ref, _ = encode_object(self.profile, want)
            for c, s in enumerate(self.shards[idx]):
                if c != lost:
                    bad_survivors += int(np.count_nonzero(
                        np.frombuffer(s, dtype=np.uint8) != ref[c]))
        return {"bad_object_bytes": bad_object,
                "bad_survivor_bytes": bad_survivors}


ENTRY = DegradedRead
