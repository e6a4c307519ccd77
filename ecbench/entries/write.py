"""`write`: a whole-object EC write on the OSD's object path.

Each op is `ecutil.encode_object_async` + `EncodeHandle.result` of one
pool object, with the HBM cache intent an OSD tags a write with, then
the cache commit, as `_ec_write` does once the shards are applied.
"""

from __future__ import annotations

import numpy as np

from ecbench.entries import RESULT_TIMEOUT, Entry
from ecbench.reference import control, encode_object

CACHE_CID = "ecbench"


class Write(Entry):
    kind = "write"
    marks = ("ecutil.encode_object_async", "EncodeHandle.result")

    def warm_shapes(self) -> list:
        return self.encode_shapes()

    def op(self, i: int):
        ctx = self.ctx
        idx = self.object_of(i)
        payload = memoryview(ctx.pool[idx])
        if self.control:
            return self.object_bytes, (idx,) + control.encode_xor_parity(
                self.profile, payload)
        oid, version = f"obj{idx}", (1, i)
        intent = ctx.hbm_cache.CacheIntent(
            CACHE_CID, oid, version, self.object_bytes, self.L)
        with self.mark("ecutil.encode_object_async"):
            handle = ctx.ecutil.encode_object_async(
                ctx.codec, self.sinfo, payload, cache=intent)
        with self.mark("EncodeHandle.result"):
            shards, crcs = handle.result(RESULT_TIMEOUT)
        ctx.hbm_cache.get().commit(CACHE_CID, oid, version)
        return self.object_bytes, (idx, shards, crcs)

    def check(self, kept: list) -> dict:
        bad_bytes = bad_crcs = 0
        for idx, shards, crcs in kept:
            ref, ref_crcs = encode_object(self.profile, self.ctx.pool[idx])
            got = [np.frombuffer(s, dtype=np.uint8) for s in shards]
            if len(got) != self.km or any(g.size != ref.shape[1]
                                          for g in got):
                bad_bytes += ref.size
            else:
                bad_bytes += int(np.count_nonzero(np.stack(got) != ref))
            crcs = np.asarray(crcs)
            if crcs.shape != ref_crcs.shape:
                bad_crcs += ref_crcs.size
            else:
                bad_crcs += int(np.count_nonzero(
                    crcs.astype(np.uint32) != ref_crcs))
        return {"bad_shard_bytes": bad_bytes, "bad_stripe_crcs": bad_crcs}


ENTRY = Write
