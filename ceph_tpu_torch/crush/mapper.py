"""The CRUSH mapper: do_rule with firstn/indep descent.

Semantics ported from crush/mapper.c (crush_do_rule, crush_choose_firstn
at :440 region, crush_choose_indep at :640 region, bucket chooses at
:73-384): same retry accounting (r' = r + ftotal), same collision /
out-device rejection, same chooseleaf recursion including vary_r and
stable, same uniform-bucket permutation cache.  Weights are 16.16 fixed
point; `weight[i] < 0x10000` probabilistically rejects a device (the
reweight mechanism, is_out at mapper.c:385).
"""

from __future__ import annotations

import itertools

from .hashing import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln import crush_ln
from .map import (BUCKET_LIST, BUCKET_STRAW, BUCKET_STRAW2, BUCKET_TREE,
                  BUCKET_UNIFORM, ITEM_NONE, ITEM_UNDEF, Bucket, CrushMap,
                  STEP_CHOOSE_FIRSTN, STEP_CHOOSE_INDEP,
                  STEP_CHOOSELEAF_FIRSTN, STEP_CHOOSELEAF_INDEP, STEP_EMIT,
                  STEP_SET_CHOOSE_TRIES, STEP_SET_CHOOSELEAF_TRIES,
                  STEP_TAKE)

S64_MIN = -(1 << 63)


class _PermWork:
    """Per-(bucket) permutation cache for uniform buckets (perm_choose)."""

    def __init__(self):
        self.perm_x = None
        self.perm_n = 0
        self.perm: list[int] = []


def _perm_choose(bucket: Bucket, work: _PermWork, x: int, r: int) -> int:
    size = bucket.size
    pr = r % size
    if work.perm_x != x or work.perm_n == 0:
        work.perm_x = x
        if pr == 0:
            s = crush_hash32_3(x, bucket.id & 0xFFFFFFFF, 0) % size
            work.perm = [s] + [0] * (size - 1)
            work.perm_n = 0xFFFF
            return bucket.items[s]
        work.perm = list(range(size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        work.perm[1:] = range(1, size)
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < size - 1:
            i = crush_hash32_3(x, bucket.id & 0xFFFFFFFF, p) % (size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def _list_choose(bucket: Bucket, x: int, r: int) -> int:
    sums = list(itertools.accumulate(bucket.weights))
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(x, bucket.items[i] & 0xFFFFFFFF, r,
                           bucket.id & 0xFFFFFFFF) & 0xFFFF
        w = (w * sums[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _tree_weights(bucket: Bucket) -> list[int]:
    """node_weights for the implicit binary tree layout (leaves at odd
    indices 2i+1, internal sums above)."""
    size = bucket.size
    depth = max(1, (size - 1).bit_length() + 1) if size > 1 else 1
    num_nodes = 1 << depth
    w = [0] * num_nodes
    for i in range(size):
        w[2 * i + 1] = bucket.weights[i]
    node = 2
    while node < num_nodes:
        half = node >> 1
        for n in range(node, num_nodes, node * 2):
            w[n] = w[n - half] + (w[n + half] if n + half < num_nodes else 0)
        node <<= 1
    return w


def _tree_choose(bucket: Bucket, x: int, r: int) -> int:
    weights = bucket.__dict__.setdefault("_tree_w", None)
    if weights is None:
        weights = _tree_weights(bucket)
        bucket.__dict__["_tree_w"] = weights
    num_nodes = len(weights)
    n = num_nodes >> 1
    while (n & 1) == 0:  # internal nodes are even, leaves odd
        w = weights[n]
        t = (crush_hash32_4(x, n, r, bucket.id & 0xFFFFFFFF) * w) >> 32
        half = (n & -n) >> 1
        left = n - half
        n = left if t < weights[left] else n + half
    return bucket.items[n >> 1]


def _straw2_choose(bucket: Bucket, x: int, r: int) -> int:
    # BUCKET_STRAW (legacy precomputed-scaler straw) is served by the
    # same draw math; straw2 is the default everywhere in this framework
    high, high_draw = 0, 0
    for i in range(bucket.size):
        w = bucket.weights[i]
        if w:
            u = crush_hash32_3(x, bucket.items[i] & 0xFFFFFFFF, r) & 0xFFFF
            ln = crush_ln(u) - 0x1000000000000
            # C division truncates toward zero (div64_s64); ln < 0
            draw = -((-ln) // w)
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def _bucket_choose(bucket: Bucket, work: _PermWork, x: int, r: int) -> int:
    if bucket.alg == BUCKET_UNIFORM:
        return _perm_choose(bucket, work, x, r)
    if bucket.alg == BUCKET_LIST:
        return _list_choose(bucket, x, r)
    if bucket.alg == BUCKET_TREE:
        return _tree_choose(bucket, x, r)
    if bucket.alg in (BUCKET_STRAW, BUCKET_STRAW2):
        return _straw2_choose(bucket, x, r)
    return bucket.items[0]


class _Work:
    def __init__(self):
        self.per_bucket: dict[int, _PermWork] = {}

    def get(self, bucket_id: int) -> _PermWork:
        return self.per_bucket.setdefault(bucket_id, _PermWork())


def _is_out(weight_map: dict[int, int], item: int, x: int) -> bool:
    w = weight_map.get(item, 0)
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= w


def _item_type(m: CrushMap, item: int) -> int:
    if item >= 0:
        return 0
    bucket = m.buckets.get(item)
    # dangling reference: report an impossible type so callers take
    # their bad-item path (mapper.c's max_buckets guard)
    return bucket.type if bucket is not None else -1


def _choose_firstn(m: CrushMap, work: _Work, bucket: Bucket,
                   weight_map: dict[int, int], x: int, numrep: int,
                   type_: int, out: list[int], outpos: int, out_size: int,
                   tries: int, recurse_tries: int, local_retries: int,
                   local_fallback_retries: int, recurse_to_leaf: bool,
                   vary_r: int, stable: int, out2: list[int] | None,
                   parent_r: int) -> int:
    count = out_size
    for rep in range(0 if stable else outpos, numrep):
        if count <= 0:
            break
        ftotal = 0
        skip_rep = False
        while True:                         # retry_descent
            retry_descent = False
            in_b = bucket
            flocal = 0
            while True:                     # retry_bucket
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_b.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_b.size >> 1)
                            and flocal > local_fallback_retries):
                        item = _perm_choose(in_b, work.get(in_b.id), x, r)
                    else:
                        item = _bucket_choose(in_b, work.get(in_b.id), x, r)
                    if item >= m.max_devices:
                        skip_rep = True
                        break
                    itemtype = _item_type(m, item)
                    if itemtype != type_:
                        if item >= 0 or item not in m.buckets:
                            skip_rep = True
                            break
                        in_b = m.buckets[item]
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = _choose_firstn(
                                m, work, m.buckets[item], weight_map, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0, local_retries,
                                local_fallback_retries, False,
                                vary_r, stable, None, sub_r)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and itemtype == 0:
                        reject = _is_out(weight_map, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_b.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                    if retry_bucket:
                        continue
                break
            if retry_descent:
                continue
            break
        if skip_rep:
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
    return outpos


def _choose_indep(m: CrushMap, work: _Work, bucket: Bucket,
                  weight_map: dict[int, int], x: int, left: int, numrep: int,
                  type_: int, out: list[int], outpos: int, tries: int,
                  recurse_tries: int, recurse_to_leaf: bool,
                  out2: list[int] | None, parent_r: int) -> None:
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = ITEM_UNDEF
        if out2 is not None:
            out2[rep] = ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != ITEM_UNDEF:
                continue
            in_b = bucket
            while True:
                r = rep + parent_r
                if in_b.alg == BUCKET_UNIFORM and in_b.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_b.size == 0:
                    break
                item = _bucket_choose(in_b, work.get(in_b.id), x, r)
                if item >= m.max_devices:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left -= 1
                    break
                itemtype = _item_type(m, item)
                if itemtype != type_:
                    if item >= 0 or item not in m.buckets:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    in_b = m.buckets[item]
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(m, work, m.buckets[item], weight_map,
                                      x, 1, numrep, 0, out2, rep,
                                      recurse_tries, 0, False, None, r)
                        if out2[rep] == ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and _is_out(weight_map, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == ITEM_UNDEF:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] == ITEM_UNDEF:
            out2[rep] = ITEM_NONE


def do_rule(m: CrushMap, ruleno: int, x: int, result_max: int,
            weight_map: dict[int, int] | None = None) -> list[int]:
    """Place input x: returns up to result_max item ids (ITEM_NONE holes
    possible for indep rules)."""
    if not 0 <= ruleno < len(m.rules):
        return []
    if weight_map is None:
        weight_map = {d: 0x10000 for d in m.devices}
    rule = m.rules[ruleno]
    work = _Work()
    t = m.tunables
    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    local_retries = t.choose_local_tries
    local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    w: list[int] = []
    result: list[int] = []
    for step in rule.steps:
        if step.op == STEP_TAKE:
            if step.arg1 in m.buckets or step.arg1 in m.devices:
                w = [step.arg1]
        elif step.op == STEP_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == STEP_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op in (STEP_CHOOSE_FIRSTN, STEP_CHOOSELEAF_FIRSTN,
                         STEP_CHOOSE_INDEP, STEP_CHOOSELEAF_INDEP):
            if not w:
                continue
            firstn = step.op in (STEP_CHOOSE_FIRSTN, STEP_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = step.op in (STEP_CHOOSELEAF_FIRSTN,
                                          STEP_CHOOSELEAF_INDEP)
            o: list[int] = [ITEM_NONE] * result_max
            c: list[int] = [ITEM_NONE] * result_max
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi not in m.buckets:
                    continue
                bucket = m.buckets[wi]
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    osize = _choose_firstn(
                        m, work, bucket, weight_map, x, numrep, step.arg2,
                        o, osize, result_max - osize, choose_tries,
                        recurse_tries, local_retries,
                        local_fallback_retries, recurse_to_leaf,
                        vary_r, stable,
                        c if recurse_to_leaf else None, 0)
                else:
                    out_size = min(numrep, result_max - osize)
                    _choose_indep(
                        m, work, bucket, weight_map, x, out_size, numrep,
                        step.arg2, o, osize, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c if recurse_to_leaf else None, 0)
                    osize += out_size
            w = (c if recurse_to_leaf else o)[:osize]
        elif step.op == STEP_EMIT:
            result.extend(w)
            w = []
    return result[:result_max]
