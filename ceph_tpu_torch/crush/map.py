"""CRUSH map structures: devices, buckets, rules.

Data model of crush/crush.h: items are devices (id >= 0) or buckets
(id < 0, encoded as -1-index); buckets carry 16.16 fixed-point weights;
rules are step programs (take / choose / chooseleaf / emit).  The map
also carries tunables (choose_total_tries etc., crush/crush.h:180
region) with the modern defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.denc import denc_type

BUCKET_UNIFORM = 1
BUCKET_LIST = 2
BUCKET_TREE = 3
BUCKET_STRAW = 4
BUCKET_STRAW2 = 5

HASH_RJENKINS1 = 0

ITEM_UNDEF = -0x7FFFFFFF   # placeholder in indep results
ITEM_NONE = 0x7FFFFFFF     # hole in indep results

# rule step ops
STEP_TAKE = "take"
STEP_CHOOSE_FIRSTN = "choose_firstn"
STEP_CHOOSE_INDEP = "choose_indep"
STEP_CHOOSELEAF_FIRSTN = "chooseleaf_firstn"
STEP_CHOOSELEAF_INDEP = "chooseleaf_indep"
STEP_EMIT = "emit"
STEP_SET_CHOOSE_TRIES = "set_choose_tries"
STEP_SET_CHOOSELEAF_TRIES = "set_chooseleaf_tries"


@denc_type
@dataclass
class Step:
    op: str
    arg1: int = 0
    arg2: int = 0       # bucket type id for choose steps


@denc_type
@dataclass
class Rule:
    name: str
    steps: list[Step]
    ruleset: int = 0
    type: str = "replicated"     # replicated | erasure
    min_size: int = 1
    max_size: int = 10


@denc_type
@dataclass
class Bucket:
    id: int                       # negative
    alg: int
    type: int                     # hierarchy level type id (host=1, ...)
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)   # 16.16 fixed point
    hash: int = HASH_RJENKINS1
    name: str = ""

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    def add_item(self, item: int, weight: int) -> None:
        self.items.append(item)
        self.weights.append(weight)
        self.__dict__.pop("_tree_w", None)   # invalidate tree cache

    def remove_item(self, item: int) -> None:
        i = self.items.index(item)
        del self.items[i]
        del self.weights[i]
        self.__dict__.pop("_tree_w", None)


@denc_type
@dataclass
class Tunables:
    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1


@denc_type
class CrushMap:
    """Hierarchy + rules; placement is map.do_rule (mapper.py)."""

    def __init__(self):
        self.buckets: dict[int, Bucket] = {}        # id (negative) -> bucket
        self.devices: set[int] = set()              # osd ids
        self.types: dict[int, str] = {0: "osd", 1: "host", 2: "rack",
                                      3: "row", 4: "root"}
        self.rules: list[Rule] = []
        self.tunables = Tunables()
        self.max_devices = 0

    # -- construction ------------------------------------------------------

    def add_bucket(self, bucket: Bucket) -> Bucket:
        if bucket.id >= 0:
            raise ValueError("bucket ids must be negative")
        self.buckets[bucket.id] = bucket
        return bucket

    def new_bucket(self, alg: int, type_: int, name: str = "") -> Bucket:
        bid = -1
        while bid in self.buckets:
            bid -= 1
        return self.add_bucket(Bucket(bid, alg, type_, name=name))

    def add_device(self, osd_id: int) -> None:
        self.devices.add(osd_id)
        self.max_devices = max(self.max_devices, osd_id + 1)

    def add_rule(self, rule: Rule) -> int:
        self.rules.append(rule)
        return len(self.rules) - 1

    def bucket_by_name(self, name: str) -> Bucket | None:
        for b in self.buckets.values():
            if b.name == name:
                return b
        return None

    def rule_by_name(self, name: str) -> tuple[int, Rule] | None:
        for i, r in enumerate(self.rules):
            if r.name == name:
                return i, r
        return None

    # -- convenience builders ---------------------------------------------

    @staticmethod
    def build_flat(num_osds: int, hosts: int = 0,
                   weight: float = 1.0) -> "CrushMap":
        """root -> (optional hosts) -> osds, straw2 everywhere, one
        replicated rule — the vstart-style default map."""
        m = CrushMap()
        w = int(weight * 0x10000)
        root = m.new_bucket(BUCKET_STRAW2, 4, name="default")
        if hosts <= 0:
            for i in range(num_osds):
                m.add_device(i)
                root.add_item(i, w)
        else:
            per = -(-num_osds // hosts)
            osd = 0
            for h in range(hosts):
                hb = m.new_bucket(BUCKET_STRAW2, 1, name=f"host{h}")
                for _ in range(per):
                    if osd >= num_osds:
                        break
                    m.add_device(osd)
                    hb.add_item(osd, w)
                    osd += 1
                root.add_item(hb.id, hb.weight)
        leaf_type = 0 if hosts <= 0 else 1
        m.add_rule(Rule("replicated_rule", [
            Step(STEP_TAKE, root.id),
            Step(STEP_CHOOSELEAF_FIRSTN, 0, leaf_type)
            if hosts > 0 else Step(STEP_CHOOSE_FIRSTN, 0, 0),
            Step(STEP_EMIT),
        ]))
        return m

    def make_erasure_rule(self, name: str, k: int, m_: int,
                          root_name: str = "default") -> int:
        """indep rule for an EC pool: k+m distinct leaves."""
        root = self.bucket_by_name(root_name)
        if root is None:
            raise ValueError(f"no bucket named {root_name}")
        return self.add_rule(Rule(name, [
            Step(STEP_SET_CHOOSELEAF_TRIES, 5),
            Step(STEP_TAKE, root.id),
            Step(STEP_CHOOSE_INDEP, 0, 0),
            Step(STEP_EMIT),
        ], type="erasure", min_size=k, max_size=k + m_))
