"""CRUSH: deterministic pseudorandom placement.

The analog of the reference's crush/ tier (pure math, no I/O —
SURVEY.md §2.1): rjenkins1 hashing (bit-exact with crush/hash.c),
uniform/list/tree/straw/straw2 buckets, and the firstn/indep rule
mapper with the full retry/collision/out semantics of crush/mapper.c.

The straw2 ln lookup tables are generated from their defining formulas
(crush_ln_table.h's documented math) rather than vendored; see ln.py for
the one documented deviation from the reference's table file.
"""

from .hashing import crush_hash32, crush_hash32_2, crush_hash32_3, crush_hash32_4
from .map import (Bucket, CrushMap, Rule, Step,
                  BUCKET_UNIFORM, BUCKET_LIST, BUCKET_TREE, BUCKET_STRAW,
                  BUCKET_STRAW2, ITEM_NONE, ITEM_UNDEF)
from .mapper import do_rule

__all__ = [
    "crush_hash32", "crush_hash32_2", "crush_hash32_3", "crush_hash32_4",
    "CrushMap", "Bucket", "Rule", "Step", "do_rule",
    "BUCKET_UNIFORM", "BUCKET_LIST", "BUCKET_TREE", "BUCKET_STRAW",
    "BUCKET_STRAW2", "ITEM_NONE", "ITEM_UNDEF",
]
