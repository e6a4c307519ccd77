"""crushtool analog: build + test CRUSH maps offline (crush/CrushTester,
crush/CrushCompiler — the test/mapping-quality half; compilation from
text is replaced by the programmatic builders).

    python -m ceph_tpu_torch.tools.crushtool --build --num-osds 12 \
        --num-hosts 4 -o map.bin
    python -m ceph_tpu_torch.tools.crushtool -i map.bin --test --rule 0 \
        --num-rep 3 --min-x 0 --max-x 1023 [--show-mappings] \
        [--show-utilization]
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from ..crush.map import ITEM_NONE, CrushMap
from ..crush.mapper import do_rule
from ..utils import denc


def test_map(cmap: CrushMap, rule: int, num_rep: int, min_x: int,
             max_x: int, show_mappings: bool, show_utilization: bool,
             out=sys.stdout) -> dict:
    """CrushTester: mapping completeness + device utilization spread."""
    util: Counter = Counter()
    bad = 0
    total = 0
    for x in range(min_x, max_x + 1):
        osds = do_rule(cmap, rule, x, num_rep)
        total += 1
        live = [o for o in osds if o != ITEM_NONE]
        if len(set(live)) < num_rep:
            bad += 1
        for o in live:
            util[o] += 1
        if show_mappings:
            print(f"CRUSH rule {rule} x {x} {live}", file=out)
    if show_utilization:
        for osd in sorted(util):
            print(f"  device {osd}:\t{util[osd]}", file=out)
    result = {"total": total, "bad_mappings": bad,
              "device_util": dict(util)}
    print(f"checked {total} mappings, {bad} bad", file=out)
    return result


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="crushtool")
    parser.add_argument("--build", action="store_true")
    parser.add_argument("--num-osds", type=int, default=9)
    parser.add_argument("--num-hosts", type=int, default=0)
    parser.add_argument("-o", "--output")
    parser.add_argument("-i", "--input")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--rule", type=int, default=0)
    parser.add_argument("--num-rep", type=int, default=3)
    parser.add_argument("--min-x", type=int, default=0)
    parser.add_argument("--max-x", type=int, default=1023)
    parser.add_argument("--show-mappings", action="store_true")
    parser.add_argument("--show-utilization", action="store_true")
    args = parser.parse_args(argv)

    cmap = None
    if args.build:
        cmap = CrushMap.build_flat(args.num_osds, hosts=args.num_hosts)
        if args.output:
            with open(args.output, "wb") as f:
                f.write(denc.dumps(cmap))
            print(f"wrote crush map to {args.output}", file=out)
    if args.input:
        with open(args.input, "rb") as f:
            cmap = denc.loads(f.read())
    if args.test:
        if cmap is None:
            print("error: need --build or -i for --test",
                  file=sys.stderr)
            return 2
        test_map(cmap, args.rule, args.num_rep, args.min_x, args.max_x,
                 args.show_mappings, args.show_utilization, out=out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
