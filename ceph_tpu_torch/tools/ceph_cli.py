"""The `ceph` admin CLI (ceph.in analog): mon command front-end.

    python -m ceph_tpu_torch.tools.ceph_cli -c ceph.conf status
    ... osd tree | osd dump | osd pool ls
    ... osd pool create <name> [pg_num]
    ... osd erasure-code-profile set <name> k=4 m=2 plugin=tpu
    ... osd down|out|in <id>
    ... osd tier add <pool> <tierpool> | osd tier cache-mode <pool> <mode>
    ... osd tier set-overlay <pool> <overlaypool>
    ... osd pool set <pool> <var> <val>
    ... pg scrub|deep-scrub|repair <pgid>
    ... daemon <asok-path> <command>       (admin socket passthrough)
"""

from __future__ import annotations

import argparse
import json
import sys

from . import connect_from_conf

# prefix word-counts tried longest-first when parsing free-form argv
_KNOWN_PREFIXES = [
    "osd pool selfmanaged-snap create", "osd pool selfmanaged-snap rm",
    "osd erasure-code-profile set", "osd erasure-code-profile get",
    "osd erasure-code-profile ls", "osd erasure-code-profile rm",
    "osd pool create", "osd pool rm", "osd pool ls",
    "osd tree", "osd dump", "osd getmap", "osd down", "osd out",
    "osd in", "osd reweight", "status",
    "osd tier add", "osd tier remove", "osd tier cache-mode",
    "osd tier set-overlay", "osd tier remove-overlay", "osd pool set",
    "pg scrub", "pg deep-scrub", "pg repair",
]
# the argument names of the positional words after each prefix above,
# as the mon's handlers read them
_POSITIONAL = {
    "osd tier add": ("pool", "tierpool"),
    "osd tier remove": ("pool", "tierpool"),
    "osd tier cache-mode": ("pool", "mode"),
    "osd tier set-overlay": ("pool", "overlaypool"),
    "osd tier remove-overlay": ("pool",),
    "osd pool set": ("pool", "var", "val"),
    "pg scrub": ("pgid",), "pg deep-scrub": ("pgid",),
    "pg repair": ("pgid",),
}


def parse_command(words: list[str]) -> dict:
    """argv words -> mon command dict (ceph_argparse lite)."""
    for prefix in sorted(_KNOWN_PREFIXES, key=len, reverse=True):
        pwords = prefix.split()
        if words[: len(pwords)] == pwords:
            rest = words[len(pwords):]
            cmd: dict = {"prefix": prefix}
            if prefix == "osd pool create":
                # <pool> [<pg_num> [<pgp_num>]] [replicated|erasure
                # [<erasure_code_profile>]], as upstream's ceph CLI
                cmd["pool"] = rest[0]
                nums = [w for w in rest[1:3] if w.isdigit()]
                if nums:
                    cmd["pg_num"] = int(nums[0])
                kind = rest[1 + len(nums):]
                if kind and kind[0] in ("replicated", "erasure"):
                    cmd["pool_type"] = kind[0]
                    if kind[0] == "erasure" and len(kind) > 1:
                        cmd["erasure_code_profile"] = kind[1]
            elif prefix in ("osd pool rm",):
                cmd["pool"] = rest[0]
            elif prefix == "osd erasure-code-profile set":
                cmd["name"] = rest[0]
                cmd["profile"] = [kv for kv in rest[1:]]
            elif prefix in ("osd erasure-code-profile get",
                            "osd erasure-code-profile rm"):
                cmd["name"] = rest[0]
            elif prefix in ("osd down", "osd out", "osd in"):
                cmd["id"] = int(rest[0])
            elif prefix == "osd reweight":
                cmd["id"] = int(rest[0])
                cmd["weight"] = float(rest[1])
            elif prefix in _POSITIONAL:
                cmd.update(zip(_POSITIONAL[prefix], rest))
            elif prefix == "osd pool selfmanaged-snap create":
                cmd["pool"] = rest[0]
            elif prefix == "osd pool selfmanaged-snap rm":
                cmd["pool"] = rest[0]
                cmd["snapid"] = int(rest[1])
            return cmd
    return {"prefix": " ".join(words)}


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="ceph")
    parser.add_argument("-c", "--conf")
    parser.add_argument("-o", "--output",
                        help="write the command's binary payload here "
                             "(e.g. osd getmap -o map.bin)")
    parser.add_argument("words", nargs="+")
    args = parser.parse_args(argv)

    if args.words[0] == "daemon":
        from ..utils.admin_socket import admin_command
        path, cmd_words = args.words[1], args.words[2:]
        result = admin_command(path, {"prefix": " ".join(cmd_words)})
        print(json.dumps(result, indent=2, default=str), file=out)
        return 0

    try:
        cmd = parse_command(args.words)
    except IndexError:
        print(f"error: incomplete command: {' '.join(args.words)}",
              file=sys.stderr)
        return 2
    r = connect_from_conf(args.conf)
    try:
        rv, outs, data = r.mon_command(cmd)
        if outs:
            print(outs, file=out)
        if data:
            if args.output:
                with open(args.output, "wb") as f:
                    f.write(data)
                print(f"wrote {len(data)} bytes to {args.output}",
                      file=out)
            elif out is sys.stdout and not sys.stdout.isatty():
                out.flush()     # text layer is block-buffered on pipes;
                                # unflushed outs would trail the binary
                sys.stdout.buffer.write(data)
                sys.stdout.buffer.flush()
        if rv != 0:
            print(f"Error: {rv}", file=sys.stderr)
            return 1
        return 0
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
