"""A cell run with its control in the program's place.

    python3 -m ecbench.controls --workload <name> --seed <n> --seconds <s>

The reference, breaking one guarantee the configuration states
(`reference/control.py`), serves the cell's traffic instead of the
port; set-up and the check are the cell's own.  Its result must read
`"correct": false`.  The benchmark's own runs never run it.
"""

import sys

from .run import main

if __name__ == "__main__":
    sys.exit(main(control=True))
