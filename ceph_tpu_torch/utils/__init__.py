"""Host runtime pieces the erasure-code path needs: logging (dout),
fault injection (faults), the copy audit, buffer lists, the op tracer
(optracker) and the dmClock tag picker the dispatch pipeline uses."""
