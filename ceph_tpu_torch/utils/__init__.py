"""Host runtime pieces the erasure-code path needs: logging (dout),
fault injection (faults), the copy audit and buffer lists."""
