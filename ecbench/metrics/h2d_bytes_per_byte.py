"""Bytes uploaded to the card by the pipeline in the window per client
(write) or logical (read) byte: padding and re-uploads show above the
plain k/k or (k)/k share."""


def read(rec):
    if not rec["bytes"]:
        return None
    return rec["delta"]["pipe"]["bytes_h2d"] / rec["bytes"]
