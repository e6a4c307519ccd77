"""The EC kernels' share of their bandwidth roofline over the profiled
stretch, in %: the least time the stretch's work needs at the H100's
3.35 TB/s (NVIDIA's data sheet, SXM, 700 W) over the device time of the
EC kernels that ran.  The work is counted from the ops' unpadded stripes
(the pipeline's `stripes` over the stretch), each input byte read once
and each output byte written once:

  encode stripe   k*L read, m*L + 4*(k+m) written (parity and chunk CRCs)
  decode stripe   k*L read, lost*L written

so it reads the same work whatever kernels, padding or fusion serve it.
"""

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("gf_direct_kernel", "gf_fused_kernel", "crc_segments_kernel",
           "crc_chain_kernel")


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    kernel_s = sum(s for name, s in tr["device_ops"].items()
                   if any(k in name for k in KERNELS))
    stripes = tr["delta"]["pipe"]["stripes"]
    if kernel_s <= 0 or stripes <= 0:
        return None
    k, m, L = rec["k"], rec["m"], rec["L"]
    if rec["entry"] == "write":
        per = k * L + m * L + 4 * (k + m)
    else:
        per = k * L + rec["lost"] * L
    return 100.0 * stripes * per / HBM_BYTES_PER_S / kernel_s
