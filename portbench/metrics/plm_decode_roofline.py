"""The prosody LM decode's share of its roofline: the least time its work
needs (counts/<config>.py decode_bound_s: each traced call's rows x its
frame bucket, the weights once a call) over the device time of the
plm_decode kernels in the traced stretch, in %."""


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    busy = sum(e - s for n, s, e in run.trace.kernels if "plm_decode" in n) / 1e9
    if busy <= 0:
        return None
    bound = sum(run.counts.decode_bound_s(run.cfg, len(c.keys), c.bucket)
                for c in run.traced_calls if c.ok)
    return 100.0 * bound / busy
