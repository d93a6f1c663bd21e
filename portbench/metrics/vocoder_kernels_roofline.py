"""The vocoder and SpeechSR kernels' share of their roofline: the sum of
each launch's least time (counts/<config>.py vocoder_bound_s at each
traced call's rows and frame bucket) over the device time of the
snake_conv, aa_snakebeta, triple_avg and triple_post kernels in the traced
stretch, in %."""

NAMES = ("snake_conv", "aa_snakebeta", "triple_avg", "triple_post")


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    busy = sum(e - s for n, s, e in run.trace.kernels
               if any(k in n for k in NAMES)) / 1e9
    if busy <= 0:
        return None
    bound = sum(run.counts.vocoder_bound_s(run.cfg, len(c.keys), c.bucket)
                for c in run.traced_calls if c.ok)
    return 100.0 * bound / busy
