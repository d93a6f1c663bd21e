"""Model flops utilisation of the pipeline calls: the flops the window's
served rows need at their own lengths (counts/<config>.py row_flops) over
the summed host seconds of the window's pipeline calls, as a share of the
H100's 989 TFLOP/s bf16 peak, in %."""
import math

from portbench.harness.peaks import PEAKS
from portbench.reference.frontend import process_text


def read(run):
    calls = [c for c in run.calls if c.ok]
    seconds = sum(c.t1 - c.t0 for c in calls)
    if not calls or seconds <= 0:
        return None
    flops = 0
    for c in calls:
        dur = c.dur.sum(-1).tolist() if hasattr(c.dur, "sum") else c.dur
        for (text, voice), d in zip(c.keys, dur):
            frames = int(math.ceil(float(d) / 2))
            samples = run.prompt_samples[voice]
            padded = (samples // 16000 + 1) * 16000
            flops += run.counts.row_flops(run.cfg, len(process_text(text)[0]),
                                          padded // 320, samples // 320, frames)
    return 100.0 * flops / seconds / PEAKS["bf16_flops_s"]
