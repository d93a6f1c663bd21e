"""Device idle inside the TTV's stages, in ms per traced call: the part of
the traced stretch in which no kernel, copy or memset ran on the card and
the worker was inside the program span pipeline.duration, pipeline.latent
or pipeline.w2v (harness/gaps.py, by interval intersection)."""
from portbench.harness import gaps


def read(run):
    return gaps.part_ms(run, "ttv")
