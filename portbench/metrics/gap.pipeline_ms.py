"""Device idle in the rest of the pipeline call, in ms per traced call:
inside the program span pipeline.call but outside pipeline.duration,
pipeline.latent, pipeline.w2v, pipeline.vocode and plm.decode, so in
pipeline.rows, pipeline.output and what no stage names
(harness/gaps.py, by interval intersection)."""
from portbench.harness import gaps


def read(run):
    return gaps.part_ms(run, "pipeline")
