"""Device idle in the server's own work, in ms per traced call: inside the
program spans server.drain or server.call but outside pipeline.call, so
the straggler window, the grouping and the replies (harness/gaps.py, by
interval intersection). The worker's wait on an empty queue is not in it."""
from portbench.harness import gaps


def read(run):
    return gaps.part_ms(run, "server")
