"""Throughput: seconds of output audio of the requests that returned
inside the window, over the window's seconds."""


def read(run):
    done_in = [s for s in run.sent if s.ok and s.done <= run.t_end]
    return sum(len(s.wav) for s in done_in) / run.output_sr / run.seconds
