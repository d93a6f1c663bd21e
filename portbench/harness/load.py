"""The load generators: an open loop (requests sent at their due times,
whatever the server is doing) and a closed loop (each client sends its
next request when its last one returns). Every time is the host's
monotonic clock; a request's latency runs from when it was due (open
loop) or sent (closed loop) to the moment its waveform was handed back."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class Sent:
    req: object              # traffic.Request
    due: float               # absolute clock time it was due / sent
    sent: float = 0.0
    done: float = 0.0        # 0: not finished
    ok: bool = False
    wav: object = None
    error: str = ""


def _finish(s: Sent, clock):
    def cb(fut):
        t = clock()
        exc = fut.exception()
        if exc is None:
            s.ok, s.wav = True, fut.result()
        else:
            s.error = repr(exc)
        s.done = t
    return cb


def open_loop(submit, requests, t0: float, clock=time.perf_counter,
              sleep=time.sleep):
    """Send each request at t0 + its due time; returns the Sent records in
    due order, with the generator's lateness in each `sent - due`."""
    out = []
    for req in sorted(requests, key=lambda r: r.due):
        s = Sent(req, t0 + req.due)
        wait = s.due - clock()
        if wait > 0:
            sleep(wait)
        s.sent = clock()
        submit(req).add_done_callback(_finish(s, clock))
        out.append(s)
    return out


def closed_loop(submit, next_request, clients: int, t_end: float,
                drain_s: float, clock=time.perf_counter):
    """`clients` threads, each sending a request, waiting for it and
    sending the next, until t_end; then each waits for its last request
    up to drain_s past t_end. Returns the Sent records in send order."""
    out, lock = [], threading.Lock()

    def client():
        while True:
            with lock:
                now = clock()
                if now >= t_end:
                    return
                req = next_request()
                s = Sent(req, now, now)
                out.append(s)
            fut = submit(req)
            fut.add_done_callback(_finish(s, clock))
            try:
                fut.result(timeout=max(0.0, t_end + drain_s - clock()))
            except Exception:  # recorded by the callback, or unfinished
                pass
            if not s.done:
                return

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, t_end + drain_s - clock()) + 5.0)
    with lock:
        return sorted(out, key=lambda s: s.sent)


def wait_all(records, deadline: float, clock=time.perf_counter,
             sleep=time.sleep):
    """Wait until every record is done or the deadline passes."""
    while clock() < deadline and any(not s.done for s in records):
        sleep(0.01)
