"""The port's TTSServer (megatts2_hierspeechpp_torch/infer/server.py): the
stub-pipeline tests of tests/test_server.py, run against it (no device:
grouping by prompt-mel length and kwargs with cross-speaker batches,
singletons for kwargs tts_batch does not take, the absolute straggler
deadline, a failed request failing only its own future), and the small CPU
pipeline of test_torch_tts.py behind it: concurrent requests of one
speaker make one tts_batch call, whose rows equal the direct call's."""
import threading

import numpy as np
import pytest
import torch

import tests.test_server as stub_tests
from megatts2_hierspeechpp_torch.infer.server import TTSServer
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_pipeline import speechsrs  # noqa: F401  (fixture)
from tests.test_torch_tts import TEXT, pipelines  # noqa: F401  (fixture)
from tests.test_torch_vocoder import vocoders  # noqa: F401  (fixture)

STUB_TESTS = ("test_same_prompt_requests_batch",
              "test_unbatchable_kwargs_run_as_singletons",
              "test_distinct_prompts_share_one_batch",
              "test_mismatched_prompt_lengths_split_batches",
              "test_worker_survives_request_errors",
              "test_straggler_window_is_absolute")


@pytest.mark.parametrize("name", STUB_TESTS)
def test_port_server_passes_the_stub_test(name, monkeypatch):
    monkeypatch.setattr(stub_tests, "TTSServer", TTSServer)
    getattr(stub_tests, name)()


def test_worker_runs_in_inference_mode():
    """The worker thread enters torch.inference_mode itself (thread-local)."""
    seen = {}

    class Pipe(stub_tests.StubPipeline):
        def tts(self, text, prompt=None, **kw):
            seen["mode"] = torch.is_inference_mode_enabled()
            seen["thread"] = threading.current_thread()
            return super().tts(text, prompt=prompt, **kw)

    server = TTSServer(Pipe(), max_batch=1, max_wait_ms=1)
    server.submit("aa", stub_tests.StubPrompt()).result(timeout=10)
    server.close()
    assert seen["mode"] is True and seen["thread"] is not threading.current_thread()
    assert not torch.is_inference_mode_enabled()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit("aa", stub_tests.StubPrompt())


def test_server_batches_a_shared_prompt_on_the_cpu_pipeline(pipelines):
    _, tp, audio = pipelines
    pf = tp.prepare_prompt(audio)
    texts = [TEXT, "sil zh ang1 h ao3 sp", "sil n i3 h ao3 sp"]
    direct = tp.tts_batch(texts, prompt=pf, seed=3, noise_scale_vc=0.0)

    calls = {"batch": 0, "single": 0}
    orig_batch, orig_tts = tp.tts_batch, tp.tts

    def spy_batch(*a, **k):
        calls["batch"] += 1
        return orig_batch(*a, **k)

    def spy_tts(*a, **k):
        calls["single"] += 1
        return orig_tts(*a, **k)

    tp.tts_batch, tp.tts = spy_batch, spy_tts
    server = TTSServer(tp, max_batch=4, max_wait_ms=200)
    try:
        futs = [server.submit(t, prompt=pf, seed=3, noise_scale_vc=0.0)
                for t in texts]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        server.close()
        del tp.tts_batch, tp.tts
    assert calls == {"batch": 1, "single": 0}, calls
    for got, want in zip(outs, direct):
        np.testing.assert_allclose(got, want, atol=1e-6)
