"""The port's ``serving.py`` on the CPU: ``TranscriptionServer`` and
``serve_http`` around tiny models.

Every batch the server builds is recorded on its way to the device; the
direct transcriber (``inference.py``) on that batch gives the same tokens
and scores, each request's ``Result`` is its row cut after the first eos,
and the rows past the requests are padding (white images, silent waves,
a power-of-two batch). Also: bucket routing (width buckets, audio buckets
rounded up to whole hops, fused requests by their bucket pair),
``batch_stats``, oversize and malformed payloads refused at submit,
concurrent submitters, a device error handed to every waiter of its group,
``stop`` serving what is queued, the HTTP front (.npy, the fused .npz,
/healthz, errors) on 127.0.0.1 at an ephemeral port, and the cuda default
of the server's transcribers. Every wait takes a timeout and every server
is stopped in ``finally``, so a hang fails one test.
"""

import io
import json
import sys
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch_port_common import EOS, IMG_H, SOS

from omr_a2s_multimodal_transformer_tpu_torch import inference
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.serving import TranscriptionServer, serve_http
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

V, MAXLEN = 31, 12
WIDTHS = (40, 64, 96)
AUDIO = (3000, 6000)  # rounded up to whole hops: 3072, 6144
WAIT_S = 60  # the longest any future or join is waited for


def _model(seed, modality="image"):
    return build_model(dict(vocab_size=V, max_seq_len=MAXLEN, input_modality=modality), device="cpu", seed=seed)[0]


@pytest.fixture(scope="module")
def models():
    return _model(1), _model(2, "audio")


@contextmanager
def serving(*args, **kw):
    """A server whose device calls are recorded: [(args, (tokens, scores))]."""
    server = TranscriptionServer(*args, sos_id=SOS, eos_id=EOS, device="cpu", **kw)
    calls, transcribe = [], server._transcribe

    def recording(*a):
        out = transcribe(*a)
        calls.append((a, out))
        return out

    server._transcribe = recording
    try:
        yield server, calls
    finally:
        server.stop(timeout=WAIT_S)


def _image(rng, h, w):
    return rng.integers(0, 255, size=(h, w), dtype=np.uint8)


def _wave(rng, n):
    return (0.1 * rng.standard_normal(n)).astype(np.float32)


def _check_calls(calls, direct, results):
    """Each recorded batch: a power-of-two batch whose direct transcription
    gives the server's tokens (scores within float32 rounding: the CPU's
    kernels may sum in another order in another thread); each result is a
    row of one."""
    rows = []
    for args, (tokens, scores) in calls:
        b = args[0].shape[0]
        assert b & (b - 1) == 0
        t2, s2 = direct(*args)
        torch.testing.assert_close(t2, tokens, rtol=0, atol=0)
        torch.testing.assert_close(s2, scores, rtol=1e-5, atol=1e-6)
        ids, scs = cut_at_eos(tokens, scores, EOS)
        rows += list(zip(ids, scs))
    for r in results:
        assert (r.token_ids, r.scores) in rows and r.latency_s > 0


def test_image_server_routes_pads_and_equals_the_direct_transcriber(models):
    rng = np.random.default_rng(0)
    imgs = [_image(rng, IMG_H, 30), _image(rng, IMG_H - 4, 50), _image(rng, IMG_H, 64), _image(rng, 20, 60)]
    with serving(models[0], "image", image_height=IMG_H, image_widths=WIDTHS, max_wait_ms=500) as (server, calls):
        futures = [server.submit(x) for x in imgs]
        results = [f.result(timeout=WAIT_S) for f in futures]
        assert server.batch_stats() == {"bucket40_b1": 1, "bucket64_b4": 1}
    direct = inference.make_image_transcriber(models[0], SOS, EOS, device="cpu")
    _check_calls(calls, direct, results)
    raw, hw = calls[1][0]  # bucket 64: three requests and one white row of hw (1, 1)
    assert raw.shape == (4, IMG_H, 64) and bool((raw[3] == 255).all()) and hw[3].tolist() == [1, 1]
    assert hw[:3].tolist() == [[IMG_H - 4, 50], [IMG_H, 64], [20, 60]]
    assert all(bool((pad == 255).all()) for pad in (raw[0, IMG_H - 4:], raw[0, :, 50:], raw[2, 20:], raw[2, :, 60:]))
    assert [r.tokens for r in results] == [None] * 4


def test_audio_server_rounds_buckets_to_hops_and_equals_direct(models):
    rng = np.random.default_rng(1)
    waves = [_wave(rng, n) for n in (2000, 3072, 4000)]
    with serving(models[1], "audio", audio_samples=AUDIO, max_wait_ms=500) as (server, calls):
        assert server.audio_samples == (3072, 6144)
        results = [f.result(timeout=WAIT_S) for f in [server.submit(w) for w in waves]]
        assert server.batch_stats() == {"bucket3072_b2": 1, "bucket6144_b1": 1}
    _check_calls(calls, inference.make_audio_transcriber(models[1], SOS, EOS, device="cpu"), results)
    wave, n = calls[0][0]
    assert wave.shape == (2, 3072) and n.tolist() == [2000, 3072] and bool((wave[0, 2000:] == 0).all())


def test_fused_server_groups_bucket_pairs_and_equals_direct(models):
    rng = np.random.default_rng(2)
    pairs = [(_image(rng, IMG_H, 30), _wave(rng, 2000)), (_image(rng, IMG_H, 60), _wave(rng, 5000)),
             (_image(rng, IMG_H, 64), _wave(rng, 6000))]
    with serving(models[0], "fused", audio_model=models[1], alpha=0.3, image_height=IMG_H, image_widths=WIDTHS,
                 audio_samples=AUDIO, max_wait_ms=500) as (server, calls):
        results = [f.result(timeout=WAIT_S) for f in [server.submit(p) for p in pairs]]
        assert server.batch_stats() == {"bucket40x3072_b1": 1, "bucket64x6144_b2": 1}
    fused = inference.make_fused_transcriber(models[0], models[1], SOS, EOS, device="cpu")
    assert all(a[-1] == 0.3 for a, _ in calls)
    _check_calls(calls, fused, results)
    assert all(float(max(r.scores)) <= 1.0 for r in results)  # mixed probabilities


def test_oversize_and_malformed_payloads_are_refused(models):
    rng = np.random.default_rng(3)
    with serving(models[0], "fused", audio_model=models[1], image_height=IMG_H, image_widths=WIDTHS,
                 audio_samples=AUDIO) as (server, calls):
        for bad in ((_image(rng, IMG_H + 1, 30), _wave(rng, 100)), (_image(rng, IMG_H, 97), _wave(rng, 100)),
                    (_image(rng, IMG_H, 30), _wave(rng, 6145)), (_image(rng, IMG_H, 30)[None], _wave(rng, 100)),
                    _image(rng, IMG_H, 30)):
            with pytest.raises(ValueError):
                server.submit(bad)
    assert calls == []
    with pytest.raises(ValueError, match="ladder"):
        TranscriptionServer(models[0], "image", sos_id=SOS, eos_id=EOS, device="cpu")
    with pytest.raises(ValueError, match="sos_id"):
        TranscriptionServer(models[0], "image", image_height=IMG_H, image_widths=WIDTHS, device="cpu")


def test_concurrent_submitters_all_get_their_rows(models):
    """12 client threads (more than the cores), 2 requests each, with a
    short switch interval: every request resolves to a row of a batch of at
    most max_batch, and batch_stats counts every device call (a lost update
    of its counter would break the sum)."""
    n_threads = 12
    rng = np.random.default_rng(4)
    imgs = [_image(rng, IMG_H, int(w)) for w in rng.integers(20, 97, size=2 * n_threads)]
    results = [None] * len(imgs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serving(models[0], "image", image_height=IMG_H, image_widths=WIDTHS, max_batch=4,
                     max_wait_ms=20) as (server, calls):
            start = threading.Barrier(n_threads)

            def client(k):
                start.wait(timeout=WAIT_S)
                for i in (2 * k, 2 * k + 1):
                    results[i] = server.transcribe(imgs[i], timeout=WAIT_S)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT_S)
            assert not any(t.is_alive() for t in threads) and None not in results
            stats = server.batch_stats()
    finally:
        sys.setswitchinterval(interval)
    assert len(calls) == sum(stats.values()) > 1
    assert all(a[0].shape[0] <= 4 for a, _ in calls)
    _check_calls(calls, inference.make_image_transcriber(models[0], SOS, EOS, device="cpu"), results)


def test_a_device_error_reaches_every_waiter_of_its_group(models):
    rng = np.random.default_rng(5)
    with serving(models[0], "image", image_height=IMG_H, image_widths=WIDTHS, max_wait_ms=500) as (server, _):
        def failing(*a):
            raise RuntimeError("device lost")

        server._transcribe = failing
        futures = [server.submit(_image(rng, IMG_H, 30)) for _ in range(2)]
        for f in futures:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=WAIT_S)


def test_stop_serves_what_is_queued_then_refuses(models):
    rng = np.random.default_rng(6)
    with serving(models[0], "image", image_height=IMG_H, image_widths=WIDTHS, max_wait_ms=1000) as (server, _):
        futures = [server.submit(_image(rng, IMG_H, 30)) for _ in range(3)]
        server.stop(timeout=WAIT_S)
        assert all(len(f.result(timeout=WAIT_S).token_ids) >= 1 for f in futures)
        with pytest.raises(RuntimeError, match="stopped"):
            server.submit(_image(rng, IMG_H, 30))
        assert not server._worker.is_alive()


def _post(port, body, path="/transcribe"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy(**arrays):
    buf = io.BytesIO()
    if len(arrays) == 1:
        np.save(buf, next(iter(arrays.values())))
    else:
        np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("modality", ["image", "fused"])
def test_http_front(models, modality):
    rng = np.random.default_rng(7)
    img, wave = _image(rng, IMG_H, 50), _wave(rng, 4000)
    kw = dict(image_height=IMG_H, image_widths=WIDTHS)
    if modality == "fused":
        kw.update(audio_model=models[1], audio_samples=AUDIO)
    with serving(models[0], modality, **kw) as (server, calls):
        httpd = serve_http(server, host="127.0.0.1", port=0)
        try:
            port = httpd.server_address[1]
            body = _npy(image=img, wave=wave) if modality == "fused" else _npy(x=img)
            code, out = _post(port, body)
            assert code == 200 and set(out) == {"token_ids", "tokens", "scores", "latency_s"}
            direct = server.transcribe((img, wave) if modality == "fused" else img, timeout=WAIT_S)
            assert out["token_ids"] == direct.token_ids and out["scores"] == direct.scores
            big = _npy(image=_image(rng, IMG_H, 97), wave=wave) if modality == "fused" else _npy(x=_image(rng, IMG_H, 97))
            code, err = _post(port, big)
            assert code == 400 and "ValueError" in err["error"]
            assert _post(port, body, path="/nope")[0] == 404
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=WAIT_S) as r:
                health = json.loads(r.read())
            assert health == {"ok": True, "batches": server.batch_stats()} and sum(health["batches"].values()) == 2
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_server_transcribers_default_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TranscriptionServer(models[0], "image", sos_id=SOS, eos_id=EOS, image_height=IMG_H, image_widths=WIDTHS)
