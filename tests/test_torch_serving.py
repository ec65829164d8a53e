"""The port's serving layer, engine surface and CLIs on the CPU.

* The batcher on a fake engine, streams, WAV framing and the voice
  registry: the cases of tests/test_serving.py on `zerovox_tpu_torch.serving`
  (the framing helpers byte-equal to the JAX package's).
* HTTP with a port engine (device="cpu") on the JAX engine's weights, beside
  the JAX package's server on the same weights and voices: each /tts row
  equals the port's direct `tts_batch` bitwise after int16 framing, and the
  JAX server's row within 1e-3 plus one int16 step (the port's waveform
  bound); a stream equals `tts_stream_text` byte for byte; /health and
  /voices agree with the JAX server's; an abandoned stream leaves the
  server serving.
* The engine surface the serving CLI uses: bundled and ZEROVOX_REFAUDIO_DIR
  speaker references, `warmup(batch_sizes=)`, `summary` (the JAX engine's
  counts).
* The CLIs run on the card by default and raise without one.
"""

import dataclasses
import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from zerovox_tpu.serving import VoiceRegistry as JaxVoiceRegistry, make_server as jax_make_server
from zerovox_tpu.serving import server as jserver
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.cli import demo, serve
from zerovox_tpu_torch.dsp.audio import save_wav
from zerovox_tpu_torch.models.hifigan import HifiGanConfig
from zerovox_tpu_torch.serving import (STREAM_EOS, DynamicBatcher, VoiceRegistry, make_server,
                                       serve_in_thread)
from zerovox_tpu_torch.serving.server import _pcm16_bytes, _wav_bytes, _wav_stream_header
from zerovox_tpu_torch.synthesize import DEFAULT_REFAUDIO, ZeroVoxTTS

from test_synthesize import SMALL_MELDEC, small_cfg

BATCH_TEXTS = ["One.", "Two two.", "Three three three.", "Four."]
STREAM_TEXT = "First sentence here. Second sentence follows."


class FakeEngine:
    """Records tts_batch call sizes; returns per-row deterministic wavs."""

    def __init__(self, delay_s: float = 0.0, fail: bool = False):
        self.calls: list[int] = []
        self.delay_s = delay_s
        self.fail = fail

    def tts_batch(self, texts, spkembs):
        assert spkembs.shape[0] == len(texts)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("boom")
        self.calls.append(len(texts))
        return [(np.full(8, float(len(t)), np.float32), len(t)) for t in texts]

    def tts_stream_text(self, text, spkemb, chunk_frames=96):
        for w in text.split():  # one chunk per word, its value the word's length
            if w == "FAIL":
                raise RuntimeError("stream boom")
            yield np.full(4, float(len(w)), np.float32)


EMB = np.zeros((1, 1, 4), np.float32)


def _drain(q, timeout=5):
    got = []
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_EOS:
            return got
        got.append(item[0])


class TestDynamicBatcher:
    def test_single_request_resolves(self):
        b = DynamicBatcher(FakeEngine(), max_batch=4, max_delay_ms=5)
        try:
            wav, mel_len = b.submit("abc", EMB).result(timeout=5)
            assert mel_len == 3 and wav[0] == 3.0
            assert b.stats.requests == 1 and b.stats.batches == 1
        finally:
            b.close()

    def test_concurrent_requests_coalesce(self):
        b = DynamicBatcher(FakeEngine(delay_s=0.15), max_batch=8, max_delay_ms=30)
        try:
            futs = [b.submit("x" * (i + 1), EMB) for i in range(5)]
            outs = [f.result(timeout=10) for f in futs]
            assert [m for _, m in outs] == [1, 2, 3, 4, 5]  # row i is request i's
            assert b.stats.batches < 5 and b.stats.max_batch_seen >= 2
        finally:
            b.close()

    def test_max_batch_bounds_window(self):
        eng = FakeEngine(delay_s=0.1)
        b = DynamicBatcher(eng, max_batch=2, max_delay_ms=200)
        try:
            for f in [b.submit("yy", EMB) for _ in range(5)]:
                f.result(timeout=10)
            assert max(eng.calls) <= 2
        finally:
            b.close()

    def test_engine_error_propagates_to_all(self):
        b = DynamicBatcher(FakeEngine(fail=True), max_batch=4, max_delay_ms=5)
        try:
            for f in [b.submit("z", EMB) for _ in range(3)]:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=5)
            assert b.stats.errors == 3
        finally:
            b.close()

    def test_idle_backoff_shrinks_window_and_a_burst_restores_it(self):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=8, max_delay_ms=40)
        try:
            assert b._cur_delay_s == pytest.approx(0.040)
            for _ in range(13):
                b.submit("a", EMB).result(timeout=5)
            assert b._cur_delay_s == pytest.approx(DynamicBatcher.MIN_DELAY_S)
            t0 = time.monotonic()
            b.submit("abc", EMB).result(timeout=5)
            assert time.monotonic() - t0 < 0.040
            eng.delay_s = 0.1  # a burst queued behind a busy engine coalesces
            for f in [b.submit("x" * (i + 1), EMB) for i in range(5)]:
                f.result(timeout=10)
            assert b.stats.max_batch_seen >= 2
            assert b._cur_delay_s == pytest.approx(0.040)
        finally:
            b.close()

    def test_close_rejects_new_submits(self):
        b = DynamicBatcher(FakeEngine(), max_batch=2, max_delay_ms=5)
        b.close()
        with pytest.raises(RuntimeError):
            b.submit("a", EMB)
        with pytest.raises(RuntimeError):
            b.submit_stream("a", EMB)


class TestStreamDispatch:
    def test_stream_chunks_then_eos(self):
        b = DynamicBatcher(FakeEngine(), max_batch=4, max_delay_ms=5)
        try:
            assert _drain(b.submit_stream("one four ab", EMB)) == [3.0, 4.0, 2.0]
            assert b.stats.streams == 1 and b.stats.stream_chunks == 3
        finally:
            b.close()

    def test_first_chunk_before_synthesis_finishes(self):
        release = threading.Event()

        class Eng(FakeEngine):
            def tts_stream_text(self, text, spkemb, chunk_frames=96):
                yield np.full(4, 1.0, np.float32)
                assert release.wait(10), "consumer never saw chunk 1"
                yield np.full(4, 2.0, np.float32)

        b = DynamicBatcher(Eng(), max_batch=4, max_delay_ms=5)
        try:
            q = b.submit_stream("x", EMB)
            assert q.get(timeout=5)[0] == 1.0
            release.set()
            assert q.get(timeout=5)[0] == 2.0
            assert q.get(timeout=5) is STREAM_EOS
        finally:
            b.close()

    def test_stream_error_propagates_after_partial(self):
        b = DynamicBatcher(FakeEngine(), max_batch=4, max_delay_ms=5)
        try:
            q = b.submit_stream("ok FAIL never", EMB)
            assert q.get(timeout=5)[0] == 2.0
            err = q.get(timeout=5)
            assert isinstance(err, RuntimeError) and "stream boom" in str(err)
            assert b.stats.errors == 1
        finally:
            b.close()

    def test_batch_completes_while_stream_active(self):
        stream_may_end = threading.Event()

        class Eng(FakeEngine):
            def tts_stream_text(self, text, spkemb, chunk_frames=96):
                while not stream_may_end.is_set():
                    yield np.zeros(4, np.float32)
                    time.sleep(0.005)

        b = DynamicBatcher(Eng(), max_batch=4, max_delay_ms=5)
        try:
            q = b.submit_stream("endless", EMB)
            assert q.get(timeout=5) is not STREAM_EOS
            _, mel_len = b.submit("abcde", EMB).result(timeout=10)  # interleaved
            assert mel_len == 5
            stream_may_end.set()
            while q.get(timeout=10) is not STREAM_EOS:
                pass
            assert b.stats.streams == 1 and b.stats.requests == 1
        finally:
            stream_may_end.set()
            b.close()

    def test_two_streams_round_robin_and_serialize_with_batches(self):
        b = DynamicBatcher(FakeEngine(delay_s=0.02), max_batch=8, max_delay_ms=50)
        try:
            futs = [b.submit("yy", EMB) for _ in range(3)]
            qa = b.submit_stream("aa bb cc", EMB)
            qb = b.submit_stream("x y z", EMB)
            futs += [b.submit("zzz", EMB) for _ in range(2)]
            for f in futs:
                f.result(timeout=10)
            assert _drain(qa) == [2.0, 2.0, 2.0] and _drain(qb) == [1.0, 1.0, 1.0]
            assert b.stats.requests == 5 and b.stats.streams == 2
        finally:
            b.close()


class TestFramingAndVoices:
    def test_framing_equals_the_jax_package(self):
        wav = np.sin(np.linspace(0, 30, 1000)).astype(np.float32) * 0.5
        data = _wav_bytes(wav, 22050)
        assert data == jserver._wav_bytes(wav, 22050)
        with wave.open(io.BytesIO(data)) as w:
            assert (w.getframerate(), w.getnchannels()) == (22050, 1)
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        np.testing.assert_allclose(pcm / 32767.0, wav, atol=1.0 / 32767)
        i16 = (wav * 32760).astype(np.int16)
        assert _wav_bytes(i16, 16000) == jserver._wav_bytes(i16, 16000)
        assert _pcm16_bytes(wav * 3) == jserver._pcm16_bytes(wav * 3)
        assert _wav_stream_header(22050) == jserver._wav_stream_header(22050)

    def test_registry_keeps_host_float32(self):
        reg = VoiceRegistry()
        with pytest.raises(KeyError):
            reg.get(None)
        reg.add("b", np.ones((1, 1, 4), np.float64))
        reg.add("a", 2 * torch.ones((1, 1, 4)))
        assert reg.names() == ["a", "b"]
        assert isinstance(reg.get(None), np.ndarray) and reg.get(None).dtype == np.float32
        assert reg.get(None)[0, 0, 0] == 2.0 and reg.get("b")[0, 0, 0] == 1.0
        with pytest.raises(KeyError):
            reg.get("missing")
        with pytest.raises(ValueError):
            reg.add("c", np.ones((2, 1, 4)))


# ---------------------------------------------------------------------------
# engines and servers
# ---------------------------------------------------------------------------


def _port_cfg():
    return pc.ZeroVoxConfig(model=pc.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=pc.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=pc.DecoderConfig(kind="fastspeech2", n_layers=1, n_head=2, conv_filter_size=64)))


@pytest.fixture(scope="module")
def engines():
    """The JAX engine of tests/test_serving.py and the port's on its weights."""
    jax_tts = JaxTTS.from_random(small_cfg(), SMALL_MELDEC, seed=0)
    port = ZeroVoxTTS.from_jax_variables(
        _port_cfg(), jax.tree.map(np.asarray, jax_tts._variables),
        HifiGanConfig(**dataclasses.asdict(SMALL_MELDEC)),
        jax.tree.map(np.asarray, jax_tts._meldec_variables), device="cpu")
    return jax_tts, port


@pytest.fixture(scope="module")
def servers(engines):
    """The port's and the JAX package's servers on the same weights and
    voices (the port engine's embeddings; the port's registry is given the
    tensors). max_batch 4 with a long window: 4 concurrent requests form
    one batch. Each engine's tts_batch calls are recorded."""
    jax_tts, port = engines
    rng = np.random.default_rng(1)
    voices, jax_voices = VoiceRegistry(), JaxVoiceRegistry()
    for name in ("alice", "bob"):
        emb = port.speaker_embed(rng.normal(size=12000).astype(np.float32) * 0.2)
        voices.add(name, emb)
        jax_voices.add(name, emb.numpy())
    out = {}
    for key, eng, reg, make in (("port", port, voices, make_server),
                                ("jax", jax_tts, jax_voices, jax_make_server)):
        srv = make(eng, reg, port=0, max_batch=4, max_delay_ms=2000)
        calls = []
        inner = eng.tts_batch

        def recorded(texts, spkembs, inner=inner, calls=calls):
            calls.append(list(texts))
            return inner(texts, spkembs)

        srv.batcher._engine = type("Recorded", (), {
            "tts_batch": staticmethod(recorded), "tts_stream_text": eng.tts_stream_text})()
        serve_in_thread(srv)
        out[key] = (srv, calls)
    yield out
    for srv, _ in out.values():
        srv.shutdown_serving()


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post_tts(srv, payload, timeout=120):
    req = urllib.request.Request(_url(srv, "/tts"), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _pcm(body):
    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _concurrent(srv, texts, voice):
    results = [None] * len(texts)

    def hit(i):
        with _post_tts(srv, {"text": texts[i], "voice": voice}) as r:
            results[i] = (r.read(), int(r.headers["X-Mel-Frames"]))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r is not None for r in results)
    return results


def _stream(srv, text, voice, chunk_frames=32):
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request("POST", "/tts", json.dumps({"text": text, "voice": voice, "stream": True,
                                                 "chunk_frames": chunk_frames}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Transfer-Encoding") == "chunked"
        return resp.read()
    finally:
        conn.close()


def test_tts_rows_equal_direct_tts_batch_and_the_jax_server(servers, engines):
    _, port = engines
    (srv, calls), (jsrv, jcalls) = servers["port"], servers["jax"]
    n0, j0 = len(calls), len(jcalls)
    got = _concurrent(srv, BATCH_TEXTS, "bob")
    want = _concurrent(jsrv, BATCH_TEXTS, "bob")
    assert [len(c) for c in calls[n0:]] == [4] and [len(c) for c in jcalls[j0:]] == [4]
    # the direct call, in the order the batcher formed the batch
    order = calls[n0]
    direct = dict(zip(order, port.tts_batch(order, np.concatenate(
        [srv.voices.get("bob")] * len(order)))))
    for text, (body, frames), (jbody, jframes) in zip(BATCH_TEXTS, got, want):
        wav, mel_len = direct[text]
        assert frames == mel_len == jframes and mel_len >= 1
        pcm = _pcm(body)
        assert pcm.shape == (mel_len * port.cfg.audio.hop_size,)
        np.testing.assert_array_equal(pcm, _pcm(_wav_bytes(wav, port.cfg.audio.sampling_rate)))
        diff = np.abs(pcm.astype(np.int32) - _pcm(jbody).astype(np.int32))
        assert diff.max() <= 1e-3 * 32767 + 1, diff.max()


def test_stream_equals_tts_stream_text(servers, engines):
    _, port = engines
    srv, jsrv = servers["port"][0], servers["jax"][0]
    body, jbody = _stream(srv, STREAM_TEXT, "alice"), _stream(jsrv, STREAM_TEXT, "alice")
    header = _wav_stream_header(port.cfg.audio.sampling_rate)
    assert body[:len(header)] == header == jbody[:len(header)]
    direct = b"".join(_pcm16_bytes(c) for c in port.tts_stream_text(
        STREAM_TEXT, srv.voices.get("alice"), chunk_frames=32))
    assert body[len(header):] == direct and len(direct) > 0
    pcm = np.frombuffer(body[len(header):], np.int16).astype(np.int32)
    jpcm = np.frombuffer(jbody[len(header):], np.int16).astype(np.int32)
    assert pcm.shape == jpcm.shape and np.abs(pcm - jpcm).max() <= 1e-3 * 32767 + 1
    assert srv.batcher.stats.streams >= 1 and srv.batcher.stats.stream_chunks >= 2


def test_health_and_voices_agree_with_the_jax_server(servers):
    got = {}
    for key, (srv, _) in servers.items():
        with urllib.request.urlopen(_url(srv, "/health"), timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(_url(srv, "/voices"), timeout=30) as r:
            got[key] = (health, json.loads(r.read()))
    (h, v), (jh, jv) = got["port"], got["jax"]
    assert v == jv == ["alice", "bob"]
    assert {k: h[k] for k in ("status", "sampling_rate", "voices")} == {
        k: jh[k] for k in ("status", "sampling_rate", "voices")}
    assert set(h) - {"mean_batch_size"} == set(jh) - {"mean_batch_size"}
    assert h["errors"] == 0


def test_an_abandoned_stream_leaves_the_server_serving(servers):
    srv = servers["port"][0]
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("POST", "/tts", json.dumps({"text": STREAM_TEXT + " " + STREAM_TEXT,
                                             "voice": "alice", "stream": True,
                                             "chunk_frames": 16}))
    resp = conn.getresponse()
    assert resp.status == 200
    resp.read1(64)
    conn.close()  # the client goes away mid-stream
    with _post_tts(srv, {"text": "Still here.", "voice": "bob"}) as r:
        assert r.status == 200 and int(r.headers["X-Mel-Frames"]) >= 1
    assert srv.batcher._thread.is_alive() and srv.batcher.stats.errors == 0


def test_bad_requests(servers):
    srv = servers["port"][0]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_tts(srv, {"text": "hi", "voice": "nobody"})
    assert ei.value.code == 400 and json.loads(ei.value.read())["voices"] == ["alice", "bob"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(_url(srv, "/tts"), data=b"not json"),
                               timeout=30)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(srv, "/nope"), timeout=30)
    assert ei.value.code == 404


# ---------------------------------------------------------------------------
# engine surface and CLIs
# ---------------------------------------------------------------------------


def test_speaker_references(tmp_path, monkeypatch):
    bundled = ["de_kerstin.wav", "de_thorsten.wav", "en_kevin.wav", "en_linda.wav", "en_ryan.wav"]
    monkeypatch.delenv("ZEROVOX_REFAUDIO_DIR", raising=False)
    assert ZeroVoxTTS.available_speakerrefs() == JaxTTS.available_speakerrefs() == bundled
    assert DEFAULT_REFAUDIO in bundled
    np.testing.assert_array_equal(ZeroVoxTTS.get_speakerref("en_kevin.wav", 22050),
                                  JaxTTS.get_speakerref("en_kevin.wav", 22050))
    mine = np.sin(np.linspace(0, 200, 16000)).astype(np.float32) * 0.3
    save_wav(tmp_path / "zz_mine.wav", mine, 16000)
    monkeypatch.setenv("ZEROVOX_REFAUDIO_DIR", str(tmp_path))
    assert ZeroVoxTTS.available_speakerrefs() == bundled + ["zz_mine.wav"]
    wav = ZeroVoxTTS.get_speakerref("zz_mine.wav", 22050)
    np.testing.assert_array_equal(wav, JaxTTS.get_speakerref("zz_mine.wav", 22050))
    assert abs(wav.shape[0] - 22050) <= 1
    with pytest.raises(FileNotFoundError):
        ZeroVoxTTS.get_speakerref("absent.wav", 22050)


def test_warmup_runs_tts_batch_at_the_given_sizes(engines, monkeypatch):
    _, port = engines
    sizes = []
    inner = port.tts_batch

    def recorded(texts, spkembs, durations=None):
        sizes.append((len(texts), tuple(spkembs.shape)))
        return inner(texts, spkembs, durations)

    monkeypatch.setattr(port, "tts_batch", recorded)
    port.warmup(batch_sizes=(2,))
    assert sizes == [(2, (2, 1, port.cfg.model.emb_size))]


def test_summary_counts_the_jax_engines_parameters(engines, capsys):
    jax_tts, port = engines

    def counts(text):
        return {ln.split(":")[0].strip(): int(ln.split(":")[1].replace(",", ""))
                for ln in text.splitlines() if ":" in ln}

    total_j = jax_tts.summary(depth=1)
    want = capsys.readouterr().out
    total_p = port.summary(depth=1)
    got = capsys.readouterr().out
    assert total_p == total_j > 0
    assert counts(got) == counts(want) and len(counts(got)) == 5


def test_clis_run_on_the_card_and_raise_without_one(monkeypatch):
    assert serve.get_args([]).infer_device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--random-model", "--no-warmup"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--random-model", "Hello."])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--model", "/nonexistent", "Hello."])
