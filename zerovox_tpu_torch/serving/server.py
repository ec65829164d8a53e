"""HTTP serving front over the dynamic batcher.

Standard library only (`http.server`), as the JAX package's. The handler
threads do request parsing and WAV framing; every synthesis goes through
the shared `DynamicBatcher`, so concurrent HTTP clients are micro-batched
into single `tts_batch` calls on the card.

Endpoints:
    GET  /health        -> {"status","sampling_rate","voices",stats...}
    GET  /voices        -> ["voice-name", ...]
    POST /tts           -> audio/wav (16-bit PCM)
         body: {"text": "...", "voice": "<name>"}   (voice optional)
         with "stream": true (and "chunk_frames"): chunked-transfer WAV,
         written as the engine vocodes each window
"""

from __future__ import annotations

import io
import json
import queue
import struct
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from zerovox_tpu_torch.serving.batcher import STREAM_EOS, DynamicBatcher


class VoiceRegistry:
    """Named speaker embeddings, computed once at startup (the speaker
    encoder runs per voice, not per request). Each is kept on the host as
    float32, so the batcher can stack them; the engine moves them to its
    device at each call."""

    def __init__(self):
        self._voices: dict[str, np.ndarray] = {}

    def add(self, name: str, spkemb) -> None:
        if isinstance(spkemb, torch.Tensor):
            spkemb = spkemb.detach().float().cpu()
        emb = np.asarray(spkemb, np.float32)
        if emb.ndim != 3 or emb.shape[0] != 1:
            raise ValueError(f"expected a [1, 1, emb] speaker embedding, got {emb.shape}")
        self._voices[name] = emb

    def add_from_wav(self, name: str, engine, wav: np.ndarray) -> None:
        self.add(name, engine.speaker_embed(wav))

    def names(self) -> list[str]:
        return sorted(self._voices)

    def get(self, name: str | None) -> np.ndarray:
        if not self._voices:
            raise KeyError("no voices registered")
        if name is None:
            return self._voices[self.names()[0]]
        return self._voices[name]


def _wav_bytes(wav: np.ndarray, sampling_rate: int) -> bytes:
    """float32 [-1,1] (or int16) samples -> RIFF/WAVE 16-bit PCM bytes."""
    if wav.dtype != np.int16:
        wav = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(wav.tobytes())
    return buf.getvalue()


def _pcm16_bytes(wav: np.ndarray) -> bytes:
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        wav = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return wav.tobytes()


def _wav_stream_header(sampling_rate: int) -> bytes:
    """RIFF/WAVE 16-bit mono PCM header with unknown (0xFFFFFFFF) sizes —
    the standard streaming-WAV convention (players treat it as 'read until
    the transport ends')."""
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sampling_rate,
                             sampling_rate * 2, 2, 16),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


class _Handler(BaseHTTPRequestHandler):
    # set on the server object by make_server:
    #   server.batcher, server.voices, server.sampling_rate, server.quiet

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 — silence default stderr spam
        if not getattr(self.server, "quiet", True):
            super().log_message(fmt, *args)

    def _send_json(self, code: int, obj: dict | list) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        srv = self.server
        if self.path == "/health":
            self._send_json(200, {
                "status": "ok",
                "sampling_rate": srv.sampling_rate,
                "voices": srv.voices.names(),
                **srv.batcher.stats.as_dict(),
            })
        elif self.path == "/voices":
            self._send_json(200, srv.voices.names())
        else:
            self._send_json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):  # noqa: N802 — http.server API
        if self.path != "/tts":
            self._send_json(404, {"error": f"unknown path {self.path!r}"})
            return
        srv = self.server
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            text = req["text"]
            if not isinstance(text, str) or not text.strip():
                raise ValueError("empty text")
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        try:
            spkemb = srv.voices.get(req.get("voice"))
        except KeyError:
            self._send_json(400, {"error": f"unknown voice {req.get('voice')!r}",
                                  "voices": srv.voices.names()})
            return

        if req.get("stream"):
            self._stream_tts(text, spkemb,
                             int(req.get("chunk_frames", 96) or 96))
            return

        try:
            wav, mel_len = srv.batcher.submit(text, spkemb).result(
                timeout=srv.request_timeout_s)
        except Exception as e:  # noqa: BLE001 — surfaced as a 500
            # str(TimeoutError()) is empty — fall back to the class name
            self._send_json(500, {"error": f"synthesis failed: "
                                           f"{e or type(e).__name__}"})
            return

        body = _wav_bytes(np.asarray(wav), srv.sampling_rate)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Mel-Frames", str(int(mel_len)))
        self.end_headers()
        self.wfile.write(body)

    # ------------------------------------------------------- streaming path

    def _write_http_chunk(self, data: bytes) -> None:
        """One HTTP/1.1 chunked-transfer frame (empty data = terminator)."""
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _stream_tts(self, text: str, spkemb, chunk_frames: int) -> None:
        """Chunked-transfer streaming WAV: audio bytes go out as the engine
        vocodes each window (`tts_stream_text`), so time-to-first-audio is
        one chunk's synthesis, not the whole utterance's."""
        srv = self.server
        chunks = srv.batcher.submit_stream(text, spkemb,
                                           chunk_frames=chunk_frames)
        deadline = time.monotonic() + srv.request_timeout_s

        # hold the status line until the first chunk (or error) so failures
        # before any audio still get a proper 500
        try:
            first = chunks.get(timeout=srv.request_timeout_s)
        except queue.Empty:
            first = TimeoutError("stream start timed out")
        if isinstance(first, Exception) or first is STREAM_EOS:
            err = first if isinstance(first, Exception) else \
                RuntimeError("empty stream (no synthesizable text)")
            self._send_json(500, {"error": f"synthesis failed: "
                                           f"{err or type(err).__name__}"})
            return

        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Stream-Chunk-Frames", str(chunk_frames))
        self.end_headers()
        try:
            self._write_http_chunk(_wav_stream_header(srv.sampling_rate))
            item = first
            while item is not STREAM_EOS:
                if isinstance(item, Exception):
                    break  # mid-stream failure: truncate the transport
                self._write_http_chunk(_pcm16_bytes(item))
                try:
                    item = chunks.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break  # timeout: truncate
            else:
                self._write_http_chunk(b"")  # clean end-of-stream
                return
            # truncated: close without the zero chunk so clients see an
            # aborted transfer rather than a silently-short utterance
            self.close_connection = True
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: drop the connection (the dispatch
            # thread's puts never block — SimpleQueue — so no drain needed)
            self.close_connection = True


def make_server(engine, voices: VoiceRegistry, host: str = "127.0.0.1",
                port: int = 0, max_batch: int = 8, max_delay_ms: float = 20.0,
                request_timeout_s: float = 120.0,
                quiet: bool = True) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; `.serve_forever()` to run.

    `port=0` binds an ephemeral port (tests); `server.server_address`
    reports the bound one. Call `server.shutdown_serving()` to stop both
    the HTTP loop and the batcher."""
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.batcher = DynamicBatcher(engine, max_batch=max_batch,
                                 max_delay_ms=max_delay_ms)
    srv.voices = voices
    srv.sampling_rate = engine.cfg.audio.sampling_rate
    srv.request_timeout_s = request_timeout_s
    srv.quiet = quiet

    def shutdown_serving():
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()

    srv.shutdown_serving = shutdown_serving
    return srv


def serve_in_thread(srv: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="zerovox-http")
    t.start()
    return t
