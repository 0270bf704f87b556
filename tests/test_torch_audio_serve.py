"""The port's audio / music HTTP server (`lumina_t2x_tpu_torch/pipelines/
serve_audio.py`) against the JAX package's: `parse_audio_request`'s
defaults and messages, then the port's server on the tiny debug stack
(`audio_app.build_audio_stack(debug=True)`, random weights from a seed) over
a real socket: the page, health, one POST returning a WAV of the expected
frames, a 400 for a bad request and a 404; and the worker with a text
encoder. The port draws its latent noise from a `torch.Generator`, so its
WAV is held to its shape and format, not to the JAX server's samples.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from lumina_t2x_tpu.pipelines import serve_audio as jsa
from lumina_t2x_tpu_torch.pipelines import serve_audio as tsa
from lumina_t2x_tpu_torch.pipelines.audio_app import AudioWorker, build_audio_stack
from lumina_t2x_tpu_torch.pipelines.serve import make_server

BAD = [None, {}, {"prompt": ""}, {"prompt": "x", "steps": 3}, {"prompt": "x", "num_steps": 0},
       {"prompt": "x", "num_steps": 101}, {"prompt": "x", "guidance_scale": 0.5},
       {"prompt": "x", "struct_caption": "yes"}, {"prompt": "x", "seed": None},
       {"prompt": 3}, ["prompt"]]


@pytest.mark.parametrize("payload", BAD, ids=[json.dumps(b) for b in BAD])
def test_parse_audio_request_messages_match_jax(payload):
    with pytest.raises(ValueError) as ours:
        tsa.parse_audio_request(payload)
    with pytest.raises(ValueError) as ref:
        jsa.parse_audio_request(payload)
    assert str(ours.value) == str(ref.value)


def test_parse_audio_request_defaults_match_jax():
    for payload in ({"prompt": "x"}, {"prompt": "x", "num_steps": "7", "guidance_scale": 2,
                                      "struct_caption": "true", "seed": 4}):
        assert tsa.parse_audio_request(payload) == jsa.parse_audio_request(payload)


@pytest.fixture(scope="module")
def server():
    denoiser, vae_decode, vocode = build_audio_stack(debug=True, device="cpu")
    worker = AudioWorker(denoiser, vae_decode, vocode, task="audio", latent_length=16,
                         device="cpu")
    srv = make_server(tsa.AudioDemoApp(worker, task="audio"), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _request(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_round_trip(server):
    status, page = _request(server + "/")
    assert status == 200 and b"Lumina Audio" in page and b"/api/generate" in page
    status, health = _request(server + "/api/health")
    assert status == 200 and json.loads(health) == {"ok": True, "task": "audio"}
    status, body = _request(server + "/api/generate", {
        "prompt": "rain followed by thunder", "struct_caption": True, "num_steps": 2, "seed": 3})
    assert status == 200
    payload = json.loads(body)
    assert payload["sample_rate"] == 16000
    assert payload["metadata"]["prompt"] == "<rain& start>@<thunder& end>"
    with wave.open(io.BytesIO(base64.b64decode(payload["audio_wav_b64"])), "rb") as f:
        # 16 latent frames -> 32 mel frames -> x4 (the debug vocoder's rates)
        assert (f.getnchannels(), f.getsampwidth(), f.getnframes()) == (1, 2, 32 * 4)
    status, body = _request(server + "/api/generate", {"prompt": "x", "num_steps": 0})
    assert status == 400 and json.loads(body) == {"error": "num_steps must be in [1, 100]"}
    assert _request(server + "/nope")[0] == 404


def test_worker_takes_a_text_encoder():
    calls = []

    def encode(prompts):
        calls.append(list(prompts))
        g = torch.Generator().manual_seed(len(prompts[0]))
        return torch.randn(len(prompts), 5, 1024, generator=g), None

    denoiser, vae_decode, vocode = build_audio_stack(debug=True, device="cpu")
    worker = AudioWorker(denoiser, vae_decode, vocode, latent_length=8, text_encode_fn=encode,
                         device="cpu")
    out = worker.generate("a cello", num_steps=2, seed=1)
    assert calls == [["a cello", ""]]
    assert out["mel"].shape == (1, 80, 16) and out["wav"].shape == (1, 64)
    assert np.isfinite(out["wav"]).all() and out["metadata"]["task"] == "music"
