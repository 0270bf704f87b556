"""Dependency-free HTTP serving of audio / music generation (counterpart of
`lumina_t2x_tpu/pipelines/serve_audio.py`): the image server's stdlib HTTP
pattern (`pipelines/serve.make_server`) over the audio stack, standing in for
the reference's gradio audio and music demos.

    python -m lumina_t2x_tpu_torch.pipelines.serve_audio --task audio

Endpoints:

- ``GET  /``              single-page UI (prompt, knobs, an <audio> player)
- ``GET  /api/health``    liveness and task
- ``POST /api/generate``  JSON {prompt, struct_caption?, guidance_scale?,
                          num_steps?, seed?} -> JSON with a base64 WAV
                          (``audio_wav_b64``) and the request's metadata

The knob ranges are the gradio sliders' (guidance 1-10, steps 1-100); a
request outside them is a 400 with the JAX server's message.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from typing import Optional

import numpy as np

from .audio_app import AudioWorker, build_audio_stack, save_wav
from .serve import _coerce, make_server

_REQUEST_FIELDS = {
    "prompt": (str, None),  # required
    "struct_caption": (bool, False),
    "guidance_scale": (float, 3.0),
    "num_steps": (int, 25),
    "seed": (int, 0),
}


def parse_audio_request(payload: dict) -> dict:
    """JSON body -> validated keywords of `AudioWorker.generate` (raises
    ValueError with a message for the client)."""
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    unknown = set(payload) - set(_REQUEST_FIELDS)
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    if not payload.get("prompt"):
        raise ValueError("'prompt' is required and must be non-empty")
    kwargs = {name: (_coerce(name, kind, payload[name]) if name in payload else default)
              for name, (kind, default) in _REQUEST_FIELDS.items()}
    if not 1 <= kwargs["num_steps"] <= 100:
        raise ValueError("num_steps must be in [1, 100]")
    if not 1.0 <= kwargs["guidance_scale"] <= 10.0:
        raise ValueError("guidance_scale must be in [1, 10]")
    return kwargs


def _to_wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    save_wav(wav, buf, sample_rate=sample_rate)
    return buf.getvalue()


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Lumina Audio</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:48rem}
 label{display:block;margin:.4rem 0} input[type=text]{width:100%}
 #err{color:#b00;white-space:pre-wrap}
</style></head><body>
<h1>Lumina __TASK__</h1>
<label>Prompt <input type="text" id="prompt" value="rain followed by thunder"></label>
<label><input type="checkbox" id="struct_caption"> Structured caption (audio task)</label>
<label>Guidance (1-10) <input type="number" id="guidance_scale" value="3" min="1" max="10" step="0.5"></label>
<label>Steps (1-100) <input type="number" id="num_steps" value="25" min="1" max="100"></label>
<label>Seed <input type="number" id="seed" value="0"></label>
<button id="go">Generate</button> <span id="status"></span>
<div id="err"></div><div id="out"></div>
<script>
document.getElementById("go").onclick = async () => {
  const body = {
    prompt: document.getElementById("prompt").value,
    struct_caption: document.getElementById("struct_caption").checked,
    guidance_scale: parseFloat(document.getElementById("guidance_scale").value),
    num_steps: parseInt(document.getElementById("num_steps").value),
    seed: parseInt(document.getElementById("seed").value)};
  const st=document.getElementById("status"), err=document.getElementById("err");
  st.textContent="generating..."; err.textContent="";
  try{
    const r=await fetch("/api/generate",{method:"POST",
      headers:{"Content-Type":"application/json"},body:JSON.stringify(body)});
    const j=await r.json();
    if(!r.ok){err.textContent=j.error||r.statusText;st.textContent="";return;}
    document.getElementById("out").innerHTML =
      '<audio controls src="data:audio/wav;base64,'+j.audio_wav_b64+'"></audio>';
    st.textContent=(j.metadata.elapsed_s||"?")+" s";
  }catch(e){err.textContent=String(e);st.textContent="";}
};
</script></body></html>
"""


class AudioDemoApp:
    """Routes in front of an `AudioWorker`; the shape of `serve.DemoApp`,
    so `make_server` and the tests drive both the same way."""

    def __init__(self, worker: AudioWorker, task: str = "music"):
        self.worker = worker
        self.task = task

    def handle(self, method: str, path: str, body: Optional[bytes]):
        if method == "GET" and path in ("/", "/index.html"):
            return (200, "text/html; charset=utf-8",
                    _PAGE.replace("__TASK__", self.task.title()).encode())
        if method == "GET" and path == "/api/health":
            return 200, "application/json", json.dumps({"ok": True, "task": self.task}).encode()
        if method == "POST" and path == "/api/generate":
            return self._generate(body)
        return 404, "application/json", b'{"error": "not found"}'

    def _generate(self, body: Optional[bytes]):
        try:
            kwargs = parse_audio_request(json.loads(body or b"null"))
        except (ValueError, json.JSONDecodeError) as e:
            return 400, "application/json", json.dumps({"error": str(e)}).encode()
        try:
            result = self.worker.generate(
                kwargs["prompt"], use_struct=kwargs["struct_caption"],
                guidance_scale=kwargs["guidance_scale"], num_steps=kwargs["num_steps"],
                seed=kwargs["seed"])
        except Exception:  # the serving boundary: report, keep serving
            import traceback

            return 500, "application/json", json.dumps(
                {"error": f"generation failed:\n{traceback.format_exc()}"}).encode()
        wav = _to_wav_bytes(result["wav"][0], result["sample_rate"])
        return 200, "application/json", json.dumps({
            "audio_wav_b64": base64.b64encode(wav).decode(),
            "sample_rate": result["sample_rate"],
            "metadata": result["metadata"],
        }).encode()


def main(argv=None):
    p = argparse.ArgumentParser(description="lumina audio/music HTTP server")
    p.add_argument("--task", choices=["music", "audio"], default="music")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7861)
    p.add_argument("--latent_length", type=int, default=256)
    p.add_argument("--latent_scale_factor", type=float, default=1.0)
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--vocoder_ckpt", type=str, default=None)
    p.add_argument("--debug", action="store_true", help="random weights")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    denoiser_fn, vae_decode, vocode = build_audio_stack(
        debug=args.debug, vae_ckpt=args.vae_ckpt, vocoder_ckpt=args.vocoder_ckpt,
        device=args.device)
    worker = AudioWorker(denoiser_fn, vae_decode, vocode, task=args.task,
                         latent_length=args.latent_length // 2,
                         scale_factor=args.latent_scale_factor, device=args.device)
    server = make_server(AudioDemoApp(worker, task=args.task), host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving Lumina {args.task} at http://{host}:{port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
