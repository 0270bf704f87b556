"""Dependency-free HTTP demo serving (counterpart of
`lumina_t2x_tpu/pipelines/serve.py`): a stdlib `http.server` app in front of
the `InferenceWorker` / `WorkerPool` of `pipelines/demo.py`.

    python -m lumina_t2x_tpu_torch.pipelines.serve --model NextDiT_2B_patch2 --debug

- `--num_workers 1` serves one worker (its lock serializes the device across
  concurrent clients); `--num_workers N` a pool over the first N CUDA
  devices (0: all of them). The HTTP layer is threaded either way.
- Knobs, defaults and ranges are the gradio UI's, enforced by
  `parse_request`.
- Failures come back as HTTP 500 with the traceback in a JSON body.
- PNGs are written by `utils.png_bytes` (no imaging package needed).
- `LUMINA_FUSE_ROPE=1` serves every attention call through the fused-RoPE
  kernels.

Endpoints:

- ``GET  /``              the single-page UI (inline HTML+JS)
- ``GET  /api/health``    liveness, model name, cached-sampler count
- ``POST /api/generate``  JSON `InferenceRequest` fields -> JSON with a
                          base64 PNG (``image_png_b64``) and the metadata
"""

from __future__ import annotations

import argparse
import base64
import json
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import png_bytes
from .demo import (RESOLUTION_CHOICES, InferenceRequest, ModelFailure, build_worker,
                   result_to_image)

# Field name -> (coercion, default) for the JSON API; unknown fields are
# rejected so that a client's typo does not silently give a default image.
_REQUEST_FIELDS = {
    "cap": (str, None),  # required
    "neg_cap": (str, ""),
    "resolution": (str, "1024x1024"),
    "num_sampling_steps": (int, 30),
    "cfg_scale": (float, 4.0),
    "solver": (str, "midpoint"),
    "t_shift": (float, 4.0),
    "seed": (int, 0),
    "scaling_method": (str, "Time-aware"),
    "scaling_watershed": (float, 0.3),
    "proportional_attn": (bool, True),
}


def _coerce(name: str, kind: type, value):
    """Strict coercion: wrong-typed values are rejected (bool("false") is
    True, str(None) is "None"); numeric strings are accepted, because HTML
    forms send them."""
    if kind is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise ValueError(f"field '{name}' must be a boolean")
    if kind is str:
        if isinstance(value, str):
            return value
        raise ValueError(f"field '{name}' must be a string")
    if isinstance(value, bool) or value is None:
        raise ValueError(f"field '{name}' must be {kind.__name__}")
    try:
        return kind(value)
    except (TypeError, ValueError):
        raise ValueError(f"field '{name}' must be {kind.__name__}")


def parse_request(payload: dict) -> InferenceRequest:
    """JSON body -> validated InferenceRequest (raises ValueError with a
    message for the client)."""
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    unknown = set(payload) - set(_REQUEST_FIELDS)
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    if not payload.get("cap"):
        raise ValueError("'cap' (the caption) is required and must be non-empty")
    kwargs = {}
    for name, (kind, default) in _REQUEST_FIELDS.items():
        if name in payload:
            kwargs[name] = _coerce(name, kind, payload[name])
        elif default is not None:
            kwargs[name] = default
    req = InferenceRequest(**kwargs)
    if not 1 <= req.num_sampling_steps <= 70:
        raise ValueError("num_sampling_steps must be in [1, 70]")
    if req.solver not in ("euler", "midpoint", "rk4"):
        raise ValueError("solver must be one of euler/midpoint/rk4")
    if not 1.0 <= req.cfg_scale <= 20.0:
        raise ValueError("cfg_scale must be in [1, 20]")
    # t_shift 0 makes the time grid 0/0; an arbitrary resolution is an
    # unbounded memory request against the serving process
    if not 1.0 <= req.t_shift <= 20.0:
        raise ValueError("t_shift must be in [1, 20]")
    if not 0.0 < req.scaling_watershed <= 1.0:
        raise ValueError("scaling_watershed must be in (0, 1]")
    if req.scaling_method not in ("Time-aware", "None"):
        raise ValueError("scaling_method must be 'Time-aware' or 'None'")
    try:
        wh = req.resolution.split(")")[-1].strip().lower().split("x")
        w, h = int(wh[0]), int(wh[1])
    except (ValueError, IndexError):
        raise ValueError("resolution must look like '1024x1024'")
    if w % 16 or h % 16 or not 64 <= w <= 2048 or not 64 <= h <= 2048:
        raise ValueError("resolution sides must be multiples of 16 in [64, 2048]")
    return req


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Lumina-Next T2I</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:60rem}
 fieldset{border:1px solid #ccc;border-radius:6px;margin-bottom:1rem}
 label{display:block;margin:.4rem 0}
 input[type=text]{width:100%}
 #out img{max-width:100%;border:1px solid #ccc;border-radius:6px}
 #err{color:#b00;white-space:pre-wrap}
 .row{display:flex;gap:2rem}.row>div{flex:1}
</style></head><body>
<h1>Lumina-Next T2I</h1>
<div class="row"><div>
<fieldset><legend>Prompt</legend>
 <label>Caption <input type="text" id="cap" value="a photo of a cat"></label>
 <label>Negative caption <input type="text" id="neg_cap" value=""></label>
</fieldset>
<fieldset><legend>Sampling</legend>
 <label>Resolution <select id="resolution">__RESOLUTIONS__</select></label>
 <label>Steps (1-70) <input type="number" id="num_sampling_steps" value="30" min="1" max="70"></label>
 <label>Solver <select id="solver"><option>euler</option><option selected>midpoint</option><option>rk4</option></select></label>
 <label>Time shift (1-20) <input type="number" id="t_shift" value="4" min="1" max="20"></label>
 <label>CFG scale (1-20) <input type="number" id="cfg_scale" value="4" min="1" max="20" step="0.5"></label>
 <label>Seed <input type="number" id="seed" value="0"></label>
 <label>RoPE scaling <select id="scaling_method"><option selected>Time-aware</option><option>None</option></select></label>
 <label>Scaling watershed <input type="number" id="scaling_watershed" value="0.3" step="0.1"></label>
 <label><input type="checkbox" id="proportional_attn" checked> Proportional attention</label>
</fieldset>
<button id="go">Generate</button> <span id="status"></span>
<div id="err"></div>
</div><div id="out"></div></div>
<script>
const F=["cap","neg_cap","resolution","num_sampling_steps","cfg_scale","solver",
         "t_shift","seed","scaling_method","scaling_watershed","proportional_attn"];
const NUM={num_sampling_steps:parseInt,cfg_scale:parseFloat,t_shift:parseFloat,
           seed:parseInt,scaling_watershed:parseFloat};
document.getElementById("go").onclick = async () => {
  const body={};
  for (const f of F){const el=document.getElementById(f);
    body[f]= el.type==="checkbox"? el.checked : (NUM[f]? NUM[f](el.value): el.value);}
  const st=document.getElementById("status"), err=document.getElementById("err");
  st.textContent="generating (a new setting first calibrates its sampler)..."; err.textContent="";
  try{
    const r=await fetch("/api/generate",{method:"POST",
      headers:{"Content-Type":"application/json"},body:JSON.stringify(body)});
    const j=await r.json();
    if(!r.ok){err.textContent=j.error||r.statusText;st.textContent="";return;}
    document.getElementById("out").innerHTML =
      '<img src="data:image/png;base64,'+j.image_png_b64+'">';
    st.textContent=(j.metadata.elapsed_s||"?")+" s";
  }catch(e){err.textContent=String(e);st.textContent="";}
};
</script></body></html>
""".replace("__RESOLUTIONS__", "".join(
    f"<option{' selected' if r == '1024x1024' else ''}>{r}</option>"
    for r in RESOLUTION_CHOICES))


class DemoApp:
    """The HTTP application: routes in front of a worker or pool (both
    serialize their devices). Split from the socket server so that tests
    can call `handle()` directly."""

    def __init__(self, worker, model_name: str = "unknown"):
        self.worker = worker
        self.model_name = model_name

    # -> (status, content_type, body_bytes)
    def handle(self, method: str, path: str, body: Optional[bytes]):
        if method == "GET" and path in ("/", "/index.html"):
            return 200, "text/html; charset=utf-8", _PAGE.encode()
        if method == "GET" and path == "/api/health":
            return 200, "application/json", json.dumps({
                "ok": True, "model": self.model_name,
                "compiled_samplers": len(self.worker._sampler_cache),
            }).encode()
        if method == "POST" and path == "/api/generate":
            return self._generate(body)
        return 404, "application/json", b'{"error": "not found"}'

    def _generate(self, body: Optional[bytes]):
        try:
            req = parse_request(json.loads(body or b"null"))
        except (ValueError, json.JSONDecodeError) as e:
            return 400, "application/json", json.dumps({"error": str(e)}).encode()
        result = self.worker.infer(req)
        if isinstance(result, ModelFailure):
            return 500, "application/json", json.dumps(
                {"error": f"generation failed:\n{result.error}"}).encode()
        png = png_bytes(result_to_image(result))
        return 200, "application/json", json.dumps({
            "image_png_b64": base64.b64encode(png).decode(),
            "metadata": result["metadata"],
        }).encode()


def make_server(app: DemoApp, host: str = "127.0.0.1", port: int = 7860) -> ThreadingHTTPServer:
    """Bind a threaded HTTP server for `app` (port 0 picks a free port: read
    it back from `server.server_address`)."""

    class Handler(BaseHTTPRequestHandler):
        def _dispatch(self, method):
            # every request gets a response: a bad header is a 400, an
            # unexpected error a 500 with its traceback
            try:
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    status, ctype, payload = (400, "application/json",
                                              b'{"error": "bad Content-Length"}')
                else:
                    body = self.rfile.read(length) if length else None
                    status, ctype, payload = app.handle(method, self.path, body)
            except Exception:  # the serving boundary: report, keep serving
                status, ctype = 500, "application/json"
                payload = json.dumps(
                    {"error": f"internal error:\n{traceback.format_exc()}"}).encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def log_message(self, fmt, *fmt_args):
            print(f"[serve] {self.address_string()} {fmt % fmt_args}")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(description="lumina-t2x HTTP demo server (PyTorch)")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), or cpu for the plain versions")
    p.add_argument("--debug", action="store_true", help="random weights, no checkpoint")
    p.add_argument("--num_workers", type=int, default=1,
                   help="1 = one worker; N = a pool over the first N CUDA devices; "
                        "0 = every CUDA device")
    args = p.parse_args(argv)

    worker = build_worker(args.model, args.precision, args.ckpt, args.debug,
                          num_workers=args.num_workers, device=args.device)
    server = make_server(DemoApp(worker, model_name=args.model), host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving Lumina demo at http://{host}:{port}/ (model={args.model})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
