"""Interactive demo serving (counterpart of `lumina_t2x_tpu/pipelines/demo.py`).

- One `InferenceWorker` per device holds its own copy of the model and a
  small LRU of samplers keyed on the request's knobs (resolution, steps,
  solver, CFG, t-shift, RoPE scaling, watershed, proportional attention)
  and on `LUMINA_FUSE_ROPE`, which picks the attention path. A new key
  calibrates the static-max bound of the streaming self-attention once,
  under a pool-wide build lock, and the sampler is built with that bound:
  each run uses its own, whatever other keys or workers calibrated (a JAX
  sampler bakes its bound in when it is traced).
- `WorkerPool` fans requests out over devices (default: every CUDA device),
  pick-first-free, else round-robin.
- Failures travel as the `ModelFailure` sentinel with the traceback.
- Captions go through the worker's `text_encode_fn` hook (e.g. a
  `DecoderTextEncoder`'s `encode`), else become hashed pseudo-features (the
  JAX worker's exactly); `vae_decode_fn` (latents -> images in [-1, 1]) adds
  a uint8 `image` to the result. The served CLI attaches neither, as the
  JAX serving path does not: the result is a latent preview.
- gradio is optional: `main` falls back to the stdlib HTTP server
  (`pipelines/serve.py`) when it is missing.

Every entry point runs on `cuda` unless the caller asks for another device.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import hashed_caption_features


class ModelFailure:
    """Failure sentinel: `error` holds the traceback."""

    def __init__(self, error: str = ""):
        self.error = error


RESOLUTION_CHOICES = [
    "1024x1024", "512x2048", "2048x512", "(Extrapolation) 1664x1664",
    "(Extrapolation) 1024x2048", "(Extrapolation) 2048x1024",
]


@dataclass
class InferenceRequest:
    cap: str
    neg_cap: str = ""
    resolution: str = "1024x1024"
    num_sampling_steps: int = 30
    cfg_scale: float = 4.0
    solver: str = "midpoint"
    t_shift: float = 4.0
    seed: int = 0
    scaling_method: str = "Time-aware"
    scaling_watershed: float = 0.3
    proportional_attn: bool = True


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class InferenceWorker:
    """Holds one model on one device and a sampler per knob bucket.

    `infer` serializes on the worker's lock: one generation owns the device
    at a time. Building a sampler (and its calibration) is exclusive across
    the pool (`compile_lock`). The cache is an LRU of `MAX_CACHED_SAMPLERS`:
    its keys include continuous knobs (CFG, t-shift, watershed).
    """

    MAX_CACHED_SAMPLERS = 8

    def __init__(self, model, *, text_encode_fn=None, vae_decode_fn=None, train_res: int = 1024,
                 cap_feat_dim: int = 2048, device=None, compile_lock=None):
        self.device = torch.device(device) if device is not None else _model_device(model)
        self.model = model.to(self.device)
        self.text_encode_fn = text_encode_fn
        self.vae_decode_fn = vae_decode_fn
        self.train_res = train_res
        self.cap_feat_dim = cap_feat_dim
        self._sampler_cache: Dict[Tuple, object] = {}  # key -> sample_fn
        self._lock = threading.Lock()
        self._compile_lock = compile_lock or threading.Lock()

    def _resolution(self, s: str) -> Tuple[int, int]:
        s = s.split(")")[-1].strip()
        w, h = s.lower().split("x")
        return int(w), int(h)

    def _get_sampler(self, req: InferenceRequest, cap_feats, cap_mask):
        """The sample_fn for the request's knobs and the attention path
        `LUMINA_FUSE_ROPE` selects now, built (and calibrated on these caption
        features) on a miss."""
        w, h = self._resolution(req.resolution)
        key = (w, h, req.num_sampling_steps, req.solver, req.cfg_scale, req.t_shift,
               req.scaling_method, req.scaling_watershed, req.proportional_attn,
               os.environ.get("LUMINA_FUSE_ROPE", "0") == "1")
        if key not in self._sampler_cache:
            with self._compile_lock:
                self._build_sampler(key, req, w, h, cap_feats, cap_mask)
        else:
            self._sampler_cache[key] = self._sampler_cache.pop(key)  # LRU refresh
        return self._sampler_cache[key]

    def _build_sampler(self, key, req: InferenceRequest, w, h, cap_feats, cap_mask):
        from .sample_lib import autocalibrate_flash_static_max, build_t2i_sample_fn

        do_timeaware = req.scaling_method == "Time-aware"
        watershed = req.scaling_watershed if do_timeaware else 1.0
        bound = autocalibrate_flash_static_max(
            self.model, cap_feats, cap_mask, width=w, height=h,
            cfg_scale=req.cfg_scale, time_shifting_factor=req.t_shift,
            train_res=self.train_res, scale_watershed=watershed,
            proportional_attn=req.proportional_attn,
            generator=torch.Generator(self.device).manual_seed(0),
        )
        fn = build_t2i_sample_fn(
            self.model, width=w, height=h, num_steps=req.num_sampling_steps,
            solver=req.solver, cfg_scale=req.cfg_scale, time_shifting_factor=req.t_shift,
            train_res=self.train_res, scale_watershed=watershed,
            proportional_attn=req.proportional_attn,
            # 'None' means no RoPE scaling at all (scale factor and watershed 1)
            time_aware_scaling=do_timeaware, static_max=bound,
        )
        if len(self._sampler_cache) >= self.MAX_CACHED_SAMPLERS:
            del self._sampler_cache[next(iter(self._sampler_cache))]
        self._sampler_cache[key] = fn

    def _encode_captions(self, cap: str, neg_cap: str):
        """(cap_feats (2, Ly, D), cap_mask (2, Ly)) on the device for the
        caption and the negative caption: `text_encode_fn`'s, else
        deterministic hashed pseudo-features (fp32, int32)."""
        if self.text_encode_fn is not None:
            feats, mask = self.text_encode_fn([cap, neg_cap or ""])
            return feats.to(self.device), mask.to(self.device)
        feats = np.stack([hashed_caption_features(c, self.cap_feat_dim)
                          for c in (cap, neg_cap or "")])
        return (torch.from_numpy(feats).to(self.device),
                torch.ones((2, feats.shape[1]), dtype=torch.int32, device=self.device))

    def _noise(self, req: InferenceRequest) -> torch.Tensor:
        w, h = self._resolution(req.resolution)
        gen = torch.Generator(self.device).manual_seed(req.seed)
        return torch.randn((1, self.model.in_channels, h // 8, w // 8), generator=gen,
                           device=self.device)

    def infer(self, req: InferenceRequest):
        """dict(latents=..., metadata=...) or ModelFailure."""
        with self._lock:
            return self._infer_locked(req)

    def _infer_locked(self, req: InferenceRequest):
        try:
            t0 = time.time()
            cap_feats, cap_mask = self._encode_captions(req.cap, req.neg_cap)
            sampler = self._get_sampler(req, cap_feats, cap_mask)
            latents = sampler(self._noise(req), cap_feats, cap_mask)
            out = {"latents": latents.float().cpu().numpy(), "metadata": {
                **req.__dict__, "elapsed_s": round(time.time() - t0, 3),
                "device": str(self.device),
            }}
            print(json.dumps(out["metadata"]))
            if self.vae_decode_fn is not None:
                with torch.no_grad():
                    img = self.vae_decode_fn(latents).float().cpu().numpy()
                out["image"] = np.clip((img + 1) / 2 * 255, 0, 255).astype(np.uint8)
            return out
        except Exception:  # the serving boundary: report, keep serving
            return ModelFailure(traceback.format_exc())


class WorkerPool:
    """One `InferenceWorker` per device, each with its own copy of the model
    (the first device that already holds the model keeps it), sharing one
    build lock. Dispatch is pick-first-free, else round-robin blocking."""

    def __init__(self, model, *, devices=None, **worker_kwargs):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("WorkerPool needs at least one device")
        compile_lock = threading.Lock()
        home, taken = _model_device(model), False
        self.workers = []
        for d in devices:
            same = d.type == home.type and (d.index or 0) == (home.index or 0)
            copy_ = model if same and not taken else copy.deepcopy(model)
            taken = taken or same
            self.workers.append(InferenceWorker(copy_, device=d, compile_lock=compile_lock,
                                                **worker_kwargs))
        self._rr = 0
        self._rr_lock = threading.Lock()

    def __len__(self):
        return len(self.workers)

    @property
    def _sampler_cache(self):
        """Every worker's samplers (the health report counts them)."""
        merged = {}
        for i, w in enumerate(self.workers):
            merged.update({(i, k): v for k, v in w._sampler_cache.items()})
        return merged

    def infer(self, req: InferenceRequest):
        with self._rr_lock:
            start = self._rr
            self._rr = (self._rr + 1) % len(self.workers)
        for off in range(len(self.workers)):
            w = self.workers[(start + off) % len(self.workers)]
            if w._lock.acquire(blocking=False):
                try:
                    return w._infer_locked(req)
                finally:
                    w._lock.release()
        return self.workers[start].infer(req)


def result_to_image(result: dict) -> np.ndarray:
    """Worker result -> HWC uint8: the decoded RGB when a VAE is attached,
    else a min-max-scaled preview of the first three latent channels."""
    if "image" in result:
        return result["image"][0].transpose(1, 2, 0)
    lat = result["latents"][0, :3]
    lat = (lat - lat.min()) / (np.ptp(lat) + 1e-6)
    return (lat.transpose(1, 2, 0) * 255).astype(np.uint8)


def make_submit_handler(worker, error_cls=RuntimeError):
    """The UI's submit round trip (widget values -> InferenceRequest ->
    worker.infer -> HWC uint8 image), drivable without gradio."""

    def on_submit(cap, neg_cap, resolution, steps, cfg, solver, t_shift, seed,
                  scaling_method, watershed, prop_attn):
        req = InferenceRequest(
            cap=cap, neg_cap=neg_cap, resolution=resolution,
            num_sampling_steps=int(steps), cfg_scale=float(cfg), solver=solver,
            t_shift=float(t_shift), seed=int(seed), scaling_method=scaling_method,
            scaling_watershed=float(watershed), proportional_attn=bool(prop_attn),
        )
        result = worker.infer(req)
        if isinstance(result, ModelFailure):
            raise error_cls(f"generation failed:\n{result.error}")
        return result_to_image(result)

    return on_submit


def _devices(device: str, num_workers: int):
    """The pool's devices: the first `num_workers` CUDA devices (0 or less:
    all), or `num_workers` copies of a non-CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * max(num_workers, 1)
    found = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return found[:num_workers] if num_workers > 0 else found


def build_worker(model_name: str = "NextDiT_2B_patch2", precision: str = "bf16",
                 ckpt: Optional[str] = None, debug: bool = False, num_workers: int = 1,
                 device: str = "cuda", seed: int = 0):
    """The demo model and its worker (or pool) from CLI-level options. A
    checkpoint's model args (model, qk_norm, cap_feat_dim) override the
    defaults and its `ema` stream is loaded; `--debug` ignores `ckpt` and
    keeps random weights from `seed`. The caption width is 2048 for every
    model, `DiT_Llama_5B_patch2` included, unless the checkpoint says
    otherwise, as in the JAX demo."""
    from .sample import load_model

    args = argparse.Namespace(model=model_name, ckpt=ckpt, debug=debug, qk_norm=True,
                              cap_feat_dim=None, seed=seed, labels=None, num_classes=None,
                              pixel_space=False)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    devices = _devices(device, num_workers)
    model = load_model(args, dtype, torch.float32, devices[0], cap_feat_dim=2048)
    if num_workers != 1:
        return WorkerPool(model, devices=devices, cap_feat_dim=args.cap_feat_dim)
    return InferenceWorker(model, cap_feat_dim=args.cap_feat_dim)


def build_gradio_ui(worker):
    """Gradio Blocks UI; raises ImportError without gradio."""
    import gradio as gr

    on_submit = make_submit_handler(worker, error_cls=gr.Error)

    with gr.Blocks() as demo:
        gr.Markdown("# Lumina-Next T2I")
        with gr.Row():
            with gr.Column():
                cap = gr.Textbox(label="Caption")
                neg_cap = gr.Textbox(label="Negative Caption", value="")
                resolution = gr.Dropdown(RESOLUTION_CHOICES, value="1024x1024",
                                         label="Resolution")
                steps = gr.Slider(1, 70, value=30, step=1, label="Sampling steps")
                solver = gr.Dropdown(["euler", "midpoint", "rk4"], value="midpoint",
                                     label="Solver")
                t_shift = gr.Slider(1, 20, value=4, step=1, label="Time shifting factor")
                cfg = gr.Slider(1.0, 20.0, value=4.0, label="CFG scale")
                seed = gr.Number(value=0, label="Seed", precision=0)
                scaling_method = gr.Dropdown(["Time-aware", "None"], value="Time-aware",
                                             label="RoPE scaling method")
                watershed = gr.Number(value=0.3, label="Scaling watershed")
                prop_attn = gr.Checkbox(value=True, label="Proportional attention")
                submit = gr.Button("Generate")
            with gr.Column():
                output = gr.Image(label="Result")
        submit.click(on_submit,
                     [cap, neg_cap, resolution, steps, cfg, solver, t_shift, seed,
                      scaling_method, watershed, prop_attn],
                     [output])
    return demo


def main(argv=None):
    p = argparse.ArgumentParser(description="lumina-t2x demo server (PyTorch)")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)

    worker = build_worker(args.model, args.precision, args.ckpt, args.debug, device=args.device)
    try:
        ui = build_gradio_ui(worker)
    except ImportError:
        from .serve import DemoApp, make_server

        print("gradio is not installed; serving the stdlib HTTP demo instead "
              f"at http://127.0.0.1:{args.port}/")
        server = make_server(DemoApp(worker, model_name=args.model), port=args.port)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return worker
    ui.launch(server_port=args.port)


if __name__ == "__main__":
    main()
