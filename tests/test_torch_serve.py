"""The port's serving path (`lumina_t2x_tpu_torch/pipelines/{demo,serve}.py`)
against the JAX package's, on the CPU with the Tiny NextDiT (weights
perturbed as in `test_torch_next_dit._pair`, caption dim 32).

Request validation and the hashed pseudo caption features must agree with
JAX exactly; the worker's latents must equal `build_t2i_sample_fn` on the
same noise (fp32, same arithmetic: bit for bit); the HTTP layer is driven
through `DemoApp.handle` and through a live socket on port 0.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from lumina_t2x_tpu.pipelines import demo as j_demo
from lumina_t2x_tpu.pipelines import serve as j_serve
from lumina_t2x_tpu_torch.ops import flash_attention as tfa
from lumina_t2x_tpu_torch.pipelines import demo as t_demo
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl
from lumina_t2x_tpu_torch.pipelines import serve as t_serve
from lumina_t2x_tpu_torch.utils import png_bytes, stable_text_seed

from test_torch_next_dit import _pair

CAP_DIM = 32


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for var in ("LUMINA_FUSE_ROPE", "LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_AUTO"):
        monkeypatch.delenv(var, raising=False)
    tfa.set_flash_static_max(None)
    yield
    tfa.set_flash_static_max(None)


def _worker(**kw):
    return t_demo.InferenceWorker(_pair()[2], cap_feat_dim=CAP_DIM, device="cpu", **kw)


def _req(**kw):
    kw.setdefault("resolution", "64x64")
    kw.setdefault("num_sampling_steps", 3)
    return t_demo.InferenceRequest(cap=kw.pop("cap", "a red cube"), **kw)


# -- request validation -------------------------------------------------------------------

PAYLOADS = [
    {"cap": "a cat"},
    {"cap": "a cat", "num_sampling_steps": "12", "cfg_scale": "7.5", "seed": 3},
    {"cap": "a cat", "proportional_attn": "false", "scaling_method": "None"},
    {"cap": "a cat", "resolution": "(Extrapolation) 1664x1664", "t_shift": 20},
    {"cap": "a cat", "resolution": "512x2048", "solver": "euler", "scaling_watershed": 1.0},
    {}, {"cap": ""}, [], "a cat", {"cap": "a cat", "bogus": 1},
    {"cap": "a cat", "num_sampling_steps": 0}, {"cap": "a cat", "num_sampling_steps": 71},
    {"cap": "a cat", "num_sampling_steps": True}, {"cap": "a cat", "num_sampling_steps": "x"},
    {"cap": "a cat", "solver": "dopri5"}, {"cap": "a cat", "cfg_scale": 0.5},
    {"cap": "a cat", "t_shift": 0}, {"cap": "a cat", "scaling_watershed": 0},
    {"cap": "a cat", "scaling_method": "linear"}, {"cap": "a cat", "resolution": "big"},
    {"cap": "a cat", "resolution": "1000x1024"}, {"cap": "a cat", "resolution": "4096x4096"},
    {"cap": "a cat", "proportional_attn": "yes"}, {"cap": 5}, {"cap": "a cat", "seed": None},
    {"cap": "a cat", "neg_cap": None},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_parse_request_matches_jax(payload):
    outcome = []
    for parse in (j_serve.parse_request, t_serve.parse_request):
        try:
            outcome.append(("ok", dict(parse(payload).__dict__)))
        except ValueError as e:
            outcome.append(("error", str(e)))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("cap,neg_cap", [("a red cube", ""), ("ünïcode prompt", "blurry")])
def test_pseudo_features_equal_jax(cap, neg_cap):
    from lumina_t2x_tpu.utils import stable_text_seed as j_seed

    assert stable_text_seed(cap) == j_seed(cap)
    jw = j_demo.InferenceWorker(None, {}, cap_feat_dim=CAP_DIM)
    ref_feats, ref_mask = jw._encode_captions(cap, neg_cap)
    feats, mask = _worker()._encode_captions(cap, neg_cap)
    assert feats.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_array_equal(feats.numpy(), np.asarray(ref_feats))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


# -- the worker -------------------------------------------------------------------------------


@pytest.mark.parametrize("scaling_method", ["Time-aware", "None"])
def test_worker_latents_equal_the_sampler(scaling_method):
    worker = _worker()
    req = _req(seed=5, cfg_scale=3.0, t_shift=2.0, scaling_method=scaling_method,
               resolution="128x64")
    result = worker.infer(req)
    assert not isinstance(result, t_demo.ModelFailure), result.error
    feats, mask = worker._encode_captions(req.cap, req.neg_cap)
    z = torch.randn((1, 4, 8, 16), generator=torch.Generator("cpu").manual_seed(5))
    fn = t_sl.build_t2i_sample_fn(worker.model, width=128, height=64, num_steps=3,
                                  solver="midpoint", cfg_scale=3.0, time_shifting_factor=2.0,
                                  scale_watershed=0.3 if scaling_method == "Time-aware" else 1.0,
                                  time_aware_scaling=scaling_method == "Time-aware")
    np.testing.assert_array_equal(result["latents"], fn(z, feats, mask).numpy())
    assert result["latents"].shape == (1, 4, 8, 16)
    assert result["metadata"]["seed"] == 5 and result["metadata"]["device"] == "cpu"
    img = t_demo.result_to_image(result)
    assert img.shape == (8, 16, 3) and img.dtype == np.uint8


def test_worker_reports_failures():
    result = _worker().infer(_req(resolution="64"))
    assert isinstance(result, t_demo.ModelFailure) and "ValueError" in result.error


def test_sampler_cache_is_an_lru_of_eight():
    worker = _worker()
    feats, mask = worker._encode_captions("a", "")
    keys = []
    for steps in range(1, 10):
        if steps == 9:
            worker._get_sampler(_req(num_sampling_steps=1), feats, mask)  # refresh key 1
        worker._get_sampler(_req(num_sampling_steps=steps), feats, mask)
        keys.append(steps)
    cached = [key[2] for key in worker._sampler_cache]
    assert len(cached) == t_demo.InferenceWorker.MAX_CACHED_SAMPLERS == 8
    assert cached == [3, 4, 5, 6, 7, 8, 1, 9]  # key 2 was the least recently used


def _record_bounds(monkeypatch):
    """The bounds the worker's calibrations return, in order."""
    bounds = []
    fn = t_sl.autocalibrate_flash_static_max
    monkeypatch.setattr(t_sl, "autocalibrate_flash_static_max",
                        lambda *a, **k: bounds.append(fn(*a, **k)) or bounds[-1])
    return bounds


def _record_calls(monkeypatch, name, arg=None):
    """Calls of the plain version `name` (its argument `arg` when given)."""
    calls = []
    fn = getattr(tfa, name)
    monkeypatch.setattr(tfa, name, lambda *a: calls.append(a[arg] if arg else 1) or fn(*a))
    return calls


def test_each_sampler_runs_with_its_own_bound(monkeypatch):
    """Key A calibrates, then key B calibrates another bound; a later run of
    A reads A's bound, and neither reads the process-wide slot."""
    worker = _worker()
    req_a = _req(resolution="2176x128", cfg_scale=4.0, t_shift=4.0, num_sampling_steps=2)
    req_b = _req(resolution="2176x128", cfg_scale=1.0, t_shift=1.0, num_sampling_steps=2)
    feats, mask = worker._encode_captions(req_a.cap, "")
    bounds = _record_bounds(monkeypatch)
    worker._get_sampler(req_a, feats, mask)
    worker._get_sampler(req_b, feats, mask)
    bound_a, bound_b = bounds
    assert bound_a is not None and bound_b is not None and bound_a != bound_b
    assert tfa.get_flash_static_max() is None  # calibration installs nothing
    tfa.set_flash_static_max(7.0)
    used = _record_calls(monkeypatch, "flash_static_max_plain", arg=5)
    result = worker.infer(req_a)
    assert not isinstance(result, t_demo.ModelFailure), result.error
    assert used and set(used) == {bound_a}
    assert tfa.get_flash_static_max() == 7.0  # the run left the slot alone


def test_fused_rope_setting_has_its_own_sampler(monkeypatch):
    """The same knobs under LUMINA_FUSE_ROPE=0 and =1 are two samplers: the
    unfused one calibrates a bound and runs the static-max path, the fused
    one calibrates none (its branch records no LSE) and runs the fused-RoPE
    path, and the unfused one keeps its bound when it runs again."""
    worker = _worker()
    req = _req(resolution="2176x128", num_sampling_steps=2)
    bounds = _record_bounds(monkeypatch)
    static = _record_calls(monkeypatch, "flash_static_max_plain", arg=5)
    rope = _record_calls(monkeypatch, "flash_rope_plain")
    runs = []
    for fuse in ("0", "1", "0"):
        monkeypatch.setenv("LUMINA_FUSE_ROPE", fuse)
        before = len(static), len(rope)
        result = worker.infer(req)
        assert not isinstance(result, t_demo.ModelFailure), result.error
        runs.append((len(static) - before[0], len(rope) - before[1]))
    assert [key[-1] for key in worker._sampler_cache] == [True, False]  # LRU order
    assert len(bounds) == 2 and bounds[0] is not None and bounds[1] is None
    # the trajectory: 1 midpoint step x 2 forwards x 2 layers; the fused
    # calibration's probe stops after its first forward (2 layers)
    assert runs == [(4, 0), (0, 2 + 4), (4, 0)] and set(static) == {bounds[0]}


def test_pool_on_two_cpu_devices():
    model = _pair()[2]
    pool = t_demo.WorkerPool(model, devices=["cpu", "cpu"], cap_feat_dim=CAP_DIM)
    assert len(pool) == 2
    assert pool.workers[0].model is model and pool.workers[1].model is not model
    for a, b in zip(model.parameters(), pool.workers[1].model.parameters()):
        assert torch.equal(a, b)
    reqs = [_req(seed=s) for s in (1, 2, 3, 4)]
    results = [None] * len(reqs)

    def run(i):
        results[i] = pool.infer(reqs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    single = _worker()
    for req, result in zip(reqs, results):
        assert not isinstance(result, t_demo.ModelFailure), result.error
        np.testing.assert_array_equal(result["latents"], single.infer(req)["latents"])
    assert len(pool._sampler_cache) >= 1


def test_submit_handler_round_trip():
    handler = t_demo.make_submit_handler(_worker())
    img = handler("a cat", "", "64x64", 2, 4.0, "euler", 4, 0, "Time-aware", 0.3, True)
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    with pytest.raises(RuntimeError, match="generation failed"):
        handler("a cat", "", "64", 2, 4.0, "euler", 4, 0, "Time-aware", 0.3, True)


# -- HTTP -------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 3), (64, 256, 3)])
def test_png_decodes_to_the_same_pixels(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    decoded = Image.open(io.BytesIO(png_bytes(img)))
    assert decoded.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(decoded), img)
    with pytest.raises(ValueError):
        png_bytes(img[..., 0])


class _FailingWorker:
    _sampler_cache = {}

    def infer(self, req):
        return t_demo.ModelFailure("Traceback: boom")


def test_demo_app_routes():
    app = t_serve.DemoApp(_worker(), model_name="tiny")
    status, ctype, body = app.handle("GET", "/", None)
    assert status == 200 and ctype.startswith("text/html") and b"/api/generate" in body
    assert b"TPU" not in body
    status, _, body = app.handle("GET", "/api/health", None)
    assert status == 200 and json.loads(body) == {"ok": True, "model": "tiny",
                                                  "compiled_samplers": 0}
    assert app.handle("GET", "/nope", None)[0] == 404
    assert app.handle("POST", "/api/generate", b"{not json")[0] == 400
    status, _, body = app.handle("POST", "/api/generate", json.dumps({"cap": ""}).encode())
    assert status == 400 and "required" in json.loads(body)["error"]
    body = json.dumps({"cap": "a cat", "resolution": "64x128", "num_sampling_steps": 2}).encode()
    status, _, out = app.handle("POST", "/api/generate", body)
    assert status == 200
    out = json.loads(out)
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"]))))
    result = app.worker.infer(t_serve.parse_request(json.loads(body)))
    np.testing.assert_array_equal(img, t_demo.result_to_image(result))
    assert out["metadata"]["resolution"] == "64x128"
    assert json.loads(app.handle("GET", "/api/health", None)[2])["compiled_samplers"] == 1
    status, _, out = t_serve.DemoApp(_FailingWorker()).handle("POST", "/api/generate", body)
    assert status == 500 and "boom" in json.loads(out)["error"]


def test_live_server_round_trip():
    server = t_serve.make_server(t_serve.DemoApp(_worker(), model_name="tiny"), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/api/health", timeout=60) as resp:
            assert json.loads(resp.read())["model"] == "tiny"
        req = urllib.request.Request(
            url + "/api/generate", data=json.dumps({"cap": "a cat", "resolution": "64x64",
                                                    "num_sampling_steps": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        img = Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"])))
        assert img.size == (8, 8) and img.mode == "RGB"
        bad = urllib.request.Request(url + "/api/generate", data=b'{"cap": "a", "x": 1}')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_build_worker_on_the_cpu(tmp_path):
    worker = t_demo.build_worker("NextDiT_Tiny_patch2", "fp32", debug=True, device="cpu")
    assert isinstance(worker, t_demo.InferenceWorker) and worker.device == torch.device("cpu")
    assert worker.model.qk_norm and worker.cap_feat_dim == 2048
    pool = t_demo.build_worker("NextDiT_Tiny_patch2", "fp32", debug=True, device="cpu",
                               num_workers=2)
    assert isinstance(pool, t_demo.WorkerPool) and len(pool) == 2
