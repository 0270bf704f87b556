"""The port's `lumina` CLI (`lumina_t2x_tpu_torch/cli/entry_point.py`), its
reference-checkpoint bridge (`core/checkpoint.py`: safetensors reader and
writer, `load_torch_state_dict`, `save_weights`) and the sampler's `--ckpt`
(`pipelines/sample.py`), against the JAX package's CLI, PyYAML and the
`safetensors` package, on the CPU with the Tiny NextDiT.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from safetensors.torch import load_file, save_file

from lumina_t2x_tpu.cli import entry_point as j_ep
from lumina_t2x_tpu_torch.cli import entry_point as t_ep
from lumina_t2x_tpu_torch.core import checkpoint as t_ckpt
from lumina_t2x_tpu_torch.models import get_model
from lumina_t2x_tpu_torch.pipelines import sample as t_sample
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl

from test_torch_next_dit import _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = os.path.join(REPO, "configs", "infer", "settings.yaml")

SETTINGS_FILES = {
    "repo": None,
    "missing": None,
    "empty": "",
    "comments only": "# nothing here\n\n",
    "partial list": "- infer:\n    num_sampling_steps: 10\n    solver: euler  # fast\n",
    "partial mapping": "ode:\n  atol: 1.0e-5\nextra:\n  key: value\ninfer:\n",
}


@pytest.mark.parametrize("name", sorted(SETTINGS_FILES))
def test_load_settings_matches_jax(tmp_path, name):
    if name == "repo":
        path = SETTINGS
    elif name == "missing":
        path = str(tmp_path / "nope.yaml")
    else:
        path = str(tmp_path / "settings.yaml")
        with open(path, "w") as f:
            f.write(SETTINGS_FILES[name])
    assert t_ep.load_settings(path) == j_ep.load_settings(path)


@pytest.mark.parametrize("doc", [
    "a: 1\nb: -2\nc: 1_000\nd: 0.5\ne: 1.0e-6\nf: 1e-6\ng: .5\nh: -.inf\n",
    "a: yes\nb: Off\nc: ~\nd: null\ne: ''\nf: \"x # y\"\ng: 'it''s'\nh: 1024x1024\n",
    "- top:\n    inner:\n      deep: 3\n    other: true\n  second: x\n- 7\n",
    "seq:\n- a\n- b: 1\n  c: 2\nafter: 1\n",
    "a: \"caf\u00e9 \\t \\u00e9\"\nb:\n  -\n  - x\n  -\n",
])
def test_yaml_subset_matches_pyyaml(doc):
    assert t_ep.parse_yaml_subset(doc) == yaml.safe_load(doc)


def test_yaml_subset_rejects_what_it_does_not_read():
    for doc in ("k: [1, 2]\n", "k: {a: 1}\n", "a: 1\n   b: 2\n", "just text\n"):
        with pytest.raises(ValueError):
            t_ep.parse_yaml_subset(doc)


def _capture_sample_argv(monkeypatch, module):
    seen = []
    monkeypatch.setattr(module, "main", lambda argv: seen.append(list(argv)) or {})
    return seen


@pytest.mark.parametrize("extra", [["--debug"], ["--ckpt", "some/dir", "--model", "NextDiT_Tiny_patch2"]])
def test_infer_builds_the_jax_argv(monkeypatch, tmp_path, extra):
    """`infer` is the default subcommand and hands `pipelines.sample.main`
    the JAX CLI's argv, plus `--device`."""
    from lumina_t2x_tpu.pipelines import sample as j_sample

    j_seen = _capture_sample_argv(monkeypatch, j_sample)
    t_seen = _capture_sample_argv(monkeypatch, t_sample)
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    result = CliRunner().invoke(j_ep.main, ["a prompt", out_j, "-c", SETTINGS, *extra])
    assert result.exit_code == 0, result.output
    t_ep.main(["a prompt", out_t, "-c", SETTINGS, "--device", "cpu", *extra])
    ref = [a.replace(out_j, out_t) for a in j_seen[0]]
    got = t_seen[0]
    i = got.index("--device")
    assert got[i + 1] == "cpu"
    assert got[:i] + got[i + 2:] == ref
    with open(os.path.join(out_t, "_prompt.txt")) as f:
        assert f.read() == "a prompt\n"


def test_cli_help_and_unknown_options(capsys):
    with pytest.raises(SystemExit) as err:
        t_ep.main(["--help"])
    assert err.value.code == 0 and "infer" in capsys.readouterr().out
    with pytest.raises(SystemExit) as err:
        t_ep.main(["infer"])  # TEXT is required
    assert err.value.code == 2


# -- safetensors and the reference state dicts -------------------------------------------------


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w.f32": torch.randn(3, 5, generator=g),
            "w.bf16": torch.randn(4, 2, generator=g).to(torch.bfloat16),
            "w.f16": torch.randn(7, generator=g).to(torch.float16),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    sd = _tensors()
    t_ckpt.save_safetensors(sd, str(tmp_path / "a.safetensors"))
    loaded = load_file(str(tmp_path / "a.safetensors"))
    assert loaded.keys() == sd.keys()
    for name, t in sd.items():
        assert loaded[name].dtype == t.dtype and torch.equal(loaded[name], t), name


def test_safetensors_reader_reads_the_package(tmp_path):
    sd = _tensors()
    save_file(sd, str(tmp_path / "b.safetensors"), metadata={"format": "pt"})
    loaded = t_ckpt.load_torch_state_dict(str(tmp_path / "b.safetensors"))
    assert loaded.keys() == sd.keys()
    for name, t in sd.items():
        assert loaded[name].dtype == t.dtype and torch.equal(loaded[name], t), name


def test_safetensors_reader_rejects_a_broken_file(tmp_path):
    path = str(tmp_path / "c.safetensors")
    t_ckpt.save_safetensors({"a": torch.ones(4)}, path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-4])
    with pytest.raises(ValueError):
        t_ckpt.load_safetensors(path)


def test_pth_state_dict_loads(tmp_path):
    sd = _tensors()
    torch.save({"state_dict": sd}, str(tmp_path / "m.pth"))
    loaded = t_ckpt.load_torch_state_dict(str(tmp_path / "m.pth"))
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())


# -- convert and --ckpt ----------------------------------------------------------------------------


def _tiny_state_dict():
    """Reference-layout weights of the randomised Tiny NextDiT (qk-norm,
    caption dim 32)."""
    return {k: v.clone() for k, v in _pair()[2].state_dict().items()}


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_convert_round_trip(tmp_path, fmt):
    sd = _tiny_state_dict()
    src = str(tmp_path / f"ref.{fmt}")
    if fmt == "safetensors":
        t_ckpt.save_safetensors(sd, src)
    else:
        torch.save(sd, src)
    dest = str(tmp_path / "ckpt")
    t_ep.main(["convert", src, dest, "--model", "NextDiT_Tiny_patch2"])
    with open(os.path.join(dest, "model_args.json")) as f:
        assert json.load(f) == {"model": "NextDiT_Tiny_patch2", "qk_norm": True, "cap_feat_dim": 32}
    model = get_model("NextDiT_Tiny_patch2", qk_norm=True, cap_feat_dim=32)
    loaded = t_ckpt.init_from(dest, model, "ema")
    assert loaded.keys() == sd.keys()
    out = str(tmp_path / "back.safetensors")
    t_ep.main(["convert", dest, out, "--direction", "to_safetensors"])
    back = load_file(out)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], v) for k, v in sd.items())


def test_convert_rejects_another_model(tmp_path):
    src = str(tmp_path / "ref.safetensors")
    t_ckpt.save_safetensors(_tiny_state_dict(), src)
    with pytest.raises(SystemExit, match="not a NextDiT_600M_patch2 state dict"):
        t_ep.main(["convert", src, str(tmp_path / "x"), "--model", "NextDiT_600M_patch2"])
    with pytest.raises(SystemExit, match="not found"):
        t_ep.main(["convert", str(tmp_path / "missing.pth"), str(tmp_path / "y")])


def _sample_argv(out_dir, *extra):
    return ["--device", "cpu", "--precision", "fp32", "--resolution", "1:128x128",
            "--num_sampling_steps", "3", "--image_save_path", str(out_dir), *extra]


def test_sample_from_a_port_checkpoint(tmp_path):
    """`--ckpt` restores the ema stream; the checkpoint's model args pick the
    model (no --model / --qk_norm / --cap_feat_dim given), and the latents
    equal `build_t2i_sample_fn` over the same weights and noise."""
    model = _pair()[2]
    t_ckpt.save_weights(str(tmp_path / "ckpt"), model.state_dict(),
                        {"model": "NextDiT_Tiny_patch2", "qk_norm": True, "cap_feat_dim": 32})
    manifest = t_sample.main(_sample_argv(tmp_path / "out", "--ckpt", str(tmp_path / "ckpt")))
    assert manifest["args"]["model"] == "NextDiT_Tiny_patch2" and manifest["args"]["qk_norm"]
    got = np.load(manifest["items"][0]["path"])
    gen = torch.Generator("cpu").manual_seed(0)
    cap = torch.randn((2, 32, 32), generator=gen)
    z = torch.randn((1, 4, 16, 16), generator=gen)
    fn = t_sl.build_t2i_sample_fn(model, width=128, height=128, num_steps=3, solver="midpoint",
                                  cfg_scale=4.0, time_shifting_factor=1.0)
    np.testing.assert_array_equal(got, fn(z, cap, torch.ones((2, 32), dtype=torch.int32))[0].numpy())
    # --debug ignores --ckpt: random weights give other latents
    debug = t_sample.main(_sample_argv(tmp_path / "dbg", "--ckpt", str(tmp_path / "ckpt"),
                                       "--debug", "--model", "NextDiT_Tiny_patch2", "--qk_norm",
                                       "--cap_feat_dim", "32"))
    assert not np.array_equal(np.load(debug["items"][0]["path"]), got)


def test_sample_ckpt_must_hold_every_parameter(tmp_path):
    sd = _tiny_state_dict()
    sd.pop("final_layer.linear.weight")
    t_ckpt.save_weights(str(tmp_path / "ckpt"), sd,
                        {"model": "NextDiT_Tiny_patch2", "qk_norm": True, "cap_feat_dim": 32})
    with pytest.raises(SystemExit, match="final_layer.linear.weight"):
        t_sample.main(_sample_argv(tmp_path / "out", "--ckpt", str(tmp_path / "ckpt")))


@pytest.mark.parametrize("flag", ["--text_encoder"])
def test_unported_options_raise(tmp_path, flag):
    """--text_encoder is ported: a directory that is not there is a clean error."""
    with pytest.raises(SystemExit, match=r"--text_encoder directory not found"):
        t_sample.main(_sample_argv(tmp_path, "--model", "NextDiT_Tiny_patch2", flag,
                                   str(tmp_path / "missing")))


def test_lumina_infer_with_a_checkpoint(tmp_path):
    """The CLI end to end on the CPU: convert a reference state dict, then
    `lumina "prompt" out --ckpt` with a small settings file."""
    src = str(tmp_path / "ref.safetensors")
    t_ckpt.save_safetensors(_tiny_state_dict(), src)
    t_ep.main(["convert", src, str(tmp_path / "ckpt"), "--model", "NextDiT_Tiny_patch2"])
    settings = tmp_path / "settings.yaml"
    settings.write_text("- infer:\n    resolution: 64x128\n    num_sampling_steps: 2\n")
    manifest = t_ep.main(["a prompt", str(tmp_path / "out"), "-c", str(settings),
                          "--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"])
    item = manifest["items"][0]
    assert item["name"] == "a prompt" and item["steps"] == 2 and item["resolution"] == "64x128"
    lat = np.load(item["path"])
    assert lat.shape == (4, 16, 8) and np.isfinite(lat).all()
