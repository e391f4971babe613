"""Weight bundles between the JAX package and the PyTorch port, on the CPU:
the port's flax msgpack codec against flax's, bundles JAX saved served by the
port (and the port's read back by JAX), the frozen text tower's weights
(a torch CLIP checkpoint or the ``text_params.ckpt`` sidecar), and the tiny
golden that ``chip_smoke.py`` serves on the card.

One JAX engine, built by JAX's ``create_model`` from the golden's config
(``tests/data_torch/tiny_bundle/config.yml``: ``Configurations/tiny_cpu.yml``
at nf 64, ch_mult [1, 4], so that the card's flash kernel takes its
bottleneck), with every leaf drawn from a numpy seed (``chip_smoke.golden_trees``).
fp32 throughout; samplers within 1e-4 abs of JAX given JAX's own noise.

Rewrite the golden after a deliberate change with
``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_bundle.py``."""

import json
import os

import numpy as np
import pytest

import flax.serialization as fs
import jax
import jax.numpy as jnp
import torch
import yaml

from instancediff_tpu.config import dict_to_nonedict, ordered_yaml
from instancediff_tpu.models import create_model as jax_create_model
from instancediff_tpu.models.text_encoder import (
    load_torch_clip_text_weights as jax_load_clip_text_weights)
from instancediff_tpu.sde import create_sde as jax_create_sde
from instancediff_tpu.utils import checkpoint as jax_ckpt

import chip_smoke
from instancediff_torch.config import load_options
from instancediff_torch.models import create_model
from instancediff_torch.models.engine import TEXT_SIDECAR, weights_version
from instancediff_torch.sde import create_sde
from instancediff_torch.serving import Restorer
from instancediff_torch.utils import checkpoint as ckpt
from instancediff_torch.utils import msgpack
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_engine import _jax_noise, one_torch_thread, shapes_only_init  # noqa: F401

GOLDEN_CONFIG = os.path.join(chip_smoke.GOLDEN_DIR, "config.yml")
ITER, STEPS = chip_smoke.GOLDEN_ITER, chip_smoke.GOLDEN_STEPS
NETS = ("drift", "noise", "d_ema", "n_ema")
KEY = 5  # jax.random.key of the golden's request


def _jax_options(path):
    loader, _ = ordered_yaml()
    with open(path) as f:
        return dict_to_nonedict(yaml.load(f, Loader=loader))


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def golden_batch():
    rng = np.random.default_rng(1)
    return {"input": rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32),
            "type_idx": np.array([0, 4], np.int32),
            "A_emb": rng.standard_normal((2, 1, 16)).astype(np.float32)}


def build_golden_engine():
    """The JAX engine of the golden's config, its nets and text tower set to
    ``chip_smoke.golden_trees``."""
    opt = _jax_options(GOLDEN_CONFIG)
    with shapes_only_init():
        eng = jax_create_model(None, opt["models"]["DriftNoise"], phase="test",
                               image_size=opt["resolution"])
    eng.set_sde(jax_create_sde(opt["sdes"]["driftSDE"]))
    trees = chip_smoke.golden_trees({**{k: eng.state[k] for k in NETS},
                                     "text": eng.text_params})
    for k in NETS:
        eng.state[k] = trees[k]
    eng.text_params = trees["text"]
    return eng


def write_bundle(eng, models_dir):
    """JAX's bundle of ``eng`` and its text tower's sidecar."""
    eng.save(models_dir, ITER)
    jax_ckpt.save_pytree(eng.text_params, os.path.join(models_dir, TEXT_SIDECAR))


def jax_sample(eng, use_ema):
    return np.asarray(eng.test(golden_batch(), jax.random.key(KEY), use_ema=use_ema,
                               sample_steps=STEPS))


def write_golden(eng, out_dir, models_dir, output):
    """The golden: the sha256 of each file JAX wrote for the bundle (in
    ``models_dir``), and the request with JAX's noise and fp32 ``output``
    (``jax_sample(eng, True)``)."""
    batch = golden_batch()
    eps, zs = _jax_noise(jax.random.key(KEY), batch["input"].shape, STEPS)
    io = dict(batch, init_noise=eps, step_noise=np.stack(zs), output=output)
    os.makedirs(out_dir, exist_ok=True)
    jax_ckpt.save_pytree(io, os.path.join(out_dir, "io.ckpt"))
    with open(os.path.join(out_dir, "sha256.json"), "w") as f:
        json.dump({"seed": chip_smoke.GOLDEN_SEED, "iteration": ITER,
                   "files": chip_smoke.sha256_files(models_dir)}, f, indent=1, sort_keys=True)
        f.write("\n")


@pytest.fixture(scope="module")
def jax_engine():
    return build_golden_engine()


@pytest.fixture(scope="module")
def jax_bundle(jax_engine, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_bundle"))
    write_bundle(jax_engine, d)
    return d


@pytest.fixture(scope="module")
def jax_outputs(jax_engine):
    return {ema: jax_sample(jax_engine, ema) for ema in (True, False)}


def _port_engine():
    opt = load_options(GOLDEN_CONFIG)
    return create_model(None, opt["models"]["DriftNoise"], sde=create_sde(opt["sdes"]["driftSDE"]),
                        device="cpu")


def _port_sample(engine, use_ema):
    batch = golden_batch()
    eps, zs = _jax_noise(jax.random.key(KEY), batch["input"].shape, STEPS)
    return engine.test(batch, use_ema=use_ema, sample_steps=STEPS, init_noise=torch.tensor(eps),
                       step_noise=[torch.tensor(z) for z in zs]).numpy()


# ---------------------------------------------------------------- the codec

_RNG = np.random.default_rng(0)
CODEC_TREES = {
    "fp32": {"w": _RNG.standard_normal((3, 5)).astype(np.float32)},
    "bf16": {"w": np.asarray(jnp.asarray(_RNG.standard_normal((4, 7)), jnp.bfloat16))},
    "int32": {"ids": np.arange(-20, 300, 7, dtype=np.int32).reshape(2, -1)},
    "0-d": {"s": np.array(2.5, np.float32), "t": np.float32(-1.25), "i": np.int64(7)},
    "nested": {"params": {"block_0": {"kernel": np.ones((2, 2), np.float32),
                                      "bias": np.zeros((2,), np.float32)},
                          "ln": {"scale": np.full((40,), 3.0, np.float64)}},
               "step": 12, "epoch": -3, "lr": 2e-5, "ok": True, "none": None},
    "list-keyed": {"opt": [np.zeros((3,), np.float32), (np.ones((1,), np.int32), 70000)],
                   "names": ["a" * 40, "b"], "big": 2**40, "neg": -40000,
                   "blob": b"\x00\x01", "z": 3 + 4j},
}


@pytest.mark.parametrize("case", list(CODEC_TREES))
def test_encoder_writes_flax_bytes(case):
    tree = CODEC_TREES[case]
    assert msgpack.to_bytes(tree) == fs.to_bytes(tree)


def _assert_restored_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_restored_equal(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_decoder_gives_msgpack_restore():
    for tree in CODEC_TREES.values():
        data = fs.to_bytes(tree)
        _assert_restored_equal(msgpack.from_bytes(data), fs.msgpack_restore(data))


def test_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes travel as a chunk map: flax's and the
    port's encoders cut them alike and the decoder joins them."""
    tree = {"emb": _RNG.standard_normal((5, 9)).astype(np.float32),
            "h": np.asarray(jnp.arange(50, dtype=jnp.bfloat16)), "small": np.ones(3, np.int32)}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    data = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack.to_bytes(tree) == data
    got = msgpack.from_bytes(data)
    np.testing.assert_array_equal(got["emb"], tree["emb"])
    np.testing.assert_array_equal(got["h"].view(torch.int16).numpy(), tree["h"].view(np.int16))
    np.testing.assert_array_equal(got["small"], tree["small"])


def test_truncated_or_padded_input_raises():
    data = fs.to_bytes(CODEC_TREES["nested"])
    for cut in (1, 5, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError, match="truncated"):
            msgpack.from_bytes(data[:cut])
    with pytest.raises(ValueError, match="left after"):
        msgpack.from_bytes(data + b"\x00")


def test_bf16_tensors_round_trip():
    t = torch.randn(6, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    data = msgpack.to_bytes({"t": t})
    assert data == fs.to_bytes({"t": np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))})
    assert torch.equal(msgpack.from_bytes(data)["t"], t)


# ---------------------------------------------------------------- the factories


def test_create_model_and_sde_build_the_jax_nets(jax_engine):
    """The port's factories on the golden's config: every net and the text
    tower have JAX's tree (paths and shapes), the prompt ids and the SDE's
    schedules are JAX's; IRSDE is not ported."""
    eng = _port_engine()
    for k in NETS:
        got = {p: v.shape for p, v in _flat(flax_params(eng.nets[k])).items()}
        assert got == {p: tuple(v.shape) for p, v in _flat(jax_engine.state[k]).items()}
    got = {p: v.shape for p, v in _flat(flax_params(eng.text_encoder)).items()}
    assert got == {p: tuple(v.shape) for p, v in _flat(jax_engine.text_params).items()}
    np.testing.assert_array_equal(eng.prompt_ids.numpy(), np.asarray(jax_engine.prompt_ids))
    assert eng.type_map == jax_engine.type_map and eng.dtype == torch.float32
    assert eng.nets["drift"].use_fused_gnconv
    np.testing.assert_array_equal(eng.sde.sigmas.numpy(), np.asarray(jax_engine.sde.sigmas))
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        create_sde({"class_name": "IRSDE", "T": 10})


# ---------------------------------------------------------------- bundles


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "online"])
def test_jax_bundle_samples_on_the_port_as_in_jax(jax_bundle, jax_outputs, use_ema):
    """JAX's ``save`` and sidecar, then the port's ``Restorer.from_config``:
    its sampler within 1e-4 of JAX's ``test`` on the same noise."""
    r = Restorer.from_config(GOLDEN_CONFIG, pth_dir=jax_bundle, iteration=ITER,
                             use_ema=use_ema, device="cpu")
    assert r.engine.text_weights == "sidecar"
    np.testing.assert_allclose(_port_sample(r.engine, use_ema), jax_outputs[use_ema],
                               rtol=0, atol=1e-4)


def test_port_save_writes_jax_bytes(jax_engine, jax_bundle, tmp_path):
    """A port engine filled from JAX's bundle saves the very bytes JAX wrote,
    and JAX's ``load_bundle`` reads them back leaf for leaf."""
    eng = _port_engine()
    eng.load(jax_bundle, ITER)
    eng.save(str(tmp_path), ITER)
    assert chip_smoke.sha256_files(str(tmp_path)) == chip_smoke.sha256_files(jax_bundle)
    for ema, keys in ((False, ("drift", "noise")), (True, ("d_ema", "n_ema"))):
        got = jax_ckpt.load_bundle(str(tmp_path), ITER, jax_engine.state[keys[0]],
                                   jax_engine.state[keys[1]], use_ema=ema)
        for tree, k in zip(got, keys):
            _assert_trees_equal(jax.device_get(tree), jax_engine.state[k])


def _link_bundle(src, dst, skip=()):
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name not in skip:
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    return dst


def test_missing_prompt_and_ema_files_as_in_jax(jax_engine, jax_bundle, tmp_path):
    """Without ``{iter}_DP`` / ``lastest_NP_ema`` a net keeps its current
    prompts (JAX keeps its template's); without the EMA files the EMA nets
    become copies of the online ones (JAX's ``load`` too)."""
    eng = _port_engine()
    before = {k: flax_params(eng.nets[k]) for k in NETS}
    no_prompts = _link_bundle(jax_bundle, str(tmp_path / "no_prompts"),
                              skip=(f"{ITER}_DP.ckpt", "lastest_NP_ema.ckpt"))
    eng.load(no_prompts, ITER)
    for k in NETS:
        net, prompts = ckpt.split_smm(flax_params(eng.nets[k]))
        _assert_trees_equal(net, ckpt.split_smm(jax_engine.state[k])[0])
        kept = k in ("drift", "n_ema")
        _assert_trees_equal(prompts, ckpt.split_smm(before[k] if kept else jax_engine.state[k])[1])
    # JAX keeps the template's prompts on the same files
    template = {"params": {**ckpt.split_smm(jax_engine.state["drift"])[0],
                           **ckpt.split_smm(before["drift"])[1]}}
    got, _ = jax_ckpt.load_bundle(no_prompts, ITER, template, jax_engine.state["noise"])
    _assert_trees_equal(jax.device_get(got), template)

    no_ema = _link_bundle(jax_bundle, str(tmp_path / "no_ema"),
                          skip=[f for f in os.listdir(jax_bundle) if f.startswith("lastest")])
    eng.load(no_ema, ITER)
    for online, ema in (("drift", "d_ema"), ("noise", "n_ema")):
        _assert_trees_equal(flax_params(eng.nets[ema]), jax_engine.state[online])
    saved, sample_fn = dict(jax_engine.state), jax_engine._sample_fn
    try:
        jax_engine.load(no_ema, ITER)
        for online, ema in (("drift", "d_ema"), ("noise", "n_ema")):
            _assert_trees_equal(jax.device_get(jax_engine.state[ema]), saved[online])
    finally:
        jax_engine.state.update(saved)  # the compiled sampler takes the weights as arguments
        jax_engine._sample_fn = sample_fn


def test_load_updates_the_weights_a_graph_would_replay(jax_bundle):
    """``load`` copies into the step nets in place, so a graph captured
    before it (recorded with the nets' ``weights_version``) no longer
    matches and ``test`` captures anew; also for a bundle of the same values."""
    eng = _port_engine()
    eng.load(jax_bundle, ITER)
    for use_ema in (True, False):
        nets = eng._step_nets(use_ema)
        before = weights_version(nets)
        eng.load(jax_bundle, ITER)
        after = weights_version(nets)
        assert before != after and [a for a, _ in before] == [a for a, _ in after]


# ---------------------------------------------------------------- the text tower


def _openai_clip_state_dict(context_length, rng, width=48, layers=2, embed=16, vocab=512):
    """A random text tower in the OpenAI CLIP checkpoint layout."""
    def t(*shape, scale=0.1):
        return torch.tensor(scale * rng.standard_normal(shape), dtype=torch.float32)

    sd = {"token_embedding.weight": t(vocab, width, scale=1.0),
          "positional_embedding": t(context_length, width),
          "ln_final.weight": 1 + t(width), "ln_final.bias": t(width),
          "text_projection": t(width, embed, scale=width ** -0.5),
          "visual.proj": t(4, 4)}  # the image tower's keys are not read
    for i in range(layers):
        R = f"transformer.resblocks.{i}."
        sd.update({R + "attn.in_proj_weight": t(3 * width, width, scale=width ** -0.5),
                   R + "attn.in_proj_bias": t(3 * width),
                   R + "attn.out_proj.weight": t(width, width, scale=width ** -0.5),
                   R + "attn.out_proj.bias": t(width),
                   R + "mlp.c_fc.weight": t(4 * width, width, scale=width ** -0.5),
                   R + "mlp.c_fc.bias": t(4 * width),
                   R + "mlp.c_proj.weight": t(width, 4 * width, scale=(4 * width) ** -0.5),
                   R + "mlp.c_proj.bias": t(width),
                   R + "ln_1.weight": 1 + t(width), R + "ln_1.bias": t(width),
                   R + "ln_2.weight": 1 + t(width), R + "ln_2.bias": t(width)})
    return sd


@pytest.mark.parametrize("context_length", [77, 10], ids=["cut_77", "resampled_10"])
def test_torch_clip_checkpoint_loads_as_in_jax(jax_engine, jax_bundle, tmp_path,
                                               context_length):
    """A CLIP checkpoint (77 positions, cut to the tower's 16; or 10,
    linearly resampled) through each package's loader: the encodings agree
    within 1e-5, with and without learnable context. A tower so loaded
    serves a bundle that has no sidecar."""
    path = str(tmp_path / "clip.pt")
    torch.save(_openai_clip_state_dict(context_length, np.random.default_rng(context_length)),
               path)
    params = jax_load_clip_text_weights(jax_engine.text_params, path)
    opt = load_options(GOLDEN_CONFIG)
    opt["models"]["DriftNoise"]["text_encoder_pretrain_path"] = path
    eng = create_model(None, opt["models"]["DriftNoise"], sde=create_sde(opt["sdes"]["driftSDE"]),
                       device="cpu")
    assert eng.text_weights == "pretrained"
    ctx = np.random.default_rng(3).standard_normal((8, 48)).astype(np.float32)
    for c in (None, ctx):
        want = np.asarray(jax_engine.text_encoder.apply(params, jax_engine.prompt_ids,
                                                        None if c is None else jnp.asarray(c)))
        with torch.no_grad():
            got = eng.text_encoder(eng.prompt_ids, None if c is None else torch.tensor(c))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    eng.load(_link_bundle(jax_bundle, str(tmp_path / "no_sidecar"), skip=(TEXT_SIDECAR,)), ITER)
    assert eng.text_weights == "pretrained"


def test_sidecar_round_trips(jax_engine, jax_bundle, tmp_path):
    """JAX's sidecar, read by the port and written back: the same bytes, and
    the tower encodes as JAX's within 1e-5."""
    eng = _port_engine()
    load_flax_params(eng.text_encoder, ckpt.load_pytree(os.path.join(jax_bundle, TEXT_SIDECAR)))
    path = str(tmp_path / TEXT_SIDECAR)
    ckpt.save_pytree(flax_params(eng.text_encoder), path)
    with open(path, "rb") as f, open(os.path.join(jax_bundle, TEXT_SIDECAR), "rb") as g:
        assert f.read() == g.read()
    _assert_trees_equal(jax.device_get(jax_ckpt.load_pytree(jax_engine.text_params, path)),
                        jax_engine.text_params)
    ctx = jnp.asarray(np.random.default_rng(4).standard_normal((8, 48)), jnp.float32)
    want = np.asarray(jax_engine.text_encoder.apply(jax_engine.text_params,
                                                    jax_engine.prompt_ids, ctx))
    with torch.no_grad():
        got = eng.text_encoder(eng.prompt_ids, torch.tensor(np.asarray(ctx)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tower_with_neither_checkpoint_nor_sidecar_is_refused(jax_bundle, tmp_path):
    eng = _port_engine()
    before = weights_version(eng.nets.values())
    with pytest.raises(FileNotFoundError, match="tools/export_text_params.py"):
        eng.load(_link_bundle(jax_bundle, str(tmp_path / "b"), skip=(TEXT_SIDECAR,)), ITER)
    assert weights_version(eng.nets.values()) == before and eng.text_weights is None


# ---------------------------------------------------------------- the golden


def test_golden_is_current(jax_engine, jax_bundle, jax_outputs, tmp_path):
    """The committed golden equals one written now: the bundle's files
    hash alike, the request and its noise are bit-equal, JAX's output within
    1e-6 (XLA's CPU code may sum in another order on another CPU)."""
    write_golden(jax_engine, str(tmp_path), jax_bundle, jax_outputs[True])
    with open(tmp_path / "sha256.json") as f, \
            open(os.path.join(chip_smoke.GOLDEN_DIR, "sha256.json")) as g:
        assert json.load(f) == json.load(g)
    got = ckpt.load_pytree(str(tmp_path / "io.ckpt"))
    want = ckpt.load_pytree(os.path.join(chip_smoke.GOLDEN_DIR, "io.ckpt"))
    assert got.keys() == want.keys()
    for k in want:
        if k == "output":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k])


def test_golden_served_by_the_port(tmp_path):
    """What ``chip_smoke.py`` does with the golden on the card, here on the
    CPU: rebuild the bundle from its seed with the port's codec (the very
    files JAX wrote, by their sha256), serve it through ``from_config`` with
    the golden's noise, and hold the output to JAX's (1e-4 abs)."""
    io, shas = chip_smoke.load_golden()
    assert chip_smoke.write_golden_bundle(_port_engine(), str(tmp_path)) == shas["files"]
    r = Restorer.from_config(GOLDEN_CONFIG, pth_dir=str(tmp_path), iteration=ITER,
                             device="cpu")
    got = r.engine.test(io, sample_steps=STEPS, init_noise=torch.tensor(io["init_noise"]),
                        step_noise=list(torch.tensor(io["step_noise"])))
    np.testing.assert_allclose(got.numpy(), io["output"], rtol=0, atol=1e-4)


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    engine = build_golden_engine()
    with tempfile.TemporaryDirectory() as bundle_dir:
        write_bundle(engine, bundle_dir)
        write_golden(engine, chip_smoke.GOLDEN_DIR, bundle_dir, jax_sample(engine, True))
    print("wrote", chip_smoke.GOLDEN_DIR)
