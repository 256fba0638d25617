"""Demucs of the PyTorch port against the JAX package, on the CPU: the model
(models/demucs.py), its weight carrier (models/convert.py::
demucs_state_dict) and the `demucs` element.

Mirrors tests/test_demucs.py (5) and
tests/test_demucs_quality.py::test_element_uses_packaged_weights_by_default.
Both packages load one flax tree: flax-layout weights drawn by the port's
`init_flax_tree` (the JAX package's `init_params` gives the same layout,
checked with `jax.eval_shape`; its own draws trace slowly on the CPU),
converted by the carrier for the port, or the packaged demucs-lite
weights (the port's copy is the same file).

Gate: DEMUCS_REL = 1e-4, the largest |port - JAX| over the largest |JAX|
of a stem tensor (f32: the convolutions and LSTM products sum in another
order; measured ~1e-6).  The default weights (no `weights` file, model
demucs) are flax's initialisers drawn from a torch.Generator: their
distributions are checked, not their numbers.

Torch runs on one intra-op thread (tests/torch_parity_helpers.py).
"""
import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core.parse import parse_caps as jparse_caps
from gst_plugins_rs_tpu.elements.audiofx import demucs as jdemucs_el
from gst_plugins_rs_tpu.models import demucs as jdm
from gst_plugins_rs_tpu_torch.core.parse import parse_caps as tparse_caps
from gst_plugins_rs_tpu_torch.elements.audiofx import demucs as tdemucs_el
from gst_plugins_rs_tpu_torch.models import demucs as tdm
from gst_plugins_rs_tpu_torch.models.convert import demucs_flax_tree, demucs_state_dict
from torch_parity_helpers import port_on_cpu, to_numpy

DEMUCS_REL = 1e-4
PUBLISHED_PARAMS = 265_646_728  # model-name=demucs: channels 64, depth 6, 2 BiLSTM layers
SMALL = [dict(channels=8, depth=3, lstm_layers=1), dict(channels=8, depth=2, lstm_layers=2)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _cfgs(**kw):
    return jdm.DemucsConfig(**kw), tdm.DemucsConfig(**kw)


def _mix(T, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 48000.0
    tone = 0.3 * np.sin(2 * np.pi * 110 * t)[:, None] + 0.2 * np.sin(2 * np.pi * 1500 * t)[:, None]
    return (tone + 0.1 * rng.randn(T, 2)).astype(np.float32)[None]


def _npz_tree(path):
    """A save_npz file as the nested flax tree, read with numpy alone."""
    import re

    tree = {}
    with np.load(path) as data:
        for key in data.files:
            *mods, leaf = re.findall(r"\['([^']*)'\]", key)
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return tree


JAX_LITE_WEIGHTS = jdemucs_el.__file__.replace("elements/audiofx/demucs.py",
                                               "data/demucs_lite_weights.npz")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _port_out(tcfg, state, mix):
    model = tdm.build(tcfg, state, "cpu")
    with torch.no_grad():
        return model(torch.from_numpy(mix)).numpy()


# ---------------------------------------------------------------------------
# the model and its weight carrier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", SMALL, ids=["d3l1", "d2l2"])
def test_model_matches_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    params = _np_tree(tdm.init_flax_tree(tcfg, seed=3))
    mix = _mix(jcfg.valid_length(3000))
    want = np.asarray(jdm.make_apply(jcfg)(params, mix))
    got = _port_out(tcfg, demucs_state_dict(params), mix)
    assert got.shape == want.shape == (1, 4, mix.shape[1], 2)
    assert _rel(want, got) <= DEMUCS_REL


def test_lite_packaged_weights_match_jax():
    jcfg, tcfg = _cfgs(**tdemucs_el._MODEL_CONFIGS["demucs-lite"])
    params = _npz_tree(JAX_LITE_WEIGHTS)
    mix = _mix(jcfg.valid_length(12000), seed=1)
    want = np.asarray(jdm.make_apply(jcfg)(params, mix))
    got = _port_out(tcfg, tdm.load_npz(tdemucs_el.PACKAGED_WEIGHTS, tcfg), mix)
    assert _rel(want, got) <= DEMUCS_REL


def test_packaged_weights_are_the_jax_packages():
    with open(tdemucs_el.PACKAGED_WEIGHTS, "rb") as a, open(JAX_LITE_WEIGHTS, "rb") as b:
        assert a.read() == b.read()


def test_model_configs_match_jax():
    assert tdemucs_el._MODEL_CONFIGS == jdemucs_el._MODEL_CONFIGS
    for kw in list(tdemucs_el._MODEL_CONFIGS.values()) + SMALL:
        jcfg, tcfg = _cfgs(**kw)
        for n in (1, 100, 9600, 44100, 48000):
            assert tcfg.valid_length(n) == jcfg.valid_length(n)


def test_conv_transpose_flip():
    """One flax ConvTranspose layer (kernel [k, in, out], not flipped) against
    torch's through the carrier's weight (transposed and flipped along k)."""
    layer = fnn.ConvTranspose(5, (8,), strides=(4,), padding="VALID")
    x = np.random.RandomState(2).randn(1, 13, 3).astype(np.float32)
    v = layer.init(jax.random.PRNGKey(0), x)
    kernel = np.asarray(v["params"]["kernel"])
    want = np.asarray(layer.apply(v, x))
    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(1, 2, 0)[:, :, ::-1]))
    got = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x).transpose(1, 2), w, torch.from_numpy(np.array(v["params"]["bias"])),
        stride=4).transpose(1, 2).numpy()
    assert got.shape == want.shape == (1, 13 * 4 + 4, 5)
    assert _rel(want, got) <= 1e-6
    unflipped = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x).transpose(1, 2), torch.from_numpy(kernel.transpose(1, 2, 0).copy()),
        stride=4).transpose(1, 2).numpy()
    assert _rel(want, unflipped) > 0.1


def test_bilstm_cell_mapping():
    """flax's _BiLSTM (LSTMCell_0..3: forward, backward, forward, backward)
    against the port's per-layer bidirectional nn.LSTM through the carrier."""
    layer = jdm._BiLSTM(hidden=6, layers=2)
    x = np.random.RandomState(3).randn(2, 7, 6).astype(np.float32)
    v = layer.init(jax.random.PRNGKey(1), x)
    want = np.asarray(layer.apply(v, x))
    sd = demucs_state_dict({"_BiLSTM_0": to_numpy(v["params"])})
    port = tdm._BiLSTM(6, 6, 2)
    port.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(want, got) <= 1e-5
    assert set(v["params"]) == {"LSTMCell_0", "LSTMCell_1", "LSTMCell_2", "LSTMCell_3", "Dense_0"}


def test_carrier_round_trip():
    tree = _npz_tree(JAX_LITE_WEIGHTS)
    back = demucs_flax_tree(demucs_state_dict(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for k, v in flat_a:
        np.testing.assert_array_equal(flat_b[jax.tree_util.keystr(k)], v)


def test_published_parameter_count():
    jcfg, tcfg = _cfgs(**tdemucs_el._MODEL_CONFIGS["demucs"])
    shapes = jax.eval_shape(lambda: jdm.init_params(jcfg))
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) \
        == PUBLISHED_PARAMS == tdm.param_count(tcfg)


def test_init_weights_layout_and_distributions():
    """The default initialisers: the flax tree's keys and shapes, zero
    biases, lecun-normal kernels (truncated at 2 sigma), orthogonal
    recurrent kernels; the same seed gives the same weights."""
    jcfg, tcfg = _cfgs(channels=16, depth=3, lstm_layers=2)
    shapes = jax.eval_shape(lambda: jdm.init_params(jcfg))
    tree = _np_tree(tdm.init_flax_tree(tcfg, seed=0))
    want = {jax.tree_util.keystr(k): s.shape for k, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(k): v.shape for k, v in
           jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    p = tree["params"]
    k = p["Conv_4"]["kernel"]  # [8, 32, 64]: fan-in 256
    fan_in = k.shape[0] * k.shape[1]
    assert abs(float(k.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(np.abs(k).max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    rec = p["_BiLSTM_0"]["LSTMCell_3"]["hg"]["kernel"]
    np.testing.assert_allclose(rec @ rec.T, np.eye(rec.shape[0]), atol=1e-5)
    assert all(not np.any(v) for kk, v in jax.tree_util.tree_flatten_with_path(tree)[0]
               if jax.tree_util.keystr(kk).endswith("['bias']"))
    a, b = tdm.init_weights(tcfg, 7), tdm.init_weights(tcfg, 7)
    assert all(torch.equal(a[n], b[n]) for n in a)
    c = tdm.init_weights(tcfg, 8)
    assert not torch.equal(a["Conv_0.weight"], c["Conv_0.weight"])
    assert not any(float(a[n].abs().max()) for n in a if "bias_ih" in n)


class TestModel:
    def test_output_shape_and_length(self):
        _, cfg = _cfgs(channels=8, depth=3, lstm_layers=1)
        T = cfg.valid_length(2000)
        out = _port_out(cfg, tdm.init_weights(cfg), np.zeros((1, T, 2), np.float32))
        assert out.shape == (1, 4, T, 2)
        assert np.isfinite(out).all()

    def test_weights_roundtrip(self, tmp_path):
        # the element's lite size: the JAX load_npz traces init_params for its
        # template, which the element tests trace too
        jcfg, cfg = _cfgs(**tdemucs_el._MODEL_CONFIGS["demucs-lite"])
        state = tdm.init_weights(cfg, seed=3)
        path = str(tmp_path / "w.npz")
        tdm.save_npz(path, state)
        loaded = tdm.load_npz(path, cfg)
        assert set(loaded) == set(state)
        for name in state:
            assert torch.equal(loaded[name], state[name])
        # the port's file is the JAX package's format, and back
        jparams = jdm.load_npz(path, jcfg)  # checks every key and shape
        mix = _mix(cfg.valid_length(2500), seed=4)
        assert _rel(np.asarray(jdm.make_apply(jcfg)(jparams, mix)),
                    _port_out(cfg, state, mix)) <= DEMUCS_REL
        jpath = str(tmp_path / "j.npz")
        jdm.save_npz(jpath, jparams)
        for name, t in tdm.load_npz(jpath, cfg).items():
            assert torch.equal(t, state[name]), name

    def test_shape_mismatch_rejected(self, tmp_path):
        cfg = tdm.DemucsConfig(channels=8, depth=2, lstm_layers=1)
        tdm.save_npz(str(tmp_path / "w.npz"), tdm.init_weights(cfg))
        other = tdm.DemucsConfig(channels=16, depth=2, lstm_layers=1)
        with pytest.raises((ValueError, KeyError)):
            tdm.load_npz(str(tmp_path / "w.npz"), other)
        deeper = tdm.DemucsConfig(channels=8, depth=3, lstm_layers=1)
        with pytest.raises((ValueError, KeyError)):
            tdm.load_npz(str(tmp_path / "w.npz"), deeper)


# ---------------------------------------------------------------------------
# the element
# ---------------------------------------------------------------------------
def _pipeline(pkg, parse_caps, num_buffers, spb, rate, freq=None, segment=200_000_000,
              **props):
    p = pkg.Pipeline()
    src = pkg.element_factory_make("audiotestsrc")
    src.set_property("wave", "sine")
    if freq is not None:
        src.set_property("freq", freq)
    src.set_property("num-buffers", num_buffers)
    src.set_property("samplesperbuffer", spb)
    caps = pkg.element_factory_make("capsfilter")
    caps.set_property("caps", parse_caps(f"audio/x-raw,format=F32,rate={rate},channels=2"))
    d = pkg.element_factory_make("demucs")
    d.set_property("segment-duration", segment)
    for k, v in props.items():
        d.set_property(k, v)
    for e in (src, caps, d):
        p.add(e)
    src.link(caps)
    caps.pad("src").link(d.pad("sink"))
    sinks = {}
    for stem in ("drums", "bass", "other", "vocals"):
        s = pkg.element_factory_make("appsink", stem)
        p.add(s)
        d.pad(f"src_{stem}").link(s.pad("sink"))
        sinks[stem] = s
    p.play_until_eos()
    return sinks


def _both_elements(*args, **kw):
    j = _pipeline(jfx, jparse_caps, *args, **kw)
    t = _pipeline(tfx, tparse_caps, *args, **kw)
    for stem in j:
        js, ts = j[stem].samples, t[stem].samples
        assert [(s.buffer.pts, s.buffer.duration) for s in js] == \
            [(s.buffer.pts, s.buffer.duration) for s in ts]
        assert _rel(j[stem].concat_audio(), t[stem].concat_audio()) <= DEMUCS_REL, stem
    return t


class TestElement:
    def test_four_stems_sample_counts(self):
        sinks = _both_elements(5, 4800, 48000)  # 0.5 s in 0.2 s segments
        for stem, s in sinks.items():
            out = s.concat_audio()
            assert out.shape == (24000, 2), stem
            assert s.caps.structure(0)["channels"] == 2
            assert all(isinstance(x.buffer.data, torch.Tensor) for x in s.samples)
        # pts bookkeeping: last buffer ends exactly at stream end
        last = sinks["vocals"].samples[-1].buffer
        assert last.pts + last.duration == 500_000_000

    def test_htdemucs_gated(self):
        d = tfx.element_factory_make("demucs")
        d.set_property("model-name", "htdemucs")
        with pytest.raises(RuntimeError, match="htdemucs"):
            d.set_state(tfx.State.PAUSED)

    def test_latency_and_chunk_duration_follow_segment(self):
        d = tfx.element_factory_make("demucs")
        d.set_property("chunk-duration", 300_000_000)
        assert d.get_property("segment-duration") == 300_000_000
        assert d.get_property("processing-latency") == 300_000_000
        d.set_property("segment-duration", 400_000_000)
        assert d.get_property("chunk-duration") == 400_000_000

    def test_weights_property(self, tmp_path):
        """A save_npz file named by `weights` (random weights saved by the JAX
        package's save_npz) drives both elements."""
        path = str(tmp_path / "w.npz")
        jdm.save_npz(path, tdm.init_flax_tree(tdm.DemucsConfig(**jdemucs_el._MODEL_CONFIGS[
            "demucs-lite"]), seed=11))
        sinks = _both_elements(3, 4800, 48000, segment=300_000_000, weights=path)
        assert sinks["drums"].concat_audio().shape == (14400, 2)


def test_element_uses_packaged_weights_by_default():
    """demucs-lite picks up the packaged weights: a bass-band input routes
    mostly to src_bass, not evenly across stems (random weights would)."""
    sinks = _both_elements(10, 4410, 44100, freq=80.0, segment=500_000_000)
    powers = {stem: float(np.mean(np.square(s.concat_audio()))) for stem, s in sinks.items()}
    assert powers["bass"] == max(powers.values()), powers
    assert powers["bass"] > 3 * powers["drums"], powers
