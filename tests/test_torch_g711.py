"""The port's G.711 companding (ops/g711.py) and its codec elements
(alawenc, alawdec, mulawenc, mulawdec) against the JAX package's.

The ops are held to the JAX package's bit for bit over every input: all
65 536 S16 values encoded and all 256 codes decoded, for both laws, and to
CPython's audioop tables.  The elements run the same launches in both
packages on seeded audio, from numpy and from tensor payloads, with equal
outputs.  Then the FLV demuxer's mu-law cases of tests/test_image_flv.py,
mirrored."""
import audioop

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.ops import g711 as jg711
from gst_plugins_rs_tpu_torch.ops import g711
from torch_parity_helpers import mirror_jax_tests, port_on_cpu, run_launch


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


PCM = np.arange(-32768, 32768, dtype=np.int16)
CODES = np.arange(256, dtype=np.uint8)
ORACLE = {"alaw": (audioop.lin2alaw, audioop.alaw2lin),
          "mulaw": (audioop.lin2ulaw, audioop.ulaw2lin)}


@pytest.mark.parametrize("law", ["alaw", "mulaw"])
def test_encode_all_s16_values_bit_equal(law):
    got = getattr(g711, f"{law}_encode")(torch.from_numpy(PCM))
    assert got.dtype == torch.uint8 and got.shape == PCM.shape
    ref = np.asarray(getattr(jg711, f"{law}_encode")(PCM))
    assert np.array_equal(got.numpy(), ref)
    oracle = np.frombuffer(ORACLE[law][0](PCM.tobytes(), 2), np.uint8)
    assert np.array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("law", ["alaw", "mulaw"])
def test_decode_all_codes_bit_equal(law):
    got = getattr(g711, f"{law}_decode")(torch.from_numpy(CODES))
    assert got.dtype == torch.int16 and got.shape == CODES.shape
    ref = np.asarray(getattr(jg711, f"{law}_decode")(CODES))
    assert np.array_equal(got.numpy(), ref)
    oracle = np.frombuffer(ORACLE[law][1](CODES.tobytes(), 2), np.int16)
    assert np.array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("law", ["alaw", "mulaw"])
def test_ops_keep_shape_and_take_host_arrays(law):
    """A [frames, channels] payload keeps its shape; numpy input runs on
    the CPU, as a CPU tensor does."""
    x = np.random.default_rng(0).integers(-32768, 32768, (480, 2), dtype=np.int16)
    enc, dec = getattr(g711, f"{law}_encode"), getattr(g711, f"{law}_decode")
    a, b = enc(x), enc(torch.from_numpy(x))
    assert a.shape == (480, 2) and a.device.type == "cpu" and torch.equal(a, b)
    assert torch.equal(dec(a.numpy()), dec(a))


def _audio(n, spb, channels, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, (spb, channels), dtype=np.int16) for _ in range(n)]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("law", ["alaw", "mulaw"])
def test_codec_elements_match_jax(law, payload):
    """appsrc ! {law}enc ! {law}dec ! appsink and appsrc ! {law}enc !
    appsink on seeded stereo S16: the same buffers, caps-driven shapes and
    timestamps as the JAX package's."""
    frames = _audio(4, 800, 2, seed=7)
    dur = 800 * 10**9 // 8000
    caps = "audio/x-raw,format=S16,rate=8000,channels=2,layout=interleaved"

    def bufs(tensor):
        return [dict(data=torch.from_numpy(f) if tensor else f, pts=i * dur, duration=dur)
                for i, f in enumerate(frames)]

    for tail in (f"{law}enc", f"{law}enc ! {law}dec"):
        launch = f"appsrc name=src ! {tail} ! appsink name=sink"
        ref = run_launch(fx, launch, bufs(False), caps=caps)
        got = run_launch(tfx, launch, bufs(payload == "torch"), caps=caps)
        assert len(got[0]) == 4 and got == ref


def test_decoder_takes_host_bytes_to_its_device():
    """A depayloader hands the decoder host arrays: mulawdec moves them to
    its device and decodes there (here the CPU) into int16 tensors."""
    p = tfx.parse_launch("appsrc name=src ! mulawdec ! appsink name=sink")
    p.by_name("src").set_property("caps", tfx.parse_caps("audio/x-mulaw,rate=8000,channels=1"))
    codes = np.arange(256, dtype=np.uint8).reshape(-1, 1)
    p.by_name("src").push_buffer(tfx.Buffer(codes, pts=0))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    out = p.by_name("sink").samples[0].buffer.data
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int16
    assert np.array_equal(out.numpy().ravel(), np.asarray(jg711.mulaw_decode(codes.ravel())))


# tests/test_image_flv.py: its FLV demuxer cases (mu-law audio, into
# mulawdec, and AVC video).  The image codecs, imagersoverlay and CD+G wait
# for the elements/image slice; the file's top-level CD+G import is left out.
IMAGE = "elements/image (rspngenc, gifenc/gifdec, imagersdec, imagersoverlay, cdgparse/cdgdec)"
MIRRORED = mirror_jax_tests(
    "test_image_flv.py", globals(),
    skip={"TestPngGif": IMAGE, "TestImageOverlay": IMAGE, "TestCdg": IMAGE},
    drop=("gst_plugins_rs_tpu.elements.image.cdg",))
