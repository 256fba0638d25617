"""Pipelines of the PyTorch port against the JAX package, on the CPU.

The same `parse_launch` strings run through both packages; with
`weights-path` pointing at one synthetic official-style checkpoint, both
yoloxinference elements compute with the same weights.  Compared: buffer
timestamps/offsets, the `yolox-out` tensors (|d| / (|ref| + 1e-2) < 1e-3,
the engine gate of tests/test_yolox_fast.py) and the decoded detections
(same labels, confidences within 1e-3, boxes within one pixel: the boxes are
truncated to integers, so a 1e-4 difference can move one by a pixel).
`yoloxtensordec` is also held against the JAX decoder on crafted tensors,
with detections compared as sets: torch.topk may order tied scores
differently from lax.top_k.

Also here: the port imports nothing of JAX (an AST walk of the package and
chip_smoke.py), and an entry point raises when there is no CUDA device and
the CPU was not requested.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core import Buffer as JBuffer
from gst_plugins_rs_tpu.core.adapter import Adapter as JAdapter
from gst_plugins_rs_tpu.core.registry import factory_class as jfactory
from gst_plugins_rs_tpu.elements.analytics import meta as jmeta
from gst_plugins_rs_tpu.elements.sinks import AppSink as JAppSink
from gst_plugins_rs_tpu.models import yolox as jyolox

from gst_plugins_rs_tpu_torch.core import Buffer as TBuffer
from gst_plugins_rs_tpu_torch.core.adapter import Adapter as TAdapter
from gst_plugins_rs_tpu_torch.core.registry import factory_class as tfactory
from gst_plugins_rs_tpu_torch.core.registry import list_factories as tlist
from gst_plugins_rs_tpu_torch.elements.analytics import meta as tmeta
from gst_plugins_rs_tpu_torch.elements.sinks import AppSink as TAppSink
from torch_parity_helpers import official_checkpoint, random_variables, rel_err, to_jax

ROOT = Path(__file__).resolve().parents[1]
SIZE = 64


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tfx.requested_device()
    tfx.set_device("cpu")
    yield
    tfx.set_device(prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(flax variables, path of the same weights as an official .pth)."""
    v = random_variables("tiny", seed=2)
    path = official_checkpoint(v, tmp_path_factory.mktemp("yolox") / "tiny.pth")
    return to_jax(v), str(path)


@pytest.fixture
def fast_jax_init(monkeypatch, weights):
    """The JAX element initialises its flax tree eagerly (~20 s at this
    size) and then overwrites every leaf from weights-path; hand it a tree
    of the right structure instead, so only the checkpoint's values count."""
    monkeypatch.setattr(jyolox.Yolox, "init", lambda self, rng, x: weights[0])


def _yolox_out(buf, meta_mod):
    ts = [t for m in buf.iter_meta(meta_mod.TensorMeta) for t in m.tensors
          if t.id == "yolox-out"]
    assert len(ts) == 1
    return ts[0]


def _detections(buf, meta_mod):
    rm = buf.get_meta(meta_mod.AnalyticsRelationMeta)
    assert rm is not None
    return sorted((o.object_type, o.x, o.y, o.w, o.h, o.loc_conf_lvl) for o in rm.od)


def _same_detections(ref, got):
    assert len(ref) > 0  # these weights and frames do detect objects
    assert [d[0] for d in ref] == [d[0] for d in got]
    for r, g in zip(ref, got):
        assert all(abs(a - b) <= 1 for a, b in zip(r[1:5], g[1:5])), (r, g)
        assert abs(r[5] - g[5]) < 1e-3, (r, g)


def _compare_samples(jsamples, tsamples):
    assert len(jsamples) == len(tsamples) > 0
    for js, ts in zip(jsamples, tsamples):
        jb, tb = js.buffer, ts.buffer
        assert (jb.pts, jb.duration, jb.offset, jb.offset_end) == \
            (tb.pts, tb.duration, tb.offset, tb.offset_end)
        jt, tt = _yolox_out(jb, jmeta), _yolox_out(tb, tmeta)
        assert tuple(jt.dims) == tuple(tt.dims) == (1, 84, 85)
        assert isinstance(tt.data, torch.Tensor) and tt.data.device.type == "cpu"
        assert rel_err(np.asarray(jt.data), tt.data.numpy()) < 1e-3
        _same_detections(_detections(jb, jmeta), _detections(tb, tmeta))


@pytest.mark.parametrize("engine", ["fast", "fast-bf16", "reference"])
def test_single_stream_matches_jax(engine, weights, fast_jax_init):
    launch = (f"videotestsrc pattern=smpte num-buffers=2 "
              f"! video/x-raw,format=RGB,width={SIZE},height={SIZE} "
              f"! yoloxinference engine={engine} weights-path={weights[1]} "
              f"! yoloxtensordec box-confidence-threshold=0.3 "
              f"class-confidence-threshold=0.3 ! appsink name=sink")
    jp, tp = jfx.parse_launch(launch), tfx.parse_launch(launch)
    jp.play_until_eos()
    tp.play_until_eos()
    jsamples, tsamples = jp.by_name("sink").samples, tp.by_name("sink").samples
    if engine == "fast-bf16":
        # bf16 stem+dark2: scores within the JAX package's bf16 gate
        for js, ts in zip(jsamples, tsamples):
            jt, tt = _yolox_out(js.buffer, jmeta), _yolox_out(ts.buffer, tmeta)
            d = np.abs(np.asarray(jt.data)[..., 4:] - tt.data.numpy()[..., 4:])
            assert float(d.max()) < 0.05
        return
    _compare_samples(jsamples, tsamples)


def _combined(pkg, appsink_cls, weights_path, n_streams=2, frames=2):
    launch = []
    for i, pattern in enumerate(["smpte", "checkers-8", "gradient"][:n_streams]):
        launch.append(
            f"videotestsrc pattern={pattern} num-buffers={frames} "
            f"! video/x-raw,format=RGB,width={SIZE},height={SIZE},framerate=10/1 "
            + ("! analyticscombiner name=comb batch-duration=100000000 "
               f"! yoloxinference weights-path={weights_path} ! analyticssplitter name=split"
               if i == 0 else "! comb."))
    p = pkg.parse_launch(" ".join(launch))
    split = p.by_name("split")
    sinks = []
    for i in range(n_streams):
        sink = appsink_cls(f"out{i}")
        p.add(sink)
        split._get_src(i).link(sink.sinkpad)
        sinks.append(sink)
    p.play_until_eos()
    return [s.samples for s in sinks]


def test_combiner_pipeline_matches_jax(weights, fast_jax_init):
    jstreams = _combined(jfx, JAppSink, weights[1])
    tstreams = _combined(tfx, TAppSink, weights[1])
    for js, ts in zip(jstreams, tstreams):
        assert len(js) == len(ts) == 2
        for a, b in zip(js, ts):
            assert (a.buffer.pts, a.buffer.offset) == (b.buffer.pts, b.buffer.offset)
            ja, tb = _yolox_out(a.buffer, jmeta), _yolox_out(b.buffer, tmeta)
            assert tuple(ja.dims) == tuple(tb.dims) == (1, 84, 85)
            assert rel_err(np.asarray(ja.data), tb.data.numpy()) < 1e-3
    # one forward pass per window: both streams' tensors share a batch
    for i in range(2):
        storages = {_yolox_out(s[i].buffer, tmeta).data.untyped_storage().data_ptr()
                    for s in tstreams}
        assert len(storages) == 1


def _crafted_out():
    """[1, 40, 85] detections: overlapping boxes per class (IoU above and
    below the threshold), rows under either threshold, tied scores."""
    rng = np.random.RandomState(0)
    out = np.zeros((40, 85), np.float32)
    out[:, 0:2] = rng.uniform(40, 600, (40, 2))
    out[:, 2:4] = rng.uniform(20, 120, (40, 2))
    out[:, 4] = rng.uniform(0.0, 1.0, 40)
    out[:, 5:] = rng.uniform(0.0, 0.3, (40, 80))
    cls = rng.randint(0, 4, 40)
    out[np.arange(40), 5 + cls] = rng.uniform(0.3, 1.0, 40)
    out[10:14, 0:4] = out[9, 0:4] + [[2, 1, 3, 0], [1, 2, 0, 4], [60, 0, 0, 0], [0, 70, 0, 0]]
    out[9:14, 4] = [0.9, 0.85, 0.8, 0.95, 0.7]
    out[9:14, 5 + 2] = 0.9
    out[20:23, 4] = 0.8   # three equal combined scores in three classes
    out[20:23, 5:] = 0.1
    out[[20, 21, 22], [5 + 1, 5 + 2, 5 + 3]] = 0.75
    return out[None]


def _decode_with(pkg, meta_mod, buffer_cls, data, label_file):
    dec = pkg.element_factory_make("yoloxtensordec")
    dec.set_property("label-file", label_file)
    dec.start()
    buf = buffer_cls(None, pts=0)
    buf.add_meta(meta_mod.TensorMeta([meta_mod.Tensor(
        "yolox-out", meta_mod.TensorDataType.FLOAT32, tuple(data.shape),
        meta_mod.TensorDimOrder.ROW_MAJOR, data)]))
    out = dec.transform_ip(buf)
    rm = out.get_meta(meta_mod.AnalyticsRelationMeta)
    dets = {(o.object_type, o.x, o.y, o.w, o.h, round(float(o.loc_conf_lvl), 6)) for o in rm.od}
    return dets, len(rm.cls), len(rm.relations)


def test_tensordec_matches_jax_on_crafted_tensors(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("person\nbicycle\ncar\n")
    out = _crafted_out()
    jd, jn_cls, jn_rel = _decode_with(jfx, jmeta, JBuffer, jnp.asarray(out), str(labels))
    td, tn_cls, tn_rel = _decode_with(tfx, tmeta, TBuffer, torch.from_numpy(out), str(labels))
    assert len(jd) > 5
    assert jd == td
    assert (jn_cls, jn_rel) == (tn_cls, tn_rel) == (len(td), len(td))
    assert {d[0] for d in td} <= {"person", "bicycle", "car", "CLASS-3"}


def test_core_plumbing_matches_jax():
    """Caps negotiation, capsfilter, identity, queue and appsink carry the
    same frames and timestamps in both packages."""
    launch = ("videotestsrc pattern=checkers-8 num-buffers=3 "
              "! video/x-raw,format=RGB,width=32,height=24,framerate=25/1 "
              "! identity ! queue ! appsink name=sink")
    jp, tp = jfx.parse_launch(launch), tfx.parse_launch(launch)
    jp.play_until_eos()
    tp.play_until_eos()
    js, ts = jp.by_name("sink").samples, tp.by_name("sink").samples
    assert len(js) == len(ts) == 3
    for a, b in zip(js, ts):
        assert (a.buffer.pts, a.buffer.duration, a.buffer.offset) == \
            (b.buffer.pts, b.buffer.duration, b.buffer.offset)
        assert repr(a.caps) == repr(b.caps)
        assert isinstance(b.buffer.data, torch.Tensor)
        assert np.array_equal(np.asarray(a.buffer.data), b.buffer.data.numpy())


def test_adapter_and_appsink_handle_tensors():
    """core/adapter concatenates torch payloads like the JAX adapter does
    arrays; appsink.concat_audio copies device tensors to the host."""
    chunks = [np.arange(6 * i, 6 * i + 6, dtype=np.float32).reshape(3, 2) for i in range(3)]
    ja, ta = JAdapter(), TAdapter()
    for i, c in enumerate(chunks):
        ja.push(JBuffer(jnp.asarray(c), pts=i * 100, offset=i * 3))
        ta.push(TBuffer(torch.from_numpy(c), pts=i * 100, offset=i * 3))
    for n in (2, 4, 3):
        a, b = ja.take(n), ta.take(n)
        assert isinstance(b, torch.Tensor)
        assert np.array_equal(np.asarray(a), b.numpy())
        assert ja.prev_pts() == ta.prev_pts() and ja.prev_offset() == ta.prev_offset()
    sink = TAppSink("s")
    for c in chunks:
        sink.render(TBuffer(torch.from_numpy(c)))
    host = sink.concat_audio()
    assert isinstance(host, np.ndarray) and np.array_equal(host, np.concatenate(chunks))


def test_factories_mirror_jax():
    """The slices register their factories with the JAX package's
    properties and caps."""
    names = tlist()
    assert {"yoloxinference", "burn-yoloxinference", "yoloxtensordec", "analyticscombiner",
            "analyticssplitter", "videotestsrc", "appsrc", "appsink", "fakesink",
            "capsfilter", "identity", "queue", "colorlut", "hsvfilter",
            "hsvdetector", "audiotestsrc", "tee", "audioconvert", "audioresample",
            "videoconvert", "audioloudnorm", "ebur128level", "rsaudioecho", "audiornnoise",
            "agingradio", "hrtfrender", "sofalizer", "audiomixer", "videoscale",
            "videoconvertscale", "skiacompositor", "roundedcorners", "colordetect",
            "videocompare", "demucs", "whispertranscriber", "handdetectiontensordec",
            "loudnormbank", "volume", "videoflip", "videocrop", "videorate",
            "audiorate",
            # the host-only generic, switching and text families
            "originalbuffersave", "originalbufferrestore", "rsfilesrc", "rsfilesink",
            "intersink", "intersrc", "compressenc", "compressdec", "zlibcompress",
            "zlibdecompress", "deflatecompress", "deflatedecompress", "brotlicompress",
            "brotlidecompress", "gopbuffer", "debugseimetainserter", "sodiumencrypter",
            "sodiumdecrypter", "textahead", "streamgrouper", "s302mparse", "ac4parse",
            "uriplaylistbin", "viuersink", "ts-proxysink", "ts-proxysrc", "ts-appsrc",
            "ts-audiotestsrc", "ts-queue", "ts-blocking-adapter", "ts-intersink",
            "ts-intersrc", "ts-clocksync", "ts-input-selector", "ts-rtpdtmfsrc",
            "ts-tcpclientsrc", "decodebin", "togglerecord", "fallbackswitch", "livesync",
            "fallbacksrc", "regex", "textwrap", "textaccumulate", "jsongstenc",
            "jsongstparse",
            # the muxers and the closed-caption family
            "isofmp4mux", "cmafmux", "dashmp4mux", "onviffmp4mux", "isomp4mux",
            "onvifmp4mux", "mpegtsmux", "rsflvdemux", "tttocea608", "cea608tott",
            "cea608tojson", "tttojson", "jsontovtt", "ccdetect", "sccparse", "sccenc",
            "mccparse", "mccenc", "cea608overlay", "tttocea708", "cea608tocea708",
            "cea708mux", "cdpserviceinject", "cea708overlay", "st2038ancdemux",
            "st2038ancmux", "st2038anctocc", "st2038combiner", "st2038extractor",
            "cctost2038anc", "transcriberbin", "translationbin",
            # ONVIF metadata over RTP: the converters, G.711, the payloaders,
            # the onvifmetadata family and the RTP session
            "relationmeta2onvifmeta", "onvifmeta2relationmeta", "alawenc", "alawdec",
            "mulawenc", "mulawdec", "rtppcmapay2", "rtppcmupay2", "rtppcmadepay2",
            "rtppcmudepay2", "rtpL8pay2", "rtpL16pay2", "rtpL8depay2", "rtpL16depay2",
            "rtpklvpay2", "rtpklvdepay2", "onvifmetadatapay", "onvifmetadatadepay",
            "onvifmetadataparse", "onvifmetadatacombiner", "onvifmetadataextractor",
            "onvifmetadataoverlay", "rtponvifmetadatapay", "rtponvifmetadatadepay",
            "rtpsend", "rtprecv", "ts-jitterbuffer",
            # the rest of the RTP families: FEC, UDP, video, linear audio,
            # raw video, ancillary data, codecs, MPEG-TS and congestion control
            "raptorqenc", "raptorqdec", "udpsrc2", "ts-udpsrc", "ts-udpsink",
            "rtpvp8pay2", "rtpvp8depay2", "rtpvp9pay2", "rtpvp9depay2", "rtpav1pay2",
            "rtpav1depay2", "rtpjpegpay2", "rtpjpegdepay2", "rtpmp4apay2",
            "rtpmp4adepay2", "rtpmp4gpay2", "rtpmp4gdepay2", "rtpL24pay2",
            "rtpL24depay2", "rtpL20pay", "rtpL20depay", "rtpav1pay", "rtpav1depay",
            "rtpvrawpay2", "rtpvrawdepay2", "rtpsmpte291pay", "rtpsmpte291depay",
            "rtpopuspay2", "rtpopusdepay2", "rtpac3pay2", "rtpac3depay2", "rtpmpapay2",
            "rtpmpadepay2", "rtpmpvpay2", "rtpmpvdepay2", "rtpamrpay2", "rtpamrdepay2",
            "rtpmparobustdepay2", "rtpmp2tpay2", "rtpmp2tdepay2", "mpegtslivesrc",
            "rtpgccbwe",
            # the codec and image families
            "claxondec", "lewtondec", "dav1ddec", "ffv1dec", "rav1enc", "rspngenc", "gifenc",
            "gifdec", "rswebpdec", "imagersdec", "imagersoverlay", "cdgparse",
            "cdgdec",
            # the RTSP, HTTP, HLS and DASH families
            "rtspsrc2", "reqwesthttpsrc", "icecastsink", "hlscmafsink", "hlssink3",
            "hlswebvttsink", "hlsmultivariantsink", "dashsink2",
            # the WebRTC family
            "webrtcsink", "webrtcsrc", "webrtcsend", "webrtcrecv", "whipsink", "whepsrc",
            "whipclientsink", "whepclientsrc", "whipserversrc", "whepserversink",
            "janusvrwebrtcsink", "janusvrwebrtcsrc", "awskvswebrtcsink",
            "uepswebrtcsink"} == set(names)
    assert len(names) == 225
    for name in names:
        jc, tc = jfactory(name), tfactory(name)
        assert [(p.name, repr(p.default), p.type, p.choices) for p in jc.PROPERTIES] == \
            [(p.name, repr(p.default), p.type, p.choices) for p in tc.PROPERTIES], name
        assert [(p.name, p.minimum, p.maximum, p.mutable) for p in jc.PROPERTIES] == \
            [(p.name, p.minimum, p.maximum, p.mutable) for p in tc.PROPERTIES], name
        assert jc._all_signals() == tc._all_signals(), name
        assert repr(getattr(jc, "EXTRA_PAD_TEMPLATES", None)) == \
            repr(getattr(tc, "EXTRA_PAD_TEMPLATES", None)), name
        assert {k: [(p.name, repr(p.default), p.type) for p in v]
                for k, v in jc._all_pad_properties().items()} == \
            {k: [(p.name, repr(p.default), p.type) for p in v]
             for k, v in tc._all_pad_properties().items()}, name
        for attr in ("SINK_CAPS", "SRC_CAPS", "SRC_TEMPLATE_CAPS", "SINK_TEMPLATE_CAPS"):
            assert repr(getattr(jc, attr, None)) == repr(getattr(tc, attr, None)), (name, attr)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


PIL_FILES = {f"gst_plugins_rs_tpu_torch/{m}" for m in (
    "utils/cea608_atlas.py", "elements/image/codecs.py", "elements/image/overlay.py")} | {
    "chip_smoke.py"}


def test_port_imports_no_jax():
    files = sorted((ROOT / "gst_plugins_rs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    names = {str(f.relative_to(ROOT)) for f in files}
    # the audio slices' modules are among them
    for mod in ("ops/ebur128.py", "ops/loudnorm.py", "ops/loudnorm_limiter.py", "ops/echo.py",
                "ops/resample.py", "ops/yuv.py", "elements/generic/convert.py",
                "elements/audiofx/audioloudnorm.py", "elements/audiofx/ebur128level.py",
                "elements/audiofx/audioecho.py", "ops/rfft.py", "ops/rnnoise.py",
                "ops/rnnoise_gru.py", "ops/agingradio.py", "ops/hrtf.py", "ops/sofa.py",
                "elements/audiofx/audiornnoise.py", "elements/audiofx/agingradio.py",
                "elements/audiofx/hrtfrender.py", "elements/audiofx/sofalizer.py",
                "elements/audiofx/audiomixer.py", "ops/resize.py", "ops/image_resize.py",
                "ops/palette.py", "ops/imagehash.py", "elements/video/videoscale.py",
                "elements/video/compositor.py", "elements/video/roundedcorners.py",
                "elements/video/colordetect.py", "elements/video/videocompare.py",
                "models/demucs.py", "elements/audiofx/demucs.py", "net/nacl.py",
                "codecs/brotli.py", "core/payload.py", "elements/generic/buffers.py",
                "elements/generic/io.py", "elements/generic/gopbuffer.py",
                "elements/generic/debugsei.py", "elements/generic/sodium.py",
                "elements/generic/misc.py", "elements/generic/threadshare_extra.py",
                "elements/generic/decodebin.py", "elements/utilsfx/togglerecord.py",
                "elements/utilsfx/switching.py", "elements/utilsfx/fallbacksrc.py",
                "elements/text/elements.py", "mux/bmff.py", "mux/reader.py",
                "mux/mpegts.py", "elements/mux/isobmff.py", "elements/mux/tsmux.py",
                "elements/mux/flv.py", "ops/cea608.py", "ops/cea708.py", "ops/st2038.py",
                "elements/cc/elements.py", "elements/cc/files.py", "elements/cc/overlay.py",
                "elements/cc/cea708.py", "elements/cc/st2038.py",
                "elements/cc/transcriberbin.py", "elements/cc/translationbin.py",
                "elements/analytics/onvif.py", "net/rtp.py", "ops/g711.py",
                "elements/net/codecs.py", "elements/net/rtppay.py", "elements/net/onvif.py",
                "net/rtcp.py", "net/jitterbuffer.py", "elements/net/rtpbin2.py",
                "net/fountain.py", "net/netio.py", "net/context.py", "net/mpa.py",
                "net/gcc.py", "elements/net/raptorq.py", "elements/net/udp.py",
                "elements/net/rtpvideo.py", "elements/net/rtpextra.py",
                "elements/net/rtpcodecs.py", "elements/net/mp2t.py",
                "elements/net/gccbwe.py", "codecs/flac.py", "codecs/avlib.py",
                "elements/audiofx/claxondec.py", "elements/audiofx/lewtondec.py",
                "elements/video/avcodecs.py", "elements/image/codecs.py",
                "elements/image/overlay.py", "elements/image/cdg.py",
                "codecs/qr.py", "utils/validate.py", "utils/tracers.py", "utils/native.py",
                "utils/registry_dump.py", "launch.py", "__main__.py", "net/sdp.py",
                "net/hls.py", "elements/net/rtsp.py", "elements/net/http.py",
                "elements/net/hlssink.py", "elements/net/hlsmultivariant.py",
                "elements/net/dashsink.py", "net/stun.py", "net/ice.py", "net/dtls.py",
                "net/srtp.py", "net/sctp.py", "net/webrtc_peer.py",
                "net/webrtc_signalling.py", "net/sigv4.py", "elements/net/webrtcbin2.py",
                "elements/net/webrtc.py", "elements/net/whipwhep.py",
                "elements/net/webrtchttp.py", "elements/net/kvs_ueps.py",
                "elements/net/janusvr.py"):
        assert f"gst_plugins_rs_tpu_torch/{mod}" in names, mod
    banned = ("jax", "jaxlib", "flax", "gst_plugins_rs_tpu")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f.relative_to(ROOT)} imports {mod}"
            # Pillow only where the port uses it as a codec library: the
            # script that draws cea608overlay's bundled atlas, the image
            # codecs and imagersoverlay's file decode; and the smoke's RTSP
            # camera, whose sensor encodes its frames as JPEG (the port has
            # no JPEG encoder, nor has the JAX package)
            if str(f.relative_to(ROOT)) not in PIL_FILES:
                assert top != "PIL", f"{f.relative_to(ROOT)} imports {mod}"


def test_entry_point_raises_without_cuda(monkeypatch):
    """No CUDA device and no request for the CPU: the entry points raise
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tfx.set_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfx.device()
    p = tfx.parse_launch(f"videotestsrc num-buffers=1 "
                         f"! video/x-raw,format=RGB,width={SIZE},height={SIZE} "
                         f"! yoloxinference ! appsink name=sink")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.play_until_eos()
    assert p.by_name("sink").samples == []


def test_shard_is_not_ported_yet():
    """shard=true is ported (tests/test_torch_model_parallel.py holds both
    modes against JAX): the element builds its mesh over every visible
    device at start, on the batch axis or, in tensor mode, the tp axis."""
    tfx.set_virtual_devices(8)
    try:
        det = tfx.element_factory_make("yoloxinference")
        det.set_property("shard", True)
        det.start()
        assert det._mesh is not None and det._mesh.shape == {"batch": 8}
        det.stop()
        det.set_property("shard-mode", "tensor")
        det.start()
        assert det._mesh.shape == {"tp": 8}
        det.stop()
        assert det._mesh is None
    finally:
        tfx.set_virtual_devices(None)
