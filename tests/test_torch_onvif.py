"""The port's ONVIF metadata family against the JAX package's.

tests/test_onvif.py runs on the port with the same inputs and assertions.
Then, on seeded input: the XML builder and parser (equal strings, equal
detections), the box overlay (bit-equal frames, from numpy and from tensor
payloads), and the ONVIF camera of chip_smoke.py (`onvif_pipeline`: YOLOX
detections published as ONVIF metadata over RTP and drawn back on the
frames) at YOLOX-tiny 64x64 in both packages with one weight tree.  Its
detections are held to YOLOX's parity gates (labels equal, boxes within one
pixel, confidences within 1e-3), compared as sets since torch.topk may
order tied scores otherwise; fed the same relation metas, its ONVIF stages
give equal XML frames, RTP packets and frames.

The JAX package's onvifmetadatacombiner proxies caps queries on its meta
pad to the media branch's downstream, so onvifmetadataparse cannot
negotiate into it; the port's meta pad answers its own template.  The
comparisons give the JAX element the port's answer (`_jax_meta_pad`)."""
import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.elements.analytics import meta as jmeta
from gst_plugins_rs_tpu.elements.analytics import onvif as jonvif
from gst_plugins_rs_tpu.models import yolox as jyolox
from gst_plugins_rs_tpu_torch.elements.analytics import meta as tmeta
from gst_plugins_rs_tpu_torch.elements.analytics import onvif as tonvif
from torch_parity_helpers import (
    mirror_jax_tests, official_checkpoint, payload_summary, port_on_cpu, random_variables, to_jax)


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_onvif.py", globals())

SIZE = 64  # YOLOX-tiny at the size __graft_entry__.entry() uses
LABELS = ("person", "car", "bicycle", "dog", "Unknown")


def _relation_metas(mod, n, seed, width=SIZE, height=SIZE):
    """n seeded relation metas of package `mod`'s meta module: 0-5 boxes
    each, some reaching past the frame, likelihoods as Python floats."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = mod.AnalyticsRelationMeta()
        for _ in range(int(rng.integers(0, 6))):
            x, y = (int(v) for v in rng.integers(-8, [width, height]))
            w, h = (int(v) for v in rng.integers(1, [width // 2, height // 2]))
            m.add_od_mtd(LABELS[int(rng.integers(len(LABELS)))], x, y, w, h,
                         float(rng.random()))
        out.append(m)
    return out


def _rows(rel):
    return [(o.object_type, o.x, o.y, o.w, o.h, o.loc_conf_lvl) for o in rel.od]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metadata_xml_matches_jax(seed):
    """build_metadata_xml gives the JAX package's strings for the same
    metas, times and sizes; parse_metadata_xml gives its detections back."""
    rng = np.random.default_rng(seed + 100)
    w, h = (int(v) for v in rng.integers(2, 4000, 2))
    for jm, tm in zip(_relation_metas(jmeta, 8, seed, w, h), _relation_metas(tmeta, 8, seed, w, h)):
        pts = int(rng.integers(0, 10**14))
        jx = jonvif.build_metadata_xml(jm, pts, w, h)
        tx = tonvif.build_metadata_xml(tm, pts, w, h)
        assert tx == jx
        assert _rows(tonvif.parse_metadata_xml(tx)) == _rows(jonvif.parse_metadata_xml(jx)) \
            == _rows(tm)
    assert tonvif.build_metadata_xml(None, None, w, h) == jonvif.build_metadata_xml(None, None, w, h)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("fmt, thickness", [("RGB", 2), ("RGBA", 3), ("BGRx", 1)])
def test_overlay_matches_jax(fmt, thickness, payload):
    """onvifmetadataoverlay on seeded frames and boxes (some past the
    frame's edges, some frames without metadata): bit-equal frames, and a
    tensor payload stays a tensor on its device."""
    chans = 3 if fmt == "RGB" else 4
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (48, 64, chans), dtype=np.uint8) for _ in range(4)]
    xmls = [[jonvif.build_metadata_xml(m, i, 64, 48)]
            for i, m in enumerate(_relation_metas(jmeta, 4, 9, 64, 48))]
    xmls[2] = []

    def run(pkg, onvif_mod, tensor):
        p = pkg.parse_launch(f"appsrc name=src ! onvifmetadataoverlay thickness={thickness} "
                             f"! appsink name=sink")
        p.by_name("src").set_property("caps", pkg.parse_caps(
            f"video/x-raw,format={fmt},width=64,height=48,framerate=30/1"))
        for i, (f, x) in enumerate(zip(frames, xmls)):
            buf = pkg.Buffer(torch.from_numpy(f) if tensor else f, pts=i)
            if x:
                buf.add_meta(onvif_mod.OnvifXMLFrameMeta(x))
            p.by_name("src").push_buffer(buf)
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return [s.buffer.data for s in p.by_name("sink").samples]

    ref = run(fx, jonvif, False)
    got = run(tfx, tonvif, payload == "torch")
    assert [payload_summary(g) for g in got] == [payload_summary(r) for r in ref]
    if payload == "torch":
        assert all(isinstance(g, torch.Tensor) for g in got)
    assert any(not np.array_equal(np.asarray(r), f) for r, f in zip(ref, frames))


def test_combiner_meta_pad_takes_parsed_metadata():
    """The fault the comparisons below work around: onvifmetadataparse
    linked to the combiner's meta pad, the combiner feeding
    onvifmeta2relationmeta ! onvifmetadataoverlay.  The JAX combiner's meta
    pad answers parse's caps query with the overlay's video caps, and
    negotiation fails; the port's answers its own template, and the frame
    reaches the combiner."""
    def run(pkg, onvif_mod):
        p = pkg.parse_launch("appsrc name=src ! onvifmetadataparse name=parse "
                             "onvifmetadatacombiner name=comb ! onvifmeta2relationmeta "
                             "! onvifmetadataoverlay ! appsink name=sink")
        p.by_name("parse").pad("src").link(p.by_name("comb").pad("meta"))
        src = p.by_name("src")
        src.set_property("caps", pkg.parse_caps("application/x-onvif-metadata"))
        src.push_buffer(pkg.Buffer(onvif_mod.build_metadata_xml(None, 0, 8, 8), pts=0))
        src.end_of_stream()
        p.play_until_eos()
        return p.by_name("comb")

    with pytest.raises(Exception, match="not-negotiated"):
        run(fx, jonvif)
    comb = run(tfx, tonvif)
    assert len(comb._pending_meta) == 1


def _jax_meta_pad(p):
    """Give the JAX combiner's meta pad the port's caps answer."""
    from gst_plugins_rs_tpu.core import QueryType
    from gst_plugins_rs_tpu.elements.net.onvif import META_CAPS

    comb = p.by_name("comb")

    def query(pad, q):
        if q.type == QueryType.CAPS:
            f = q.fields.get("filter")
            q.result["caps"] = META_CAPS if f is None else f.intersect(META_CAPS)
            return True
        return comb._default_query(pad, q)

    comb.meta_pad.query_function = query
    return p


def _camera(pkg, frames, metas=None, **kw):
    p, tap = cs.onvif_pipeline(pkg, size=SIZE, **kw)
    if pkg is fx:
        _jax_meta_pad(p)
    return cs.onvif_run(pkg, p, frames, metas=metas), tap


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_onvif_stages_match_jax(payload):
    """The ONVIF stages behind yoloxtensordec, fed the same relation metas
    in both packages: equal XML frames, RTP packets (fixed ssrc and
    offsets), RTCP-free media, frames and carried detections."""
    frames = cs.onvif_frames(4, size=SIZE, seed=3)
    jmetas = _relation_metas(jmeta, 4, 11)
    tmetas = _relation_metas(tmeta, 4, 11)

    tframes = [torch.from_numpy(f) for f in frames] if payload == "torch" else frames
    (jout, jtap), (tout, ttap) = (_camera(fx, frames, jmetas, detect=None),
                                  _camera(tfx, tframes, tmetas, detect=None))
    assert len(ttap.xml) == len(jtap.xml) == 4 and ttap.xml == jtap.xml
    assert len(ttap.rtp) >= 4 and ttap.rtp == jtap.rtp
    assert [payload_summary(b.data) for b in tout] == [payload_summary(b.data) for b in jout]
    for jb, tb, m in zip(jout, tout, tmetas):
        assert cs.onvif_detections(tfx, tb) == (_rows(m), _rows(m))
        assert cs.onvif_xml_frames(tfx, tb) == cs.onvif_xml_frames(fx, jb)


def test_pcmu_loop_matches_jax():
    """The camera's audio (chip_smoke.py's pcmu_pipeline): mulawenc !
    rtppcmupay2 ! rtpsend ! rtprecv ! rtppcmudepay2 ! mulawdec in both
    packages: equal RTP packets and decoded samples, the plain G.711 round
    trip of the input."""
    from gst_plugins_rs_tpu_torch.ops import g711

    audio = cs.onvif_audio(n=12, seed=5)
    runs = {}
    for pkg, data in ((fx, audio), (tfx, [torch.from_numpy(a) for a in audio])):
        p, tap = cs.pcmu_pipeline(pkg)
        runs[pkg] = ([np.asarray(b.data) for b in cs.pcmu_run(pkg, p, data)], tap)
    (jout, jtap), (tout, ttap) = runs[fx], runs[tfx]
    assert len(ttap.audio_rtp) == 12 and ttap.audio_rtp == jtap.audio_rtp
    assert len(tout) == 12 and all(np.array_equal(a, b) for a, b in zip(tout, jout))
    ref = g711.mulaw_decode(g711.mulaw_encode(np.concatenate(audio))).numpy()
    assert np.array_equal(np.concatenate(tout), ref)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(flax variables, path of the same weights as an official .pth)."""
    v = random_variables("tiny", seed=2)
    path = official_checkpoint(v, tmp_path_factory.mktemp("yolox") / "tiny.pth")
    return to_jax(v), str(path)


def test_onvif_camera_matches_jax(weights, monkeypatch):
    """chip_smoke.py's ONVIF camera at YOLOX-tiny 64x64, two seeded frames,
    one weight tree in both packages: detections within YOLOX's gates as
    sets, each package's XML carrying its decoder's detections back to the
    frames; fed the CPU port's relation metas, the JAX package's ONVIF
    stages give the port's XML, packets and frames."""
    # the JAX element's eager flax init is replaced by a tree of the right
    # structure; weights-path then sets every leaf (tests/test_torch_pipeline.py)
    monkeypatch.setattr(jyolox.Yolox, "init", lambda self, rng, x: weights[0])
    frames = cs.onvif_frames(2, size=SIZE, seed=4)
    detect = f"yoloxinference name=det engine=fast weights-path={weights[1]}"
    kw = dict(detect=detect, thresholds=(0.3, 0.3))
    jout, _ = _camera(fx, frames, **kw)
    tout, _ = _camera(tfx, frames, **kw)
    assert len(jout) == len(tout) == 2
    for jb, tb in zip(jout, tout):
        jdec, jback = cs.onvif_detections(fx, jb)
        tdec, tback = cs.onvif_detections(tfx, tb)
        assert len(jdec) > 0 and jdec == jback and tdec == tback
        assert cs._detections_within_gates(jdec, tdec), (jdec, tdec)
    metas = [copy.deepcopy(tb.get_meta(tmeta.AnalyticsRelationMeta)) for tb in tout]
    jmetas = [jmeta.AnalyticsRelationMeta() for _ in metas]
    for jm, tm in zip(jmetas, metas):
        for o in tm.od:  # as yoloxtensordec builds them: each box, then its class
            jm.add_od_mtd(o.object_type, o.x, o.y, o.w, o.h, o.loc_conf_lvl)
            jm.add_one_cls_mtd(o.loc_conf_lvl, o.object_type)
    (js, jtap), (ts, ttap) = (_camera(fx, frames, detect=None, metas=jmetas),
                              _camera(tfx, frames, detect=None, metas=metas))
    assert ttap.xml == jtap.xml and ttap.rtp == jtap.rtp and len(ttap.xml) == 2
    assert [payload_summary(b.data) for b in ts] == [payload_summary(b.data) for b in js]
