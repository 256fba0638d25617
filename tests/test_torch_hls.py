"""The port's HLS sinks (elements/net/hlssink.py, hlsmultivariant.py) and
playlist model (net/hls.py) against the JAX package's.

tests/test_hls.py runs on the port with the same inputs and assertions.
Then the same inputs, from numpy and from tensor payloads, go through each
sink in both packages: the playlists, init segments and media segments
are equal byte for byte; chip_smoke.py's live origin (hlscmafsink and
dashsink2 behind a tee) writes the JAX package's files, and on the port
its fetch over HTTP, its frames back from the segments and its QR record
hold at a small size."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.net import hls as jhls
from gst_plugins_rs_tpu_torch.net import hls
from torch_parity_helpers import mirror_jax_tests, port_on_cpu

import chip_smoke


@pytest.fixture(autouse=True)
def _port_cpu(tmp_path, monkeypatch):
    # tests/test_hls.py changes the working directory; give it back after
    monkeypatch.chdir(tmp_path)
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_hls.py", globals())


def _files(root):
    """{path under root: bytes}, the root's own path in a file (a playlist
    that names absolute URIs) written as <out>."""
    root = Path(root)
    return {str(f.relative_to(root)): f.read_bytes().replace(str(root).encode(), b"<out>")
            for f in sorted(root.rglob("*")) if f.is_file()}


def _payload(pkg, data, payload):
    return torch.from_numpy(np.ascontiguousarray(data)) if pkg is tfx and payload == "torch" \
        else data


def _push(pkg, p, caps, buffers, payload, dur):
    src = p.by_name("src")
    src.set_property("caps", pkg.parse_caps(caps))
    for i, b in enumerate(buffers):
        src.push_buffer(pkg.Buffer(_payload(pkg, b, payload), pts=i * dur, duration=dur))
    src.end_of_stream()
    p.play_until_eos()


def _both(tmp_path, run, payload):
    """run(pkg, out_dir, payload) in each package; returns the two trees."""
    got, ref = tmp_path / "port", tmp_path / "jax"
    got.mkdir()
    ref.mkdir()
    run(tfx, got, payload)
    run(fx, ref, "numpy")
    return _files(got), _files(ref)


def _frames(n, w=32, h=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


def _audio(n, spb=4800, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, (spb, 2)).astype(np.float32) for _ in range(n)]


def _cmaf_sink(out, extra=""):
    return (f"hlscmafsink name=hls target-duration=1 playlist-location={out}/media.m3u8 "
            f"init-location={out}/init%05d.mp4 location={out}/seg%05d.m4s {extra}")


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_hlscmafsink_video_bytes_equal(tmp_path, payload):
    """RGBA frames at 4/1 into hlscmafsink (one-second segments, a sliding
    window of two): playlist, init and segments byte for byte."""
    def run(pkg, out, pl):
        p = pkg.parse_launch("appsrc name=src ! " + _cmaf_sink(out, "max-files=2 playlist-length=2"))
        _push(pkg, p, "video/x-raw,format=RGBA,width=32,height=16,framerate=4/1",
              _frames(14), pl, 250_000_000)

    got, ref = _both(tmp_path, run, payload)
    assert got == ref and sum(k.endswith(".m4s") for k in got) == 2


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_hlscmafsink_audio_bytes_equal(tmp_path, payload):
    def run(pkg, out, pl):
        p = pkg.parse_launch("appsrc name=src ! " + _cmaf_sink(out, "playlist-type=event"))
        _push(pkg, p, "audio/x-raw,format=F32,rate=48000,channels=2,layout=interleaved",
              _audio(25), pl, 100_000_000)

    got, ref = _both(tmp_path, run, payload)
    assert got == ref and sum(k.endswith(".m4s") for k in got) == 3


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_hlssink3_bytes_equal(tmp_path, payload):
    """Raw audio through cmafmux into hlssink3 (a premuxed stream) and, in
    another run, through hlssink3's embedded MPEG-TS muxer as an
    elementary stream: the same files in both packages."""
    def run(pkg, out, pl):
        p = pkg.parse_launch(
            "appsrc name=src ! cmafmux fragment-duration=1000000000 ! hlssink3 "
            f"playlist-location={out}/p.m3u8 init-location={out}/init%05d.mp4 "
            f"location={out}/seg%05d.ts")
        _push(pkg, p, "audio/x-raw,format=F32,rate=48000,channels=2,layout=interleaved",
              _audio(20), pl, 100_000_000)

    got, ref = _both(tmp_path, run, payload)
    assert got == ref and sum(k.endswith(".ts") for k in got) == 2


def test_hlswebvttsink_bytes_equal(tmp_path):
    def run(pkg, out, pl):
        p = pkg.parse_launch(f"appsrc name=src ! tttojson ! jsontovtt ! hlswebvttsink "
                             f"playlist-location={out}/subs.m3u8 location={out}/sub%05d.vtt")
        src = p.by_name("src")
        src.set_property("caps", pkg.parse_caps("text/x-raw,format=utf8"))
        for i, word in enumerate(("hello", "world", "again")):
            src.push_buffer(pkg.Buffer(word, pts=i * 2 * 10**9, duration=2 * 10**9))
        src.end_of_stream()
        p.play_until_eos()

    got, ref = _both(tmp_path, run, "numpy")
    assert got == ref and sum(k.endswith(".vtt") for k in got) == 3


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_hlsmultivariantsink_bytes_equal(tmp_path, payload):
    """Two audio variants (cmafmux each) into hlsmultivariantsink's request
    pads: master playlist, variant playlists and segments byte for byte."""
    def run(pkg, out, pl):
        mv = pkg.element_factory_make("hlsmultivariantsink")
        mv.set_property("playlist-location", str(out / "master.m3u8"))
        mv.set_property("variant-playlist-pattern", str(out / "variant%u.m3u8"))
        mv.set_property("segment-pattern", str(out / "v%u_seg%%05d.m4s"))
        mv.set_property("target-duration", 1)
        p = pkg.Pipeline()
        p.add(mv)
        srcs = []
        for k, rate in enumerate((48000, 24000)):
            src = pkg.element_factory_make("appsrc", f"src{k}")
            src.set_property("caps", pkg.parse_caps(
                f"audio/x-raw,format=F32,rate={rate},channels=1,layout=interleaved"))
            mux = pkg.element_factory_make("cmafmux")
            mux.set_property("fragment-duration", 1_000_000_000)
            p.add(src)
            p.add(mux)
            src.link(mux)
            mux.srcpad.link(mv.request_sink_pad(bandwidth=rate * 32))
            rng = np.random.default_rng(rate)
            for i in range(20):
                data = rng.uniform(-0.5, 0.5, (rate // 10, 1)).astype(np.float32)
                src.push_buffer(pkg.Buffer(_payload(pkg, data, pl), pts=i * 10**8,
                                           duration=10**8))
            srcs.append(src)
        for src in srcs:
            src.end_of_stream()
        p.play_until_eos()

    got, ref = _both(tmp_path, run, payload)
    assert got == ref and "master.m3u8" in got and sum(k.endswith(".m4s") for k in got) == 4


def test_playlist_model_renders_as_the_jax_packages():
    """net/hls.py: the same media playlist from the same segments, through
    the sliding window and its evictions, and the same multivariant
    playlist from the same variants and renditions."""
    out = []
    for mod in (hls, jhls):
        pl = mod.MediaPlaylist(target_duration=2, playlist_length=3, max_files=4,
                               init_uri="init.mp4", enable_endlist=True)
        evicted = [pl.add_segment(mod.Segment(f"s{i}.m4s", 1.5 + i / 10, f"/x/s{i}.m4s"))
                   for i in range(6)]
        pl.ended = True
        master = mod.master_playlist(
            [mod.Variant("v0.m3u8", 100000, 640, 360, "avc1", audio="aud"),
             mod.Variant("i0.m3u8", 20000, is_i_frame=True)],
            [mod.AlternativeMedia("audio", "aud", "English", "a.m3u8", "en", default=True)])
        out.append((pl.render(), evicted, master))
    assert out[0] == out[1]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_origin_writes_the_jax_packages_files(tmp_path, payload):
    """chip_smoke.py's origin sinks (a tee into hlscmafsink, dashsink2's
    video_0 pad and an appsink) on the same frames at 2/1: the same
    playlist, MPD, init and media segments in both packages."""
    frames = _frames(4, w=64, h=48, seed=5)

    def run(pkg, out, pl):
        chip_smoke.origin_run(pkg, out, [_payload(pkg, f, pl) for f in frames], fps=2)

    got, ref = _both(tmp_path, run, payload)
    assert got == ref
    assert sorted(got) == ["dash/init_0.mp4", "dash/manifest.mpd", "dash/seg_0_1.m4s",
                           "dash/seg_0_2.m4s", "hls/init00000.mp4", "hls/media.m3u8",
                           "hls/segment00000.m4s", "hls/segment00001.m4s"]


def test_smoke_origin_checks_hold_on_the_cpu(tmp_path):
    """chip_smoke.py's 4q (b) at 64x48 on the CPU: the graded origin with
    its QR record, fetched over HTTP by reqwesthttpsrc, gives back every
    frame the appsink took, bit for bit, from both sinks' segments, and
    check-last-frame-qrcode decodes the record."""
    from gst_plugins_rs_tpu_torch.utils import validate

    grade = chip_smoke.write_grade(tmp_path / "grade.cube")
    record = chip_smoke.origin_record(7, 4)
    side = chip_smoke.qr_png(tfx, record, tmp_path / "qr.png", module_px=1)
    frames = chip_smoke.origin_frames(4, seed=7, w=64, h=48, device="cpu")
    p = chip_smoke.origin_run(tfx, tmp_path / "out", frames, grade=grade,
                              qr=tmp_path / "qr.png", fps=2)
    out = [s.buffer.data for s in p.by_name("sink").samples]
    checks, files = chip_smoke.origin_checks(tfx, tmp_path / "out", out, 4, record)
    assert all(checks.values()), checks
    assert side == 33 and len(files) == 8
    assert validate.run_action("check-last-frame-qrcode", p, sink_name="sink",
                               expected_fields=json.loads(record)) == record
    assert os.path.exists(tmp_path / "out" / "hls" / "media.m3u8")
