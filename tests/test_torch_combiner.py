"""analyticscombiner / analyticssplitter of the PyTorch port: the mirror of
tests/test_analytics_combiner_scenarios.py, and the combiner's timeout under
threads.

The nine scenarios (six of the combiner, three of the splitter, after the
reference's analyticscombiner.rs and analyticssplitter.rs) run on the port
with the same inputs and assert the same values.  The last tests run the
combiner on the system clock with force-live: a stream that stalls makes the
windows come out on the clock's thread (the aggregator timeout) while a
streaming thread keeps appending to the pad queues.  The timeout must run
under the base's aggregator lock, taken before the combiner's own lock, as a
streaming thread takes them; every buffer must come out once, in order.
Each run has its own time limit, so a deadlock fails the test instead of
hanging the suite.
"""
import logging
import sys
import threading

import gst_plugins_rs_tpu_torch  # noqa: F401  (registers the elements)
from gst_plugins_rs_tpu_torch.core import (
    Buffer,
    Caps,
    Event,
    EventType,
    FlowReturn,
    Pad,
    PadDirection,
    SECOND,
    Segment,
    element_factory_make,
)
from gst_plugins_rs_tpu_torch.core.clock import SystemClock, TestClock
from gst_plugins_rs_tpu_torch.elements.analytics.combiner import BatchMeta

MS = SECOND // 1000
NS = 1
DUR_33 = 33_333_333  # 33_333_333 ns like the reference buffers


def rgb_caps(fps):
    return Caps.builder(
        "video/x-raw", format="RGB", width=320, height=240, framerate=(fps, 1)
    )


def gray_caps(fps):
    return Caps.builder(
        "video/x-raw", format="GRAY8", width=320, height=240, framerate=(fps, 1)
    )


UNKNOWN = Caps.builder("application/unknown")


class Capture:
    """Records buffers + events from a src pad (the gst_check harness pull
    side)."""

    def __init__(self, name="capture"):
        self.pad = Pad(name, PadDirection.SINK)
        self.buffers = []
        self.events = []
        self.pad.chain_function = lambda pad, buf: (self.buffers.append(buf), FlowReturn.OK)[1]
        self.pad.event_function = lambda pad, ev: (self.events.append(ev), True)[1]

    def event_types(self):
        return [e.type for e in self.events]


def make_combiner(n_pads, batch_ms, clock=None, link_capture=True):
    comb = element_factory_make("analyticscombiner")
    comb.set_property("batch-duration", batch_ms * MS)
    if clock is not None:
        comb.clock = clock
    cap = Capture()
    if link_capture:
        comb.srcpad.link(cap.pad)
    sinks = [comb.request_sink_pad() for _ in range(n_pads)]
    feeds = []
    for i, s in enumerate(sinks):
        feed = Pad(f"feed{i}", PadDirection.SRC)
        feed.link(s)
        feeds.append(feed)
    return comb, sinks, feeds, cap


def start_stream(feed, stream_id, caps):
    feed.push_event(Event.new_stream_start(stream_id))
    feed.push_event(Event.new_caps(caps))
    feed.push_event(Event.new_segment(Segment()))


def push(feed, pts_ms, dur=DUR_33):
    assert feed.push(Buffer(None, pts=pts_ms * MS, duration=dur)) == FlowReturn.OK


def batch_of(buf):
    meta = buf.get_meta(BatchMeta)
    assert meta is not None
    return meta.streams


def assert_stream(stream, index, stream_id, caps, ptss, dur=DUR_33):
    """Per-stream batch-entry assertions as the reference makes them."""
    assert stream.index == index
    assert stream.stream_id == stream_id
    if caps is None:
        assert stream.caps is None
        assert stream.segment is None
    else:
        assert stream.caps == caps
        assert stream.segment is not None
    assert [b.pts for b in stream.buffers] == [p * MS for p in ptss]
    for b in stream.buffers:
        assert b.duration == dur


def caps_event_streams(ev):
    assert ev.type == EventType.CAPS
    caps = ev.get("caps")
    s = caps.structure(0)
    assert s.name == "multistream/x-analytics-batch"
    return s["streams"]


def test_combine_multi():
    caps0, caps1 = rgb_caps(50), gray_caps(25)
    comb, sinks, (f0, f1), cap = make_combiner(2, 200)
    start_stream(f0, "sid-0", caps0)
    start_stream(f1, "sid-1", caps1)

    # 50 fps on stream 0, 25 fps on stream 1; one extra buffer past the
    # 200 ms boundary completes the first batch
    for i in range(12):
        push(f0, i * 20, dur=20 * MS)
        if i % 2 == 0:
            push(f1, (i // 2) * 40, dur=40 * MS)

    assert len(cap.buffers) == 1
    buf = cap.buffers[0]
    assert buf.pts == 0 and buf.duration == 200 * MS
    streams = batch_of(buf)
    assert len(streams) == 2
    assert_stream(streams[0], 0, "sid-0", caps0, [i * 20 for i in range(10)], dur=20 * MS)
    assert_stream(streams[1], 1, "sid-1", caps1, [i * 40 for i in range(5)], dur=40 * MS)

    f0.push_event(Event.new_eos())
    f1.push_event(Event.new_eos())

    assert len(cap.buffers) == 2
    buf = cap.buffers[1]
    assert buf.pts == 200 * MS and buf.duration == 200 * MS
    streams = batch_of(buf)
    assert_stream(streams[0], 0, "sid-0", caps0, [200, 220], dur=20 * MS)
    assert_stream(streams[1], 1, "sid-1", caps1, [200], dur=40 * MS)

    # event sequence on the src pad: stream-start, caps, segment, eos
    assert cap.event_types() == [
        EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.EOS,
    ]
    streams_field = caps_event_streams(cap.events[1])
    assert streams_field == [caps0, caps1]


def _single_pad(strategy, batch_ms=100):
    comb, sinks, (feed,), cap = make_combiner(1, batch_ms)
    sinks[0].set_property("batch-strategy", strategy)
    caps = rgb_caps(30)
    start_stream(feed, "sid-0", caps)
    return comb, feed, cap, caps


def _assert_single(buf, batch_pts_ms, caps, ptss):
    assert buf.pts == batch_pts_ms * MS and buf.duration == 100 * MS
    streams = batch_of(buf)
    assert len(streams) == 1
    assert_stream(streams[0], 0, "sid-0", caps, ptss)


def _assert_final_events(cap, caps_list):
    assert cap.event_types() == [
        EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.EOS,
    ]
    assert caps_event_streams(cap.events[1]) == caps_list


def test_strategy_all():
    comb, feed, cap, caps = _single_pad("all")
    for pts in [0, 33, 66, 100]:
        push(feed, pts)
    _assert_single(cap.buffers[0], 0, caps, [0, 33, 66])

    for pts in [133, 200]:
        push(feed, pts)
    _assert_single(cap.buffers[1], 100, caps, [100, 133])

    for pts in [233, 233, 266, 300]:
        push(feed, pts)
    _assert_single(cap.buffers[2], 200, caps, [200, 233, 233, 266])

    feed.push_event(Event.new_eos())
    _assert_single(cap.buffers[3], 300, caps, [300])
    assert len(cap.buffers) == 4
    _assert_final_events(cap, [caps])


def test_strategy_first():
    comb, feed, cap, caps = _single_pad("first-in-batch")
    for pts in [0, 33, 66, 100]:
        push(feed, pts)
    _assert_single(cap.buffers[0], 0, caps, [0])

    for pts in [133, 200]:
        push(feed, pts)
    _assert_single(cap.buffers[1], 100, caps, [100])

    for pts in [233, 233, 266, 300]:
        push(feed, pts)
    _assert_single(cap.buffers[2], 200, caps, [200])

    feed.push_event(Event.new_eos())
    _assert_single(cap.buffers[3], 300, caps, [300])
    assert len(cap.buffers) == 4
    _assert_final_events(cap, [caps])


def test_strategy_first_with_overlap():
    comb, feed, cap, caps = _single_pad("first-in-batch-with-overlap")
    for pts in [0, 33, 66, 100]:
        push(feed, pts)
    _assert_single(cap.buffers[0], 0, caps, [0])

    # 199 is within the 100-200 window but CLOSEST to the 200 boundary: the
    # overlap strategy assigns it to the NEXT batch (reference asserts 100
    # then 199)
    for pts in [133, 199, 233]:
        push(feed, pts)
    _assert_single(cap.buffers[1], 100, caps, [100])

    for pts in [233, 266, 301, 333]:
        push(feed, pts)
    _assert_single(cap.buffers[2], 200, caps, [199])

    feed.push_event(Event.new_eos())
    _assert_single(cap.buffers[3], 300, caps, [301])
    # the EOS drain flushes the remaining 333 as a window-400 batch (the
    # reference's harness never pulls past the 300 batch; the aggregate loop
    # behavior is the same)
    _assert_single(cap.buffers[4], 400, caps, [333])
    assert len(cap.buffers) == 5
    _assert_final_events(cap, [caps])


def test_strategy_last():
    comb, feed, cap, caps = _single_pad("last-in-batch")
    for pts in [0, 33, 66, 100]:
        push(feed, pts)
    _assert_single(cap.buffers[0], 0, caps, [66])

    for pts in [133, 200]:
        push(feed, pts)
    _assert_single(cap.buffers[1], 100, caps, [133])

    for pts in [233, 233, 266, 300]:
        push(feed, pts)
    _assert_single(cap.buffers[2], 200, caps, [266])

    feed.push_event(Event.new_eos())
    _assert_single(cap.buffers[3], 300, caps, [300])
    assert len(cap.buffers) == 4
    _assert_final_events(cap, [caps])


def test_combine_multi_initial_gap():
    caps0, caps1 = rgb_caps(50), gray_caps(25)
    clk = TestClock()
    comb, sinks, (f0, f1), cap = make_combiner(2, 200, clock=clk)

    # only the first stream starts; push its whole first window + one more
    start_stream(f0, "sid-0", caps0)
    for i in range(11):
        push(f0, i * 20, dur=20 * MS)

    # second stream never produced anything: the batch comes out on the
    # aggregator timeout (crank the test clock like the reference harness)
    assert not cap.buffers
    assert clk.crank()

    assert len(cap.buffers) == 1
    buf = cap.buffers[0]
    assert buf.pts == 0 and buf.duration == 200 * MS
    streams = batch_of(buf)
    assert len(streams) == 2
    assert_stream(streams[0], 0, "sid-0", caps0, [i * 20 for i in range(10)], dur=20 * MS)
    # only an empty entry with no events or anything for the second stream
    assert_stream(streams[1], 1, None, None, [])

    # now start the second stream and push the second window on both
    start_stream(f1, "sid-1", caps1)
    for i in range(11):
        if i > 0:
            push(f0, 200 + i * 20, dur=20 * MS)
        if i % 2 == 0:
            push(f1, 200 + (i // 2) * 40, dur=40 * MS)

    assert len(cap.buffers) == 2
    buf = cap.buffers[1]
    assert buf.pts == 200 * MS and buf.duration == 200 * MS
    streams = batch_of(buf)
    assert_stream(streams[0], 0, "sid-0", caps0, [200 + i * 20 for i in range(10)], dur=20 * MS)
    assert_stream(streams[1], 1, "sid-1", caps1, [200 + i * 40 for i in range(5)], dur=40 * MS)

    f0.push_event(Event.new_eos())
    f1.push_event(Event.new_eos())

    assert len(cap.buffers) == 3
    buf = cap.buffers[2]
    assert buf.pts == 400 * MS and buf.duration == 200 * MS
    streams = batch_of(buf)
    assert_stream(streams[0], 0, "sid-0", caps0, [400], dur=20 * MS)
    assert_stream(streams[1], 1, "sid-1", caps1, [400], dur=40 * MS)

    # events: the caps are re-pushed once the late stream's caps are known
    assert cap.event_types() == [
        EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT,
        EventType.CAPS, EventType.EOS,
    ]
    assert caps_event_streams(cap.events[1]) == [caps0, UNKNOWN]
    assert caps_event_streams(cap.events[3]) == [caps0, caps1]


# ---------------------------------------------------------------------------
# analyticssplitter.rs


def make_split_chain(n_pads, batch_ms, clock=None):
    """combiner ! splitter with captures auto-linked via pad-added."""
    comb, sinks, feeds, _ = make_combiner(n_pads, batch_ms, clock=clock, link_capture=False)
    split = element_factory_make("analyticssplitter")
    comb.srcpad.link(split.sinkpad)
    captures = {}

    def on_pad_added(element, pad):
        capt = Capture(f"capture-{pad.name}")
        pad.link(capt.pad)
        captures[pad.name] = capt

    split.connect("pad-added", on_pad_added)
    return comb, split, feeds, captures


def test_combine_split_single():
    caps = rgb_caps(25)
    comb, split, (feed,), captures = make_split_chain(1, 100)
    start_stream(feed, "sid-0", caps)
    for i in range(10):
        push(feed, i * 40, dur=40 * MS)
    feed.push_event(Event.new_eos())

    assert list(captures) == ["src_0_0"]
    cap = captures["src_0_0"]
    assert [b.pts for b in cap.buffers] == [i * 40 * MS for i in range(10)]
    assert all(b.duration == 40 * MS for b in cap.buffers)

    # the splitter re-emits the ORIGINAL stream id and caps
    assert cap.event_types() == [
        EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.EOS,
    ]
    assert cap.events[0].get("stream_id") == "sid-0"
    assert cap.events[1].get("caps") == caps


def test_combine_split_multi():
    caps0, caps1 = rgb_caps(25), rgb_caps(50)
    comb, split, (f0, f1), captures = make_split_chain(2, 100)
    start_stream(f0, "sid-0", caps0)
    start_stream(f1, "sid-1", caps1)
    for i in range(20):
        if i % 2 == 0:
            push(f0, i * 20, dur=40 * MS)
        push(f1, i * 20, dur=20 * MS)
    f0.push_event(Event.new_eos())
    f1.push_event(Event.new_eos())

    assert sorted(captures) == ["src_0_0", "src_0_1"]
    cap0, cap1 = captures["src_0_0"], captures["src_0_1"]
    assert [b.pts for b in cap0.buffers] == [i * 40 * MS for i in range(10)]
    assert all(b.duration == 40 * MS for b in cap0.buffers)
    assert [b.pts for b in cap1.buffers] == [i * 20 * MS for i in range(20)]
    assert all(b.duration == 20 * MS for b in cap1.buffers)

    for cap, sid, caps in [(cap0, "sid-0", caps0), (cap1, "sid-1", caps1)]:
        assert cap.event_types() == [
            EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.EOS,
        ]
        assert cap.events[0].get("stream_id") == sid
        assert cap.events[1].get("caps") == caps


def test_combine_split_multi_with_initial_gap():
    caps0, caps1 = rgb_caps(25), gray_caps(50)
    clk = TestClock()
    comb, split, (f0, f1), captures = make_split_chain(2, 200, clock=clk)

    # first 6 buffers on the first stream only, then time out the batch
    start_stream(f0, "sid-0", caps0)
    for i in range(6):
        push(f0, i * 40, dur=40 * MS)
    assert clk.crank()

    # only the first stream's pad exists and carries the first window
    assert list(captures) == ["src_0_0"]
    cap0 = captures["src_0_0"]
    assert [b.pts for b in cap0.buffers] == [i * 40 * MS for i in range(5)]

    # start the second stream; push a batch on both (stream 0 already
    # pushed its first buffer of this window above)
    start_stream(f1, "sid-1", caps1)
    for i in range(10):
        if i > 0 and i % 2 == 0:
            push(f0, 200 + (i // 2) * 40, dur=40 * MS)
        push(f1, 200 + i * 20, dur=20 * MS)
    f0.push_event(Event.new_eos())
    f1.push_event(Event.new_eos())

    assert sorted(captures) == ["src_0_0", "src_0_1"]
    cap1 = captures["src_0_1"]
    assert [b.pts for b in cap0.buffers] == [i * 40 * MS for i in range(10)]
    assert all(b.duration == 40 * MS for b in cap0.buffers)
    assert [b.pts for b in cap1.buffers] == [(200 + i * 20) * MS for i in range(10)]
    assert all(b.duration == 20 * MS for b in cap1.buffers)

    for cap, sid, caps in [(cap0, "sid-0", caps0), (cap1, "sid-1", caps1)]:
        assert cap.event_types() == [
            EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.EOS,
        ]
        assert cap.events[0].get("stream_id") == sid
        assert cap.events[1].get("caps") == caps


# ---------------------------------------------------------------------------
# the timeout on the clock's thread, under streaming threads

THREAD_BUFFERS = 300
THREAD_WINDOW_MS = 1
RUN_TIMEOUT_S = 60.0


class _ClockErrors(logging.Handler):
    """Collects what the clock's thread logs when a callback raises."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _threaded_run():
    """Stream 0 pushes THREAD_BUFFERS 1 ms buffers from its own thread;
    stream 1 starts, pushes one buffer and stalls, so the windows after the
    first come out on the clock's timeout.  Returns (captured batches, the
    lock ownership of every timeout aggregate, errors)."""
    caps0, caps1 = rgb_caps(1000), gray_caps(1000)
    comb, sinks, (f0, f1), cap = make_combiner(2, THREAD_WINDOW_MS)
    comb.set_property("force-live", True)
    comb.clock = SystemClock.obtain()
    timeouts = []
    aggregate = comb.aggregate

    def recording_aggregate(timeout):
        if timeout:
            # RLock._is_owned: does the calling thread hold the lock
            timeouts.append(comb._agg_lock._is_owned())
        return aggregate(timeout)

    comb.aggregate = recording_aggregate
    start_stream(f0, "sid-0", caps0)
    start_stream(f1, "sid-1", caps1)
    push(f1, 0, dur=MS)
    errors = []

    def feed():
        try:
            for i in range(THREAD_BUFFERS):
                push(f0, i * THREAD_WINDOW_MS, dur=MS)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    t.join(RUN_TIMEOUT_S)
    assert not t.is_alive(), "the feeding thread did not finish"
    # let the clock drain a few windows on its own, then end both streams
    done = threading.Event()

    def finish():
        try:
            f0.push_event(Event.new_eos())
            f1.push_event(Event.new_eos())
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        done.set()

    threading.Timer(0.05, finish).start()
    assert done.wait(RUN_TIMEOUT_S), "EOS did not get through"
    return cap, timeouts, errors


def _check_threaded(cap, timeouts, errors, clock_errors):
    assert not errors, errors
    assert not clock_errors, [r.getMessage() for r in clock_errors]
    assert cap.event_types()[-1] == EventType.EOS
    pts0 = [b.pts for buf in cap.buffers for b in batch_of(buf)[0].buffers]
    assert pts0 == [i * THREAD_WINDOW_MS * MS for i in range(THREAD_BUFFERS)]
    windows = [buf.pts for buf in cap.buffers]
    assert windows == sorted(set(windows))
    assert all(timeouts), "a timeout aggregated without the aggregator lock"
    return len(timeouts)


def test_timeout_on_the_clock_thread_holds_the_aggregator_lock():
    handler = _ClockErrors()
    log = logging.getLogger("gstpu.clock")
    log.addHandler(handler)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n_timeouts = 0
        for _ in range(3):
            n_timeouts += _check_threaded(*_threaded_run(), handler.records)
    finally:
        sys.setswitchinterval(interval)
        log.removeHandler(handler)
    assert n_timeouts > 0, "no window came out on the clock's timeout"


def test_timeout_takes_the_locks_in_the_streaming_order():
    """The clock's callback takes the aggregator lock, then the combiner's:
    while a streaming thread holds the aggregator lock, a timeout waits for
    it instead of reading the pad queues."""
    clk = TestClock()
    comb, sinks, (f0, f1), cap = make_combiner(2, 200, clock=clk)
    start_stream(f0, "sid-0", rgb_caps(50))
    for i in range(11):
        push(f0, i * 20, dur=20 * MS)
    assert not cap.buffers
    fired = threading.Event()

    def crank():
        clk.crank()
        fired.set()

    with comb._agg_lock:  # what a streaming thread holds while it appends
        t = threading.Thread(target=crank, daemon=True)
        t.start()
        assert not fired.wait(0.2), "the timeout ran while the aggregator lock was held"
        assert not cap.buffers
    t.join(RUN_TIMEOUT_S)
    assert fired.is_set() and len(cap.buffers) == 1
    assert [b.pts for b in batch_of(cap.buffers[0])[0].buffers] == [i * 20 * MS
                                                                   for i in range(10)]
