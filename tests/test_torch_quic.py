"""The port's QUIC v1 (net/quic.py), its TLS 1.3 (net/tls13.py) and its
WebTransport session layer (net/webtransport.py) against the JAX package's.

tests/test_quic.py runs on the port with the same inputs and assertions:
RFC 9000/9001 vectors, the handshake, streams, datagrams, loss recovery,
flow control, key update, version negotiation, migration, resumption and
0-RTT, Retry, NewReno and the idle timeout.  Then, on seeded inputs, the
two packages give the same bytes: the Initial secrets and keys of a
connection ID, the packet protection (AEAD seal and open, the header
protection mask), the next generation's keys, the transport parameters,
varints, the TLS key schedule and the HTTP/3 header block WebTransport
sends."""
import numpy as np
import pytest

from gst_plugins_rs_tpu.net import quic as jquic, tls13 as jtls, webtransport as jwt
from gst_plugins_rs_tpu_torch.net import quic, tls13, webtransport
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_quic.py", globals())

SEEDS = range(4)


def _rand(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _keys(k):
    return k.secret, k.key, k.iv, k.hp


@pytest.mark.parametrize("seed", SEEDS)
def test_initial_secrets_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    dcid = _rand(rng, int(rng.integers(8, 21)))
    for got, ref in zip(quic.initial_keys(dcid), jquic.initial_keys(dcid)):
        assert _keys(got) == _keys(ref)
        assert _keys(got.next_generation()) == _keys(ref.next_generation())


@pytest.mark.parametrize("seed", SEEDS)
def test_packet_protection_equals_the_jax_packages(seed):
    """Seal, open and the header-protection mask of one seeded packet."""
    rng = np.random.default_rng(100 + seed)
    secret = _rand(rng, 32)
    got, ref = quic.Keys(secret), jquic.Keys(secret)
    pn = int(rng.integers(0, 1 << 30))
    header, payload = _rand(rng, 22), _rand(rng, int(rng.integers(1, 1400)))
    sealed = got.seal(pn, header, payload)
    assert sealed == ref.seal(pn, header, payload)
    assert ref.open(pn, header, sealed) == payload == got.open(pn, header, sealed)
    sample = sealed[:16]
    assert got.hp_mask(sample) == ref.hp_mask(sample)


@pytest.mark.parametrize("seed", SEEDS)
def test_transport_parameters_and_varints_equal_the_jax_packages(seed):
    rng = np.random.default_rng(200 + seed)
    params = {int(k): int(v) for k, v in zip(rng.integers(0, 64, 8),
                                            rng.integers(0, 1 << 40, 8))}
    blob = quic.encode_transport_params(params)
    assert blob == jquic.encode_transport_params(params)
    assert quic.decode_transport_params(blob) == jquic.decode_transport_params(blob) == params
    for v in [0, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30, (1 << 62) - 1] + \
            [int(x) for x in rng.integers(0, 1 << 62, 8, dtype=np.int64)]:
        enc = quic.encode_varint(v)
        assert enc == jquic.encode_varint(v)
        assert quic.decode_varint(enc, 0) == jquic.decode_varint(enc, 0) == (v, len(enc))


@pytest.mark.parametrize("seed", SEEDS)
def test_tls_key_schedule_equals_the_jax_packages(seed):
    rng = np.random.default_rng(300 + seed)
    salt, ikm, ctx = _rand(rng, 32), _rand(rng, 32), _rand(rng, 32)
    prk = tls13.hkdf_extract(salt, ikm)
    assert prk == jtls.hkdf_extract(salt, ikm)
    for label in ("c hs traffic", "s ap traffic", "quic key"):
        assert tls13.hkdf_expand_label(prk, label, ctx, 32) == \
            jtls.hkdf_expand_label(prk, label, ctx, 32)
        assert tls13.derive_secret(prk, label, ctx) == jtls.derive_secret(prk, label, ctx)


def test_webtransport_headers_equal_the_jax_packages():
    headers = [(":method", "CONNECT"), (":protocol", "webtransport"), (":scheme", "https"),
               (":authority", "127.0.0.1:4445"), (":path", "/stream")]
    blob = webtransport.encode_headers(headers)
    assert blob == jwt.encode_headers(headers)
    assert webtransport.decode_headers(blob) == jwt.decode_headers(blob) == headers
    assert webtransport._settings_payload() == jwt._settings_payload()


def _receiver_space(pkg, pns):
    space = pkg._Space()
    for pn in pns:
        space.recv_pns.add(pn)
        if hasattr(pkg, "_add_to_ranges"):
            pkg._add_to_ranges(space.recv_ranges, pn)
    return space


def _acked(frame):
    """The packet numbers an ACK frame claims (RFC 9000 §19.3)."""
    largest, off = jquic.decode_varint(frame, 1)
    _, off = jquic.decode_varint(frame, off)
    count, off = jquic.decode_varint(frame, off)
    first, off = jquic.decode_varint(frame, off)
    lo = largest - first
    got = set(range(lo, largest + 1))
    for _ in range(count):
        gap, off = jquic.decode_varint(frame, off)
        rng, off = jquic.decode_varint(frame, off)
        hi = lo - gap - 2
        lo = hi - rng
        got |= set(range(lo, hi + 1))
    return got


@pytest.mark.parametrize("seed", SEEDS)
def test_ack_frames_of_one_or_two_ranges_equal_the_jax_packages(seed):
    """The receiver's ACK frame from its ranges: the JAX package's bytes
    where it has one or two ranges (arrival order shuffled)."""
    rng = np.random.default_rng(400 + seed)
    top = int(rng.integers(20, 400))
    pns = list(range(0, top))
    if seed % 2:  # a gap below the top range
        cut = int(rng.integers(2, top - 2))
        pns = [p for p in pns if not cut - 1 <= p <= cut]
    rng.shuffle(pns)
    conn, jconn = quic.QuicConnection(True, lambda d: None), jquic.QuicConnection(
        True, lambda d: None)
    got = conn._ack_frame(_receiver_space(quic, pns))
    assert got == jconn._ack_frame(_receiver_space(jquic, pns))
    assert _acked(got) == set(pns)


def test_ack_frame_claims_only_the_packets_received():
    """Three ranges with a multi-packet one in the middle: the port's frame
    claims exactly the packets received; the JAX package's claims packets
    never received below the middle range (its gap arithmetic), which its
    sender then takes as delivered."""
    pns = list(range(10, 21)) + list(range(50, 61)) + list(range(90, 101))
    conn, jconn = quic.QuicConnection(True, lambda d: None), jquic.QuicConnection(
        True, lambda d: None)
    assert _acked(conn._ack_frame(_receiver_space(quic, pns))) == set(pns)
    assert _acked(jconn._ack_frame(_receiver_space(jquic, pns))) - set(pns)


def test_sender_takes_an_ack_as_the_jax_package_does():
    """A sender with 200 seeded packets in flight handles one ACK frame of
    two ranges (packets 120-125 missing): the same packets leave flight and
    are declared lost and queued again in both packages, with the same
    congestion window and bytes in flight after."""
    sizes = [int(x) for x in np.random.default_rng(500).integers(100, 1200, 200)]
    frame = quic.QuicConnection(True, lambda d: None)._ack_frame(_receiver_space(
        quic, [p for p in range(200) if not 120 <= p <= 125]))
    state = []
    for pkg in (quic, jquic):
        conn = pkg.QuicConnection(True, lambda d: None)
        space = conn.spaces[pkg.LEVEL_APP]
        for pn, size in enumerate(sizes):
            space.unacked[pn] = (bytes([8, pn % 64]), True, 0.0, size)
        conn._in_flight = sum(sizes)
        conn._handle_ack(pkg.LEVEL_APP, frame, 1, False)
        state.append((sorted(space.unacked), conn._cwnd, conn._in_flight,
                      conn.__dict__.get("_queued_frames", {}).get(pkg.LEVEL_APP)))
    assert state[0] == state[1]
    assert state[0][3] == [bytes([8, pn % 64]) for pn in range(120, 126)]
