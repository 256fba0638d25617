"""The port's WebRTC protocol stack (net/stun.py, ice.py, dtls.py, srtp.py,
sctp.py, sigv4.py, webrtc_peer.py) against the JAX package's.

tests/test_webrtc_stack.py runs on the port with the same inputs and
assertions (RFC 5769, RFC 3711 B.3 and the PRF vector, handshakes in
memory and over loopback, the replay and spoofing guards).  Then the same
seeded inputs go through both packages and the bytes must be equal: STUN
messages with integrity and fingerprint, the DTLS PRF, key block, SRTP
exporter, records and ClientHello, SRTP and SRTCP protect and unprotect
across a rollover, SCTP associations with their chunks and CRC32c, SigV4
keys, requests, headers and presigned URLs; and the offer and answer SDP
of a PeerConnection, equal apart from their random fields."""
import datetime
import os
import re
import struct

import numpy as np
import pytest

import gst_plugins_rs_tpu.net.dtls as jdtls
import gst_plugins_rs_tpu.net.ice as jice
import gst_plugins_rs_tpu.net.sctp as jsctp
import gst_plugins_rs_tpu.net.sigv4 as jsigv4
import gst_plugins_rs_tpu.net.srtp as jsrtp
import gst_plugins_rs_tpu.net.stun as jstun
import gst_plugins_rs_tpu.net.webrtc_peer as jpeer
import gst_plugins_rs_tpu_torch.net.dtls as tdtls
import gst_plugins_rs_tpu_torch.net.ice as tice
import gst_plugins_rs_tpu_torch.net.sctp as tsctp
import gst_plugins_rs_tpu_torch.net.sigv4 as tsigv4
import gst_plugins_rs_tpu_torch.net.srtp as tsrtp
import gst_plugins_rs_tpu_torch.net.stun as tstun
import gst_plugins_rs_tpu_torch.net.webrtc_peer as tpeer
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_webrtc_stack.py", globals())


def seeded_urandom(monkeypatch, seed):
    """os.urandom drawn from a seeded generator (both packages call it
    through the os module)."""
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(os, "urandom", lambda n: rng.bytes(n))


def _rtp(seq, ssrc=0x1234ABCD, ts=0, payload=b""):
    return struct.pack("!BBHII", 0x80, 96, seq & 0xFFFF, ts, ssrc) + payload


# ---------------------------------------------------------------------------
# STUN and ICE


def _stun_messages(stun, rng):
    out = []
    for i in range(6):
        msg = stun.StunMessage(stun.BINDING_REQUEST if i % 2 == 0 else stun.BINDING_SUCCESS,
                               transaction_id=rng.bytes(12))
        msg.add_username(f"u{i}:peer{i}").add_priority(int(rng.integers(1, 2**31)))
        msg.add_xor_mapped_address(f"10.0.{i}.{i + 1}", int(rng.integers(1024, 65535)))
        if i == 4:
            msg.add_error(487, "Role Conflict")
        out.append(msg.encode(integrity_key=rng.bytes(16), fingerprint=i != 3))
    return out


def test_stun_messages_equal_the_jax_packages():
    got = _stun_messages(tstun, np.random.default_rng(7))
    ref = _stun_messages(jstun, np.random.default_rng(7))
    assert got == ref
    for wire in got:
        d, j = tstun.StunMessage.decode(wire), jstun.StunMessage.decode(wire)
        assert (d.msg_type, d.transaction_id, d.attrs, d.username, d.priority,
                d.xor_mapped_address, d.error_code) == \
            (j.msg_type, j.transaction_id, j.attrs, j.username, j.priority,
             j.xor_mapped_address, j.error_code)


@pytest.mark.parametrize("data", [b"\x00\x01\x00\x00" + b"\x21\x12\xa4\x42" + bytes(12),
                                  b"\x16\xfe\xfd" + bytes(10), b"\x80\x60" + bytes(10),
                                  b"\x80\xc8" + bytes(10), b"\x40" + bytes(3), b""])
def test_demux_and_candidates_equal_the_jax_packages(data):
    assert tice.demux_packet(data) == jice.demux_packet(data)
    assert tstun.is_stun(data) == jstun.is_stun(data)
    line = "candidate:1 1 udp 2130706431 127.0.0.1 40404 typ host"
    assert tice.Candidate.from_sdp(line).to_sdp() == jice.Candidate.from_sdp(line).to_sdp() == line
    assert tice.candidate_priority(126, 65535, 1) == jice.candidate_priority(126, 65535, 1)


# ---------------------------------------------------------------------------
# DTLS


@pytest.mark.parametrize("n", [12, 48, 60, 100])
def test_dtls_prf_equals_the_jax_packages(n):
    rng = np.random.default_rng(n)
    secret, seed = rng.bytes(48), rng.bytes(64)
    for label in (b"master secret", b"key expansion", b"EXTRACTOR-dtls_srtp",
                  b"client finished"):
        assert tdtls.prf(secret, label, seed, n) == jdtls.prf(secret, label, seed, n)


def _dtls_keys(dtls, cert, rng, is_client):
    sent = []
    conn = dtls.DtlsConnection(is_client, sent.append, certificate=cert)
    conn.master_secret = rng.bytes(48)
    conn.client_random, conn.server_random = rng.bytes(32), rng.bytes(32)
    conn._derive_keys()
    srtp = conn.export_srtp_keys()
    conn._transcript += rng.bytes(300)
    fin = conn._finished_body(b"client finished")
    for i in range(3):
        conn._send_record(dtls.CT_APPLICATION_DATA, rng.bytes(40 + 100 * i), epoch=1)
    return conn._keys, srtp, fin, sent


@pytest.mark.parametrize("is_client", [True, False])
def test_dtls_key_block_exporter_and_records_equal_the_jax_packages(is_client):
    cert = jdtls.generate_certificate()
    got = _dtls_keys(tdtls, cert, np.random.default_rng(3), is_client)
    ref = _dtls_keys(jdtls, cert, np.random.default_rng(3), is_client)
    assert got == ref
    assert tdtls.certificate_fingerprint(cert[0]) == jdtls.certificate_fingerprint(cert[0])


def test_dtls_client_hello_equals_the_jax_packages(monkeypatch):
    cert = jdtls.generate_certificate()

    def hello(dtls):
        seeded_urandom(monkeypatch, 11)
        sent = []
        dtls.DtlsConnection(True, sent.append, certificate=cert).start_handshake()
        return sent

    got, ref = hello(tdtls), hello(jdtls)
    assert got == ref and len(got) == 1 and got[0][0] == 22  # one handshake record


def test_application_data_is_delivered_outside_the_dtls_lock():
    """While the receive loop delivers a record, another thread sends on the
    same connection, as an SCTP association does: it holds its own lock
    around DtlsConnection.send and takes it again for what on_data hands it.
    The JAX package delivers under the connection's lock, so there the
    sender waits for the delivery and the delivery for the sender's lock
    (tests/test_webrtc.py's data-channel round trip hung so under load)."""
    import threading

    client, server, pump = _memory_pair()  # noqa: F821  (mirrored helper)
    client.start_handshake()
    pump()
    sent = []

    def on_data(data):
        t = threading.Thread(target=lambda: server.send(b"reply to " + data), daemon=True)
        t.start()
        t.join(5.0)
        sent.append(not t.is_alive())

    got = []
    server.on_data, client.on_data = on_data, got.append
    client.send(b"hello")
    pump()
    assert sent == [True] and got == [b"reply to hello"]


# ---------------------------------------------------------------------------
# SRTP


def _srtp_run(srtp, rng):
    key, salt = rng.bytes(16), rng.bytes(14)
    tx, rx = srtp.SrtpSession(key, salt), srtp.SrtpSession(key, salt)
    keys = srtp.derive_session_keys(key, salt)
    wire, back = [], []
    # across a sequence-number rollover: the ROC goes to 1
    for i, seq in enumerate(list(range(65530, 65536)) + list(range(0, 6))):
        pkt = _rtp(seq, ts=i * 960, payload=rng.bytes(int(rng.integers(1, 1200))))
        w = tx.protect(pkt)
        wire.append(w)
        back.append(rx.unprotect(w))
    for i in range(4):
        rtcp = struct.pack("!BBHI", 0x80, 201, 1, 0x1234ABCD) + rng.bytes(24)
        w = tx.protect_rtcp(rtcp)
        wire.append(w)
        back.append(rx.unprotect_rtcp(w))
    with pytest.raises(srtp.SrtpError):
        rx.unprotect(wire[3])  # replayed
    return keys, wire, back


def test_srtp_and_srtcp_equal_the_jax_packages():
    got = _srtp_run(tsrtp, np.random.default_rng(5))
    ref = _srtp_run(jsrtp, np.random.default_rng(5))
    assert got == ref


# ---------------------------------------------------------------------------
# SCTP


def _sctp_run(sctp, monkeypatch):
    """A client and a server association joined in memory (each datagram
    fed at once): the handshake, a channel from each side, messages of
    0, 1, 1,200 and 70,000 bytes (fragmented), text and binary.  Returns
    every datagram in the order sent and what each side received."""
    seeded_urandom(monkeypatch, 13)
    wire, got = [], []
    peers = {}

    def send(side):
        def cb(pkt):
            wire.append((side, pkt))
            peers["s" if side == "c" else "c"].feed(pkt)
        return cb

    c = sctp.SctpAssociation(send("c"), client=True)
    s = sctp.SctpAssociation(send("s"), client=False)
    peers.update(c=c, s=s)
    for side, assoc in (("c", c), ("s", s)):
        assoc.on_channel = lambda ch, side=side: setattr(
            ch, "on_message", lambda data, binary, side=side, ch=ch: got.append(
                (side, ch.label, bytes(data) if binary else data, binary)))
    c.connect()
    assert c.established.is_set() and s.established.is_set()
    ca, sa = c.open_channel("input"), s.open_channel("control", "json")
    rng = np.random.default_rng(17)
    for n in (0, 1, 1200, 70000):
        ca.send(rng.bytes(n), binary=True)
        sa.send("x" * n if n < 2000 else "é" * n)
    return [(side, bytes(p)) for side, p in wire], got, [sctp.crc32c(p) for _, p in wire]


def test_sctp_chunks_and_crc32c_equal_the_jax_packages(monkeypatch):
    got, ref = _sctp_run(tsctp, monkeypatch), _sctp_run(jsctp, monkeypatch)
    assert got == ref
    assert len(got[1]) == 8
    for data in (b"", b"123456789", bytes(range(256)) * 7):
        assert tsctp.crc32c(data) == jsctp.crc32c(data)


# ---------------------------------------------------------------------------
# SigV4


def _sigv4_run(sigv4):
    now = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)
    out = [sigv4.signing_key("wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "20150830",
                             "us-east-1", "iam").hex()]
    out.append(sigv4.canonical_query({"b": "2 3", "a": "x/y", "X-Amz-Date": "20260304T050607Z"}))
    out.append(sigv4.sign_headers("POST", "https://kinesisvideo.eu-west-1.amazonaws.com/"
                                  "describeSignalingChannel?x=1", "eu-west-1", "kinesisvideo",
                                  "AKIDEXAMPLE", "secret", now=now))
    url = sigv4.presign_url("GET", "wss://v-1.kinesisvideo.us-west-2.amazonaws.com/",
                            "us-west-2", "kinesisvideo", "AKIDEXAMPLE", "secret",
                            extra_params={"X-Amz-ChannelARN":
                                          "arn:aws:kinesisvideo:us-west-2:1:channel/x/2",
                                          "X-Amz-ClientId": "viewer 1"}, now=now)
    out += [url, sigv4.verify_presigned(url, "secret")]
    return out


def test_sigv4_equals_the_jax_packages():
    assert _sigv4_run(tsigv4) == _sigv4_run(jsigv4)


# ---------------------------------------------------------------------------
# SDP offer and answer


RANDOM_SDP = [
    (re.compile(r"^o=- \d+ "), "o=- <session> "),
    (re.compile(r"^a=ice-ufrag:.*$"), "a=ice-ufrag:<ufrag>"),
    (re.compile(r"^a=ice-pwd:.*$"), "a=ice-pwd:<pwd>"),
    (re.compile(r"^a=fingerprint:sha-256 [0-9A-F:]+$"), "a=fingerprint:sha-256 <fp>"),
    (re.compile(r"(^a=candidate:.* 127\.0\.0\.1 )\d+ "), r"\1<port> "),
]


def _fixed(sdp):
    lines = []
    for line in sdp.split("\r\n"):
        for pat, rep in RANDOM_SDP:
            line = pat.sub(rep, line)
        lines.append(line)
    return lines


def _exchange(peer, data_channel):
    offerer, answerer = peer.PeerConnection(offerer=True), peer.PeerConnection(offerer=False)
    try:
        offerer.set_media("video", 96, "JPEG", 90000, ["a=msid:cam video0"])
        offerer.add_media("audio", 97, "L16", 48000)
        offerer.enable_data_channel = data_channel
        offer = offerer.create_offer("sendonly")
        answer = answerer.handle_offer(offer, "recvonly")
        offerer.handle_answer(answer)
        return (offer, answer, answerer.medias, offerer.remote_fingerprint ==
                answerer.fingerprint, answerer.remote_fingerprint == offerer.fingerprint,
                peer.parse_sdp_medias(offer))
    finally:
        offerer.close()
        answerer.close()


@pytest.mark.parametrize("data_channel", [False, True])
def test_offer_and_answer_equal_the_jax_packages_apart_from_random_fields(data_channel):
    got, ref = _exchange(tpeer, data_channel), _exchange(jpeer, data_channel)
    assert _fixed(got[0]) == _fixed(ref[0]) and _fixed(got[1]) == _fixed(ref[1])
    assert got[2:] == ref[2:] and got[3] and got[4]
    assert ("webrtc-datachannel" in got[0]) == data_channel
