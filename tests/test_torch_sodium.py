"""The port's NaCl crypto_box (net/nacl.py) and sodium elements against the
JAX package's.

Both packages take X25519 and Poly1305 from `cryptography` and compute
XSalsa20 themselves.  On seeded keys, nonces and messages the two must
agree byte for byte: public keys, shared box keys, boxes, opened boxes,
and the refusal of tampered boxes.  NaCl's and RFC 7748's published
vectors pin the port's own XSalsa20 and the layout of its boxes.  The
elements must give the JAX elements' stream, bytes equal, from numpy and
from tensor payloads.
"""
import ast
import pathlib
import random

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.net import nacl as jnacl
from gst_plugins_rs_tpu_torch.elements.generic.sodium import generate_keypair
from gst_plugins_rs_tpu_torch.net import nacl as tnacl
from torch_parity_helpers import port_on_cpu, run_launch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEEDS = range(6)


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


def _cryptography_public(private32):
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

    return X25519PrivateKey.from_private_bytes(private32).public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)


@pytest.mark.parametrize("seed", SEEDS)
def test_x25519_matches_cryptography(seed):
    rng = random.Random(seed)
    a, b = rng.randbytes(32), rng.randbytes(32)
    pa, pb = tnacl.x25519_public_key(a), tnacl.x25519_public_key(b)
    assert pa == _cryptography_public(a) and pb == _cryptography_public(b)
    assert tnacl.crypto_box_beforenm(a, pb) == tnacl.crypto_box_beforenm(b, pa)
    assert tnacl.crypto_box_beforenm(a, pb) == jnacl.crypto_box_beforenm(a, pb)


def test_x25519_rfc7748_vectors():
    """RFC 7748 section 5.2's two single-step vectors, through the box key:
    HSalsa20 of the published shared secret."""
    for k, u, shared in (
            ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
             "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
             "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
            ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
             "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
             "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957")):
        assert tnacl.crypto_box_beforenm(bytes.fromhex(k), bytes.fromhex(u)) == \
            tnacl.hsalsa20(bytes.fromhex(shared), bytes(16))


def test_x25519_refuses_low_order_point():
    with pytest.raises(ValueError):
        tnacl.crypto_box_beforenm(bytes(range(32)), bytes(32))


def test_crypto_box_nacl_vector():
    """NaCl's tests/box.c: Alice's secret and Bob's public key (RFC 7748
    section 6.1's pair), their box key `firstkey`, and the box of the
    131-byte message, 16-byte Poly1305 tag first."""
    alice = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    bob = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    assert tnacl.x25519_public_key(alice).hex() == \
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    bob_pub = tnacl.x25519_public_key(bob)
    assert bob_pub.hex() == "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    key = tnacl.crypto_box_beforenm(alice, bob_pub)
    assert key.hex() == "1b27556473e985d462cd51197a9a46c76009549eac6474f206c4ee0844f68389"
    nonce = bytes.fromhex("69696ee955b62b73cd62bda875fc73d68219e0036b7a0b37")
    msg = bytes.fromhex(
        "be075fc53c81f2d5cf141316ebeb0c7b5228c52a4c62cbd44b66849b64244ffc"
        "e5ecbaaf33bd751a1ac728d45e6c61296cdc3c01233561f41db66cce314adb31"
        "0e3be8250c46f06dceea3a7fa1348057e2f6556ad6b1318a024a838f21af1fde"
        "048977eb48f59ffd4924ca1c60902e52f0a089bc76897040e082f93776384864"
        "5e0705")
    box = bytes.fromhex(
        "f3ffc7703f9400e52a7dfb4b3d3305d98e993b9f48681273c29650ba32fc76ce"
        "48332ea7164d96a4476fb8c531a1186ac0dfc17c98dce87b4da7f011ec48c972"
        "71d2c20f9b928fe2270d6fb863d51738b48eeee314a7cc8ab932164548e526ae"
        "90224368517acfeabd6bb3732bc0e9da99832b61ca01b6de56244a9e88d5f9b3"
        "7973f622a43d14a6599b1f654cb45a74e355a5")
    assert tnacl.secretbox_easy(msg, nonce, key) == box
    assert tnacl.secretbox_open_easy(box, nonce, key) == msg


@pytest.mark.parametrize("seed", SEEDS)
def test_secretbox_matches_jax(seed):
    rng = random.Random(100 + seed)
    key = tnacl.crypto_box_beforenm(rng.randbytes(32), tnacl.x25519_public_key(rng.randbytes(32)))
    for size in (0, 1, 15, 16, 17, 63, 64, 65, rng.randrange(100, 40_000)):
        nonce, msg = rng.randbytes(24), rng.randbytes(size)
        box = tnacl.secretbox_easy(msg, nonce, key)
        assert box == jnacl.secretbox_easy(msg, nonce, key)
        assert tnacl.secretbox_open_easy(box, nonce, key) == msg
        assert tnacl.increment_le(nonce) == jnacl.increment_le(nonce)


@pytest.mark.parametrize("seed", SEEDS)
def test_tampered_box_refused_by_both(seed):
    rng = random.Random(200 + seed)
    key, nonce = rng.randbytes(32), rng.randbytes(24)
    box = bytearray(tnacl.secretbox_easy(rng.randbytes(500), nonce, key))
    box[rng.randrange(len(box))] ^= 1 << rng.randrange(8)
    for mod in (tnacl, jnacl):
        with pytest.raises(ValueError, match="MAC verification failed"):
            mod.secretbox_open_easy(bytes(box), nonce, key)
        with pytest.raises(ValueError, match="too short"):
            mod.secretbox_open_easy(bytes(box[:10]), nonce, key)


def test_port_nacl_imports_only_cryptography():
    """The port's X25519 and Poly1305 come from `cryptography`, as the JAX
    package's do, and nothing binds libsodium."""
    for rel in ("gst_plugins_rs_tpu_torch/net/nacl.py",
                "gst_plugins_rs_tpu_torch/elements/generic/sodium.py"):
        tree = ast.parse((ROOT / rel).read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
        assert not any(n.split(".")[0] in ("nacl", "sodium") for n in names), rel
        if rel.endswith("nacl.py"):
            assert {"cryptography.hazmat.primitives.poly1305",
                    "cryptography.hazmat.primitives.asymmetric.x25519"} <= names


def test_generate_keypair_pairs():
    priv, pub = generate_keypair()
    assert tnacl.x25519_public_key(bytes.fromhex(priv)).hex() == pub
    assert _cryptography_public(bytes.fromhex(priv)).hex() == pub


KEYS = {}


def _keys():
    if not KEYS:
        rng = random.Random(7)
        s, r = rng.randbytes(32), rng.randbytes(32)
        KEYS.update(s_priv=s.hex(), s_pub=tnacl.x25519_public_key(s).hex(),
                    r_priv=r.hex(), r_pub=tnacl.x25519_public_key(r).hex())
    return KEYS


def _sodium_buffers(seed, sizes):
    rng = np.random.default_rng(seed)
    return [dict(data=rng.integers(0, 256, n, dtype=np.uint8), pts=i * 1_000_000)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("block_size,sizes", [(1024, [5000, 3000, 100]), (4096, [9000]),
                                              (32768, [70_000, 12])])
def test_sodium_elements_match_jax(block_size, sizes, payload):
    k = _keys()
    nonce = random.Random(block_size).randbytes(24).hex()
    enc = (f"sodiumencrypter sender-key={k['s_priv']} receiver-key={k['r_pub']} "
           f"block-size={block_size} nonce={nonce}")
    dec = f"sodiumdecrypter sender-key={k['s_pub']} receiver-key={k['r_priv']}"
    caps = "application/octet-stream"
    bufs = _sodium_buffers(block_size, sizes)
    port_in = bufs if payload == "numpy" else [
        dict(b, data=torch.from_numpy(b["data"].copy())) for b in bufs]
    sealed = run_launch(fx, f"appsrc name=src ! {enc} ! appsink name=sink", bufs, caps=caps)
    assert run_launch(tfx, f"appsrc name=src ! {enc} ! appsink name=sink", port_in,
                      caps=caps) == sealed
    opened = run_launch(tfx, f"appsrc name=src ! {enc} ! {dec} ! appsink name=sink", port_in,
                        caps=caps)
    assert b"".join(s[0][2] for s in opened[0]) == b"".join(b["data"].tobytes() for b in bufs)
    assert opened == run_launch(fx, f"appsrc name=src ! {enc} ! {dec} ! appsink name=sink", bufs,
                                caps=caps)
