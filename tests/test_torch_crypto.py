"""The port's AES-256-CBC and compression (``ria_tpu_torch.protocol.crypto``)
against the published test vectors and against ``ria_tpu.protocol.crypto``,
whose cipher is the ``cryptography`` package's.  Every comparison is exact:
the wire bytes are equal, not close."""

import hashlib
import zlib

import numpy as np
import pytest
import torch

from ria_tpu.protocol import crypto as R
from ria_tpu_torch.protocol import crypto as T

torch.set_num_threads(1)


def test_fips197_c3_block():
    """FIPS-197 appendix C.3 (AES-256): key 00..1f.  With a zero IV the
    first CBC block is the cipher of the plaintext block itself."""
    aes = T.AES256(bytes(range(32)))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    wire = aes.encrypt(pt, bytes(16))
    assert wire[16:32] == bytes.fromhex("8ea2b7ca516745bfeafc49904b496089")
    assert aes.decrypt(wire) == pt


def test_sp800_38a_f25_cbc_first_block():
    """NIST SP 800-38A F.2.5 (CBC-AES256.Encrypt), first block."""
    key = bytes.fromhex("603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4")
    iv = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")
    wire = T.AES256(key).encrypt(pt, iv)
    assert wire[:16] == iv
    assert wire[16:32] == bytes.fromhex("f58c4c04d6e5f1ba779eabfb5f7bfbd6")


@pytest.mark.parametrize("lengths", [range(0, 51), range(51, 101), [4096]],
                         ids=["0-50", "51-100", "4096"])
def test_wire_equals_reference(lengths):
    """Same key, IV and plaintext: the port's wire is the reference's byte
    for byte, and each package decrypts the other's."""
    rng = np.random.default_rng(len(lengths))
    for n in lengths:
        key, iv = rng.bytes(32), rng.bytes(16)
        data = rng.bytes(n)
        got = T.AES256(key).encrypt(data, iv)
        want = R.AES256(key).encrypt(data, iv)
        assert got == want, n
        assert len(got) == 16 + 16 * (n // 16 + 1)
        assert T.AES256(key).decrypt(want) == data
        assert R.AES256(key).decrypt(got) == data


def test_iv_drawn_from_os_urandom(monkeypatch):
    """With no IV the port draws one from ``os.urandom`` where the reference
    does, so both packages handed the same bytes write the same wire."""
    drawn = []

    def urandom(n):
        drawn.append(n)
        return bytes(range(100, 100 + n))

    monkeypatch.setattr(T.os, "urandom", urandom)  # the same os module as R's
    key = T.AES256.from_passphrase("hunter2")
    a = key.encrypt(b"attack at dawn")
    b = R.AES256.from_passphrase("hunter2").encrypt(b"attack at dawn")
    assert a == b and a[:16] == bytes(range(100, 116)) and drawn == [16, 16]


def test_from_passphrase_and_roundtrip():
    """The key is SHA-256 of the passphrase, as in the reference."""
    key = T.AES256.from_passphrase("secret pass")
    assert key.key == hashlib.sha256(b"secret pass").digest()
    assert key.key == R.AES256.from_passphrase("secret pass").key
    ct = key.encrypt(b"attack at dawn")
    assert ct[16:] != b"attack at dawn"
    assert key.decrypt(ct) == b"attack at dawn"
    assert len(ct) % 16 == 0
    with pytest.raises(ValueError):
        T.AES256(b"short key")
    with pytest.raises(ValueError):
        R.AES256(b"short key")


@pytest.mark.parametrize("case", ["short", "not_a_multiple", "bad_pad_byte", "pad_too_big",
                                  "pad_zero", "wrong_key"])
def test_decrypt_errors_as_the_reference(case):
    """The reference's ValueErrors for a short ciphertext and bad padding:
    both packages refuse the same wires."""
    key = bytes(range(32))
    iv = bytes(16)
    good = R.AES256(key).encrypt(b"0123456789", iv)

    def cbc_one(block: bytes) -> bytes:
        """One block with chosen padding bytes, encrypted without padding."""
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
        return iv + enc.update(block) + enc.finalize()

    wire = {
        "short": good[:31],
        "not_a_multiple": good + b"\x00",
        "bad_pad_byte": cbc_one(b"A" * 13 + b"\x01\x02\x03"),
        "pad_too_big": cbc_one(b"A" * 15 + b"\x11"),
        "pad_zero": cbc_one(b"A" * 15 + b"\x00"),
        "wrong_key": R.AES256(bytes(32)).encrypt(b"0123456789abcdef" * 2, iv),
    }[case]
    outcomes = []
    for pkg in (R, T):
        try:
            outcomes.append(pkg.AES256(key).decrypt(wire))
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]
    if case != "wrong_key":  # a wrong key may end in valid-looking padding
        assert outcomes[1] == "ValueError"


def test_compression_gate():
    """Deflate level 6 behind the 32-byte gate, kept only when smaller:
    the same bytes and flags as the reference."""
    rng = np.random.default_rng(3)
    cases = [b"", b"short", b"x" * 31, b"x" * 32, b"abcd" * 100, rng.bytes(64),
             rng.bytes(5000), b"the quick brown fox " * 103]
    for data in cases:
        got, want = T.compress(data), R.compress(data)
        assert got == want, len(data)
        if got[1]:
            assert got[0] == zlib.compress(data, 6) and len(got[0]) < len(data)
            assert T.decompress(got[0]) == data
        else:
            assert got[0] == data
    small, was = T.compress(b"short")
    assert not was and small == b"short"
