"""Payload encryption and compression, with an AES-256 of its own.

Port of ``ria_tpu/protocol/crypto.py``.  Wire contracts from the reference
(src/crypto/aes256.{hpp,cpp}, src/protocol/compression.{hpp,cpp}):

- AES-256-CBC with PKCS7 padding, output = IV || ciphertext, payload-only
  (control frames stay clear);
- deflate (zlib) level 6, only applied when the payload is >= 32 bytes and
  the compressed form is smaller.

The reference package takes its cipher from the ``cryptography`` package;
this one implements FIPS-197 itself (key expansion, the rounds and the
equivalent inverse cipher over 32-bit T-tables), in plain Python, as the
reference modem does in C++.  It is host code on either side: a message
is a few kilobytes.  The IV comes from ``os.urandom`` where the reference
draws it, so a caller can hand both packages the same bytes.
"""

from __future__ import annotations

import hashlib
import os
import struct
import zlib

AES_BLOCK = 16
MIN_COMPRESS_SIZE = 32
COMPRESS_LEVEL = 6
_ROUNDS = 14  # AES-256: Nk = 8 key words, Nr = 14


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _gmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a, b = _xtime(a), b >> 1
    return out


def _tables():
    """The S-box (multiplicative inverse in GF(2^8), then the affine map,
    FIPS-197 5.1.1), its inverse, and the four encryption and decryption
    T-tables: MixColumns (InvMixColumns) of one S-box (inverse S-box) output
    in each row position."""
    exp, log = [0] * 255, [0] * 256  # powers of the generator 3
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x ^= _xtime(x)
    inv = [0] + [exp[(255 - log[a]) % 255] for a in range(1, 256)]
    sbox = []
    for x in inv:
        s = x
        for shift in range(1, 5):
            s ^= ((x << shift) | (x >> (8 - shift))) & 0xFF
        sbox.append(s ^ 0x63)
    inv_sbox = [0] * 256
    for i, s in enumerate(sbox):
        inv_sbox[s] = i

    def rotations(word):
        return [[((w >> (8 * r)) | (w << (32 - 8 * r))) & 0xFFFFFFFF for w in word]
                for r in range(4)]

    te = rotations([(_gmul(s, 2) << 24) | (s << 16) | (s << 8) | _gmul(s, 3) for s in sbox])
    td = rotations([(_gmul(s, 14) << 24) | (_gmul(s, 9) << 16) | (_gmul(s, 13) << 8)
                    | _gmul(s, 11) for s in inv_sbox])
    return sbox, inv_sbox, te, td


_SBOX, _INV_SBOX, _TE, _TD = _tables()


def _expand_key(key: bytes) -> tuple[list[int], list[int]]:
    """The 60 round-key words of AES-256 (FIPS-197 5.2) and those of the
    equivalent inverse cipher (5.3.5: reversed, InvMixColumns applied to the
    words of rounds 1 to Nr - 1)."""
    w = list(struct.unpack(">8I", key))
    rcon = 1
    for i in range(8, 4 * (_ROUNDS + 1)):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = _sub_word(t) ^ (rcon << 24)
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = _sub_word(t)
        w.append(w[i - 8] ^ t)
    td = _TD
    dw = []
    for r in range(_ROUNDS, -1, -1):
        for word in w[4 * r: 4 * r + 4]:
            if 0 < r < _ROUNDS:  # InvMixColumns(word) = Td(S(word)) row by row
                word = (td[0][_SBOX[word >> 24]] ^ td[1][_SBOX[(word >> 16) & 255]]
                        ^ td[2][_SBOX[(word >> 8) & 255]] ^ td[3][_SBOX[word & 255]])
            dw.append(word)
    return w, dw


def _sub_word(t: int) -> int:
    return ((_SBOX[t >> 24] << 24) | (_SBOX[(t >> 16) & 255] << 16)
            | (_SBOX[(t >> 8) & 255] << 8) | _SBOX[t & 255])


def _encrypt_block(w: list[int], s: tuple[int, int, int, int]) -> tuple[int, ...]:
    t0, t1, t2, t3 = _TE
    s0, s1, s2, s3 = s[0] ^ w[0], s[1] ^ w[1], s[2] ^ w[2], s[3] ^ w[3]
    for r in range(1, _ROUNDS):
        k = 4 * r
        s0, s1, s2, s3 = (
            t0[s0 >> 24] ^ t1[(s1 >> 16) & 255] ^ t2[(s2 >> 8) & 255] ^ t3[s3 & 255] ^ w[k],
            t0[s1 >> 24] ^ t1[(s2 >> 16) & 255] ^ t2[(s3 >> 8) & 255] ^ t3[s0 & 255] ^ w[k + 1],
            t0[s2 >> 24] ^ t1[(s3 >> 16) & 255] ^ t2[(s0 >> 8) & 255] ^ t3[s1 & 255] ^ w[k + 2],
            t0[s3 >> 24] ^ t1[(s0 >> 16) & 255] ^ t2[(s1 >> 8) & 255] ^ t3[s2 & 255] ^ w[k + 3])
    return _last_round(_SBOX, w[4 * _ROUNDS: 4 * _ROUNDS + 4], (s0, s1, s2, s3), (1, 2, 3))


def _decrypt_block(dw: list[int], s: tuple[int, int, int, int]) -> tuple[int, ...]:
    t0, t1, t2, t3 = _TD
    s0, s1, s2, s3 = s[0] ^ dw[0], s[1] ^ dw[1], s[2] ^ dw[2], s[3] ^ dw[3]
    for r in range(1, _ROUNDS):
        k = 4 * r
        s0, s1, s2, s3 = (
            t0[s0 >> 24] ^ t1[(s3 >> 16) & 255] ^ t2[(s2 >> 8) & 255] ^ t3[s1 & 255] ^ dw[k],
            t0[s1 >> 24] ^ t1[(s0 >> 16) & 255] ^ t2[(s3 >> 8) & 255] ^ t3[s2 & 255] ^ dw[k + 1],
            t0[s2 >> 24] ^ t1[(s1 >> 16) & 255] ^ t2[(s0 >> 8) & 255] ^ t3[s3 & 255] ^ dw[k + 2],
            t0[s3 >> 24] ^ t1[(s2 >> 16) & 255] ^ t2[(s1 >> 8) & 255] ^ t3[s0 & 255] ^ dw[k + 3])
    return _last_round(_INV_SBOX, dw[4 * _ROUNDS: 4 * _ROUNDS + 4], (s0, s1, s2, s3), (3, 2, 1))


def _last_round(box, k, s, order) -> tuple[int, ...]:
    """SubBytes and ShiftRows (``order`` (1, 2, 3)) or their inverses
    (``(3, 2, 1)``, with the inverse S-box), then the last round key."""
    a, b, c = order
    return tuple(
        ((box[s[i] >> 24] << 24) | (box[(s[(i + a) % 4] >> 16) & 255] << 16)
         | (box[(s[(i + b) % 4] >> 8) & 255] << 8) | box[s[(i + c) % 4] & 255]) ^ k[i]
        for i in range(4))


def _pkcs7_pad(data: bytes) -> bytes:
    pad = AES_BLOCK - (len(data) % AES_BLOCK)
    return data + bytes([pad]) * pad


def _pkcs7_unpad(data: bytes) -> bytes:
    if not data or len(data) % AES_BLOCK:
        raise ValueError("bad padded length")
    pad = data[-1]
    if pad < 1 or pad > AES_BLOCK or data[-pad:] != bytes([pad]) * pad:
        raise ValueError("bad padding")
    return data[:-pad]


class AES256:
    """AES-256-CBC, wire = IV || ciphertext (reference src/crypto/aes256.hpp)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("AES-256 key must be 32 bytes")
        self.key = key
        self._w, self._dw = _expand_key(bytes(key))

    @classmethod
    def from_passphrase(cls, passphrase: str) -> "AES256":
        return cls(hashlib.sha256(passphrase.encode()).digest())

    def encrypt(self, plaintext: bytes, iv: bytes | None = None) -> bytes:
        iv = iv or os.urandom(AES_BLOCK)
        if len(iv) != AES_BLOCK:
            raise ValueError(f"Invalid IV size ({len(iv)}) for CBC.")
        prev = struct.unpack(">4I", iv)
        padded = _pkcs7_pad(plaintext)
        out = bytearray(iv)
        for i in range(0, len(padded), AES_BLOCK):
            p = struct.unpack_from(">4I", padded, i)
            prev = _encrypt_block(self._w, tuple(a ^ b for a, b in zip(p, prev)))
            out += struct.pack(">4I", *prev)
        return bytes(out)

    def decrypt(self, wire: bytes) -> bytes:
        if len(wire) < 2 * AES_BLOCK:
            raise ValueError("ciphertext too short")
        if len(wire) % AES_BLOCK:
            raise ValueError("The length of the provided data is not a multiple of the "
                             "block length.")
        prev = struct.unpack_from(">4I", wire, 0)
        out = bytearray()
        for i in range(AES_BLOCK, len(wire), AES_BLOCK):
            c = struct.unpack_from(">4I", wire, i)
            out += struct.pack(">4I", *(a ^ b for a, b in zip(_decrypt_block(self._dw, c), prev)))
            prev = c
        return _pkcs7_unpad(bytes(out))


def compress(data: bytes) -> tuple[bytes, bool]:
    """Deflate if it helps; returns (payload, was_compressed)."""
    if len(data) < MIN_COMPRESS_SIZE:
        return data, False
    packed = zlib.compress(data, COMPRESS_LEVEL)
    if len(packed) < len(data):
        return packed, True
    return data, False


def decompress(data: bytes) -> bytes:
    return zlib.decompress(data)
