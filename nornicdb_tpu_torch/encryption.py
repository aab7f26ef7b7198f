"""At-rest encryption helpers: AES-256-GCM with PBKDF2 key derivation.

Counterpart of ``nornicdb_tpu/encryption.py`` (the port keeps its own copy
and imports nothing of the JAX package). ``cryptography`` is imported when
an ``Encryptor`` is made, not when this module is: without the package a
passphrase raises ``NornicError``, and unencrypted storage never needs it.

Behavioral reference: the upstream NornicDB pkg/encryption/encryption.go
(DeriveKey et al.); PBKDF2 with 600k iterations matching
pkg/nornicdb/db.go:805; at-rest encryption applied to WAL payloads and
snapshots (the reference delegates to BadgerDB's built-in encryption with
the derived key, db.go:781-809 — here the WAL layer is the storage of
record so it encrypts its own records).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from nornicdb_tpu_torch.errors import NornicError

PBKDF2_ITERATIONS = 600_000  # (ref: db.go:805)
KEY_BYTES = 32  # AES-256
NONCE_BYTES = 12


def derive_key(passphrase: str, salt: bytes, iterations: int = PBKDF2_ITERATIONS) -> bytes:
    """(ref: encryption.DeriveKey)"""
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt, iterations,
                               dklen=KEY_BYTES)


def new_salt() -> bytes:
    return os.urandom(16)


class Encryptor:
    """AES-256-GCM payload encryption."""

    def __init__(self, key: bytes):
        if len(key) != KEY_BYTES:
            raise ValueError(f"key must be {KEY_BYTES} bytes")
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError as e:
            raise NornicError(
                "at-rest encryption needs the 'cryptography' package, which "
                "is not installed; open the storage without a passphrase or "
                "install it") from e
        self._aead = AESGCM(key)

    @classmethod
    def from_passphrase(cls, passphrase: str, salt: bytes,
                        iterations: int = PBKDF2_ITERATIONS) -> "Encryptor":
        return cls(derive_key(passphrase, salt, iterations))

    def encrypt(self, plaintext: bytes, aad: Optional[bytes] = None) -> bytes:
        nonce = os.urandom(NONCE_BYTES)
        return nonce + self._aead.encrypt(nonce, plaintext, aad)

    def decrypt(self, blob: bytes, aad: Optional[bytes] = None) -> bytes:
        nonce, ct = blob[:NONCE_BYTES], blob[NONCE_BYTES:]
        return self._aead.decrypt(nonce, ct, aad)


def load_or_create_salt(path: str) -> bytes:
    """Persist-or-load a PBKDF2 salt file, shared by every at-rest layer
    (WAL, segment store) so salt handling can't silently diverge. An empty
    or short file (crash mid-write) is treated as absent and regenerated —
    safe because a salt only matters once records encrypted under it exist,
    and those are written strictly after the salt file."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            salt = f.read()
        if len(salt) >= 16:
            return salt
    salt = new_salt()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(salt)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return salt
