"""BIT (bitstring) value helpers.

TPU-native design: BIT columns are dictionary-encoded like VARCHAR — the
canonical '0'/'1' text lives in the column dictionary, rows carry int32
codes, and every bit function/operator becomes a bind-time per-code table
(one device gather).  The reference packs bits into a padded blob
(src/include/duckdb/common/types/bit.hpp, common/types/bit.cpp); here the
canonical text IS the storage form — device work stays pure int32 and the
hot path never sees variable-length payloads.
"""

from __future__ import annotations


class BitError(ValueError):
    """Invalid bitstring input (maps to ConversionError /
    InvalidInputError / Out-of-Range at the binder seam)."""


def validate(text: str) -> str:
    """Canonicalize a bitstring literal; raises BitError on bad input
    (reference: Bit::TryGetBitStringSize error messages)."""
    s = str(text)
    if s == "":
        raise BitError("Cannot cast empty string to BIT")
    for ch in s:
        if ch not in "01":
            raise BitError(
                "Invalid character encountered in string -> bit "
                f"conversion: '{ch}'")
    return s


def from_blob(data: bytes) -> str:
    """BLOB -> BIT: each byte contributes 8 bits (reference:
    CastFromBlobToBit keeps the byte payload)."""
    if len(data) == 0:
        raise BitError("Cannot cast empty blob to BIT")
    return "".join(f"{b:08b}" for b in data)

def to_blob(bits: str) -> bytes:
    """BIT -> BLOB: requires a whole number of bytes (reference:
    Bit::BitToBlob errors unless length % 8 == 0)."""
    if len(bits) % 8 != 0:
        raise BitError(
            f"Cannot cast BIT of length {len(bits)} to BLOB: length "
            "must be a multiple of 8")
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def bit_and(a: str, b: str) -> str:
    if len(a) != len(b):
        raise BitError("Cannot AND bit strings of different sizes")
    return "".join("1" if x == "1" and y == "1" else "0"
                   for x, y in zip(a, b))


def bit_or(a: str, b: str) -> str:
    if len(a) != len(b):
        raise BitError("Cannot OR bit strings of different sizes")
    return "".join("1" if x == "1" or y == "1" else "0"
                   for x, y in zip(a, b))


def bit_xor(a: str, b: str) -> str:
    if len(a) != len(b):
        raise BitError("Cannot XOR bit strings of different sizes")
    return "".join("1" if x != y else "0" for x, y in zip(a, b))


def bit_not(a: str) -> str:
    return "".join("0" if x == "1" else "1" for x in a)


def shift_left(a: str, n: int) -> str:
    """Logical shift within the fixed width (reference: Bit::LeftShift
    fills with zeros, width preserved; negative amounts error)."""
    n = int(n)
    if n < 0:
        raise BitError(f"Cannot left-shift by negative number {n}")
    if n >= len(a):
        return "0" * len(a)
    return a[n:] + "0" * n


def shift_right(a: str, n: int) -> str:
    n = int(n)
    if n < 0:
        raise BitError(f"Cannot right-shift by negative number {n}")
    if n >= len(a):
        return "0" * len(a)
    return "0" * n + a[: len(a) - n]


def get_bit(a: str, i: int) -> int:
    i = int(i)
    if i < 0 or i >= len(a):
        raise BitError(
            f"bit index {i} out of valid range (0..{len(a) - 1})")
    return 1 if a[i] == "1" else 0


def set_bit(a: str, i: int, v: int) -> str:
    v = int(v)
    if v not in (0, 1):
        raise BitError("The new bit must be 1 or 0")
    i = int(i)
    if i < 0 or i >= len(a):
        raise BitError(
            f"bit index {i} out of valid range (0..{len(a) - 1})")
    return a[:i] + ("1" if v else "0") + a[i + 1:]


def bit_count(a: str) -> int:
    return a.count("1")


def bit_position(needle: str, hay: str) -> int:
    """1-based position of the first substring match; 0 if absent
    (reference: Bit::BitPosition)."""
    p = hay.find(needle)
    return p + 1


def bitstring(a: str, length: int) -> str:
    """Zero-pad a to exactly `length` bits (reference: BitStringFunction —
    errors if length < len(a))."""
    length = int(length)
    if length < len(a):
        raise BitError(
            "Length must be equal or larger than input string")
    return "0" * (length - len(a)) + a
