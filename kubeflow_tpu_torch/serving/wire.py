"""Binary tensor wire protocol for the serving data plane.

A copy of `kubeflow_tpu/serving/wire.py` (numpy only). JSON costs every
tensor two text round-trips per hop (``tolist()`` plus ``json.dumps``
on the way out, the mirror image on the way in). The frame skips both:

    KFT1 <u32 header-len> <header ascii> <raw little-endian bytes>

where the header is ``<dtype.str>:<dim0,dim1,...>`` (e.g.
``<f4:32,32,3``), and decoding is ``np.frombuffer`` + ``reshape``.
Negotiation is plain HTTP content negotiation on
``/v1/models/<m>:predict``:

- request: ``Content-Type: application/x-kftpu-tensor`` carries a frame
  instead of ``{"instances": ...}`` JSON;
- response: ``Accept: application/x-kftpu-tensor`` (or, absent any
  Accept, a framed request) gets the predictions back as a frame;
  everyone else gets the JSON envelope.
"""

from __future__ import annotations

import math
import struct

import numpy as np

# The negotiated media type. Content-Type on requests, Accept +
# Content-Type on responses.
TENSOR_CONTENT_TYPE = "application/x-kftpu-tensor"

_MAGIC = b"KFT1"
_LEN = struct.Struct("<I")
# A header is "<dtype.str>:<comma-dims>"; anything bigger than this is
# a corrupt frame, not a real tensor header.
_MAX_HEADER = 4096

# Numeric tensor kinds only: bool, (un)signed int, float, complex.
# Strings ('U'/'S'), void/records ('V'), datetimes ('M'/'m') and object
# arrays never cross this wire — a servable can't batch them, and
# several of them smuggle pickle-adjacent decode paths.
_ALLOWED_KINDS = frozenset("biufc")


class WireFormatError(ValueError):
    """The frame is not a valid tensor (bad magic, truncated payload,
    malformed header). The HTTP boundary maps this to 400."""


def encode_tensor(arr) -> bytes:
    """Frame an array: magic, header length, ``dtype|shape`` header,
    then the raw little-endian bytes. One buffer copy (``tobytes``),
    no per-element work."""
    arr = np.asarray(arr)
    if arr.dtype.hasobject:
        raise WireFormatError("object arrays cannot cross the wire")
    if arr.dtype.kind not in _ALLOWED_KINDS:
        raise WireFormatError(
            f"dtype kind {arr.dtype.kind!r} ({arr.dtype.str}) is not a "
            f"wire tensor type"
        )
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    # Shape BEFORE ascontiguousarray: it promotes 0-d scalars to 1-d.
    shape = arr.shape
    arr = np.ascontiguousarray(arr)
    # ":" separator — "|" appears in single-byte dtype strs ("|i1").
    header = (
        f"{arr.dtype.str}:{','.join(str(d) for d in shape)}"
    ).encode("ascii")
    return b"".join(
        (_MAGIC, _LEN.pack(len(header)), header, arr.tobytes())
    )


def decode_tensor(data: bytes) -> np.ndarray:
    """Decode a frame produced by `encode_tensor` via ``np.frombuffer``
    (the returned array is a read-only view over ``data`` — callers
    that mutate must copy). Raises `WireFormatError` on anything that
    is not an intact frame."""
    if len(data) < len(_MAGIC) + _LEN.size or not data.startswith(_MAGIC):
        raise WireFormatError("not a kftpu tensor frame (bad magic)")
    (header_len,) = _LEN.unpack_from(data, len(_MAGIC))
    if header_len > _MAX_HEADER:
        raise WireFormatError(f"tensor header too large ({header_len})")
    body_off = len(_MAGIC) + _LEN.size + header_len
    if len(data) < body_off:
        raise WireFormatError("truncated tensor header")
    header = data[len(_MAGIC) + _LEN.size:body_off]
    try:
        dtype_str, _, dims = header.decode("ascii").partition(":")
        dtype = np.dtype(dtype_str)
        shape = tuple(int(d) for d in dims.split(",")) if dims else ()
    except (UnicodeDecodeError, TypeError, ValueError) as e:
        raise WireFormatError(f"malformed tensor header: {e}") from e
    # Every malformed header must be a WireFormatError here — a raw
    # ValueError out of reshape would escape the server's 400 mapping
    # and 500 the WSGI handler.
    if dtype.hasobject:
        raise WireFormatError("object dtype refused")
    if dtype.kind not in _ALLOWED_KINDS:
        raise WireFormatError(
            f"dtype kind {dtype.kind!r} ({dtype_str}) is not a wire "
            f"tensor type"
        )
    if any(d < 0 for d in shape):
        # reshape treats -1 as "infer this dim" — from the wire that is
        # attacker-controlled reshaping, not a tensor.
        raise WireFormatError(f"negative dimension in header: {shape}")
    # Arbitrary-precision product: np.prod over int64 silently WRAPS on
    # a crafted huge-dims header, which can collide with the payload
    # length and push a bogus shape into reshape.
    expected = dtype.itemsize * math.prod(shape)
    payload = memoryview(data)[body_off:]
    if len(payload) != expected:
        raise WireFormatError(
            f"tensor payload is {len(payload)} bytes, header claims "
            f"{expected} ({dtype_str}, shape {shape})"
        )
    return np.frombuffer(payload, dtype=dtype).reshape(shape)


def wants_tensor_response(headers: dict) -> bool:
    """Response-side negotiation from (lowercased) request headers: an
    explicit ``Accept: application/x-kftpu-tensor`` wins, an explicit
    JSON Accept loses, and absent any Accept a tensor REQUEST implies a
    tensor response (a binary client that forgot the Accept header must
    not silently pay the JSON decode on the reply leg)."""
    accept = headers.get("accept", "")
    if TENSOR_CONTENT_TYPE in accept:
        return True
    if "application/json" in accept:
        return False
    return is_tensor_request(headers)


def is_tensor_request(headers: dict) -> bool:
    content_type = headers.get("content-type", "")
    return content_type.split(";")[0].strip() == TENSOR_CONTENT_TYPE
