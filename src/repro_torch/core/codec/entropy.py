"""Entropy-coded wire accounting: the ``EntropyCode`` stage (role ``"code"``);
port of repro/core/codec/entropy.py, host numpy, streams byte for byte the
JAX package's.

The byte ledger has always been exact for the RAW wire format
(``payload.meta.declared_nbytes == payload.nbytes``). This stage extends the
same honesty contract to the entropy-coded format: ``coded_nbytes`` is the
EXACT length of the byte stream a wire encoder would emit — verified by
actually emitting it (``encode_stream``) and round-tripping it back
(``decode_stream``) in the property suite, per sparsifier x quantizer.

The stage is accounting-layer only: payload tensors stay raw on the device
(the decode math is unchanged and bit-identical with or without the stage);
what changes is what the ledger CHARGES. It reads tensors through
``.cpu().numpy()``. numpy has no bfloat16, so a bfloat16 tensor travels as
its 2-byte patterns (a raw ``V2`` view of its int16 bits), and
``decode_stream`` returns CPU torch tensors, bfloat16 ones included.

Wire format (schema-driven, deterministic):

* arrays are coded in sorted-name order (the payload pytree order);
* float arrays pass through raw, no header (the schema already pins shape
  and dtype, so nothing needs to be self-delimiting);
* int32 (index) arrays get a 1-byte header — the Rice-Golomb parameter
  ``r``, or the ``_STORE`` escape — followed by the Rice stream over
  zigzag-mapped symbols: indices live in [0, d), far below the 32-bit
  range, so Rice wins by ~2-3x;
* int8 (quantized value) arrays get a 1-byte header — a discrete-Gaussian
  scale index, or ``_STORE`` — followed by a static-model arithmetic-coded
  stream. Quantized values fill the int8 range by construction (the scale
  normalises the chunk max to ~127), so no prefix code can beat 8
  bits/symbol; a static Gaussian frequency table (rebuilt deterministically
  from the 1-byte scale index) codes at the distribution's ~7.5-bit
  entropy instead. A parameter-free adaptive model would pay more in
  learning redundancy than the ~0.5 bit/symbol it could win at these array
  sizes, which is why the model is parametric + static.

Whatever the path, the escape bounds a coded integer array at raw size + 1
header byte, and in the quantized/indexed regimes the coded size is
strictly smaller.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import numpy as np
import torch

from .payload import arrays_of, meta_of

_STORE = 255          # header escape: raw little-endian pass-through
_MAX_RICE_R = 40      # zigzag(int32) fits in 33 bits; scan a little past
_MAX_SIGMA = 254      # discrete-Gaussian scale indices 1.._MAX_SIGMA
_FREQ_SCALE = 1 << 14  # static-model frequency precision (total < 2^23)


_BF16_RAW = np.dtype("V2")  # a bfloat16 element as raw bytes: not an integer


def _host(t) -> np.ndarray:
    """A tensor (or array) as a host numpy array; bfloat16 as raw 2-byte
    elements, which ``_encode_array`` passes through like any float."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RAW)
        return t.numpy()
    return np.asarray(t)


def _tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A decoded array as a CPU tensor of the schema's dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np_dtype(dtype_name: str) -> np.dtype:
    return _BF16_RAW if dtype_name == "bfloat16" else np.dtype(dtype_name)


def _is_integer(arr) -> bool:
    return np.issubdtype(np.asarray(arr).dtype, np.integer)


def _zigzag(arr) -> np.ndarray:
    """Signed -> unsigned, small magnitudes -> small symbols."""
    a = np.asarray(arr, np.int64).ravel()
    return ((a << 1) ^ (a >> 63)).astype(np.uint64)


def _rice_nbits(sym: np.ndarray, r: int) -> int:
    """Exact Rice stream length in bits: unary quotient (q ones + stop 0)
    plus ``r`` remainder bits per symbol."""
    return int(np.sum(sym >> np.uint64(r))) + sym.size * (1 + r)


def _best_rice(sym: np.ndarray) -> tuple[int, int]:
    """(r, nbits) minimising the exact coded length over r in [0, 40]."""
    best_r, best_bits = 0, _rice_nbits(sym, 0)
    for r in range(1, _MAX_RICE_R + 1):
        bits = _rice_nbits(sym, r)
        if bits < best_bits:
            best_r, best_bits = r, bits
    return best_r, best_bits


@functools.lru_cache(maxsize=None)
def _gauss_freqs(sigma_idx: int) -> tuple:
    """Deterministic integer frequency table for int8 symbols -128..127 under
    a discrete Gaussian of scale ``sigma_idx`` (Laplace-floored at 1 so every
    symbol stays codable). Returns (freqs int64[256], cumfreqs int64[257])."""
    s = np.arange(-128, 128, dtype=np.float64)
    p = np.exp(-0.5 * (s / float(sigma_idx)) ** 2)
    freqs = np.maximum(1, np.round(_FREQ_SCALE * p / p.sum())).astype(np.int64)
    cum = np.zeros(257, np.int64)
    np.cumsum(freqs, out=cum[1:])
    return freqs, cum


def _sigma_index(a: np.ndarray) -> int:
    """1-byte model parameter: the values' std, clipped onto the grid."""
    sd = float(np.std(np.asarray(a, np.float64)))
    return int(np.clip(round(sd), 1, _MAX_SIGMA))


def _array_coded_nbytes(arr) -> int:
    """Exact coded size of ONE array (== len(_encode_array(arr)))."""
    return len(_encode_array(arr))


class _BitWriter:
    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):  # MSB first
            self._acc = (self._acc << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._out.append(self._acc)
                self._acc = self._nbits = 0

    def write_unary(self, q: int) -> None:
        while q >= 8:  # bulk 0xFF runs keep large quotients cheap enough
            self.write(0xFF, 8)
            q -= 8
        self.write((1 << (q + 1)) - 2, q + 1)  # q ones then the stop 0

    def getvalue(self) -> bytes:
        out = bytes(self._out)
        if self._nbits:
            out += bytes([self._acc << (8 - self._nbits)])
        return out


class _BitReader:
    def __init__(self, data: bytes, offset: int):
        self._data = data
        self._byte = offset
        self._bit = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            bit = (self._data[self._byte] >> (7 - self._bit)) & 1
            v = (v << 1) | bit
            self._bit += 1
            if self._bit == 8:
                self._bit = 0
                self._byte += 1
        return v

    def read_unary(self) -> int:
        q = 0
        while self.read(1):
            q += 1
        return q

    def byte_end(self) -> int:
        return self._byte + (1 if self._bit else 0)


# ---------------------------------------------------------------- arithmetic
# Witten-Neal-Cleary integer arithmetic coding, 32-bit registers, static
# frequency model. Exactly invertible; the coded length IS the size claim.

_AC_BITS = 32
_AC_FULL = (1 << _AC_BITS) - 1
_AC_HALF = 1 << (_AC_BITS - 1)
_AC_QTR = 1 << (_AC_BITS - 2)


def _arith_encode_u8(sym: np.ndarray, cum: np.ndarray) -> bytes:
    total = int(cum[-1])
    w = _BitWriter()
    low, high, pending = 0, _AC_FULL, 0

    def emit(bit):
        nonlocal pending
        w.write(bit, 1)
        if pending:
            w.write((0 if bit else (1 << pending) - 1), pending)
            pending = 0

    for s in sym.tolist():
        span = high - low + 1
        high = low + span * int(cum[s + 1]) // total - 1
        low = low + span * int(cum[s]) // total
        while True:
            if high < _AC_HALF:
                emit(0)
            elif low >= _AC_HALF:
                emit(1)
                low -= _AC_HALF
                high -= _AC_HALF
            elif low >= _AC_QTR and high < 3 * _AC_QTR:
                pending += 1
                low -= _AC_QTR
                high -= _AC_QTR
            else:
                break
            low <<= 1
            high = (high << 1) | 1
    pending += 1
    emit(0 if low < _AC_QTR else 1)
    return w.getvalue()


def _arith_decode_u8(data: bytes, offset: int, count: int,
                     freqs: np.ndarray, cum: np.ndarray) -> np.ndarray:
    total = int(cum[-1])
    br = _BitReader(data, offset)
    end = len(data)

    def read_bit():
        if br._byte >= end:
            return 0  # the encoder's implicit trailing zeros
        return br.read(1)

    value = 0
    for _ in range(_AC_BITS):
        value = (value << 1) | read_bit()
    low, high = 0, _AC_FULL
    out = np.empty(count, np.int64)
    cum_list = cum.tolist()
    for i in range(count):
        span = high - low + 1
        target = ((value - low + 1) * total - 1) // span
        # binary search the symbol whose [cum[s], cum[s+1]) holds target
        lo_s, hi_s = 0, 256
        while hi_s - lo_s > 1:
            mid = (lo_s + hi_s) // 2
            if cum_list[mid] <= target:
                lo_s = mid
            else:
                hi_s = mid
        s = lo_s
        out[i] = s
        high = low + span * cum_list[s + 1] // total - 1
        low = low + span * cum_list[s] // total
        while True:
            if high < _AC_HALF:
                pass
            elif low >= _AC_HALF:
                low -= _AC_HALF
                high -= _AC_HALF
                value -= _AC_HALF
            elif low >= _AC_QTR and high < 3 * _AC_QTR:
                low -= _AC_QTR
                high -= _AC_QTR
                value -= _AC_QTR
            else:
                break
            low <<= 1
            high = (high << 1) | 1
            value = (value << 1) | read_bit()
    return out


def _encode_array(arr) -> bytes:
    a = np.asarray(arr)
    if not _is_integer(a):
        return a.tobytes()
    raw = a.tobytes()
    if a.dtype.itemsize == 1:  # int8 values: static-Gaussian arithmetic
        sigma = _sigma_index(a)
        _, cum = _gauss_freqs(sigma)
        sym = (np.asarray(a, np.int64).ravel() + 128)
        stream = _arith_encode_u8(sym, cum)
        if len(stream) >= len(raw):
            return bytes([_STORE]) + raw
        return bytes([sigma]) + stream
    sym = _zigzag(a)  # wider ints (indices): Rice over zigzag
    r, bits = _best_rice(sym)
    if (bits + 7) // 8 >= len(raw):
        return bytes([_STORE]) + raw
    w = _BitWriter()
    for s in sym.tolist():
        w.write_unary(s >> r)
        if r:
            w.write(s & ((1 << r) - 1), r)
    return bytes([r]) + w.getvalue()


def _decode_array(data: bytes, offset: int, shape, dtype):
    dt = np.dtype(dtype)
    count = int(np.prod(shape, dtype=np.int64))
    if not np.issubdtype(dt, np.integer):
        n = count * dt.itemsize
        a = np.frombuffer(data[offset:offset + n], dtype=dt).reshape(shape)
        return a, offset + n
    header = data[offset]
    offset += 1
    if header == _STORE:
        n = count * dt.itemsize
        a = np.frombuffer(data[offset:offset + n], dtype=dt).reshape(shape)
        return a, offset + n
    if dt.itemsize == 1:
        freqs, cum = _gauss_freqs(header)
        # the coded segment's length is not stored: re-derive it by
        # re-encoding the decoded symbols (static model — deterministic)
        sym = _arith_decode_u8(data, offset, count, freqs, cum)
        nbytes = len(_arith_encode_u8(sym, cum))
        a = (sym - 128).astype(dt).reshape(shape)
        return a, offset + nbytes
    r = header
    br = _BitReader(data, offset)
    sym = np.empty(count, np.int64)
    for i in range(count):
        q = br.read_unary()
        rem = br.read(r) if r else 0
        sym[i] = (q << r) | rem
    signed = (sym >> 1) ^ -(sym & 1)  # un-zigzag
    return signed.astype(dt).reshape(shape), br.byte_end()


def _sorted_items(payload):
    arrays = arrays_of(payload)
    return [(n, _host(arrays[n])) for n in sorted(arrays)]


@dataclasses.dataclass(frozen=True)
class EntropyCode:
    """Exact entropy-coded payload-size accounting (see module docstring)."""

    role: ClassVar[str] = "code"
    name: ClassVar[str] = "entropy"

    def coded_nbytes(self, payload) -> int:
        """Exact coded wire bytes of ONE client's payload (closed form;
        equals ``len(self.encode_stream(payload))`` — property-tested)."""
        return sum(_array_coded_nbytes(a) for _, a in _sorted_items(payload))

    def coded_nbytes_stacked(self, payload) -> int:
        """Summed coded bytes of a stacked payload (leading client axis):
        each client's stream is coded independently, exactly as the wire
        would carry it."""
        items = _sorted_items(payload)
        if not items:
            return 0
        n_clients = items[0][1].shape[0]
        return sum(
            _array_coded_nbytes(a[i]) for i in range(n_clients)
            for _, a in items
        )

    def encode_stream(self, payload) -> bytes:
        """ONE client's payload -> the actual coded byte stream."""
        return b"".join(_encode_array(a) for _, a in _sorted_items(payload))

    def decode_stream(self, data: bytes, schema) -> dict:
        """Invert ``encode_stream`` given the declared schema (the meta's
        ``ArraySpec`` tuple); returns CPU tensors, bit-exact for integer
        arrays and byte-exact for raw float arrays."""
        specs = {s.name: s for s in schema}
        out, offset = {}, 0
        for name in sorted(specs):
            s = specs[name]
            a, offset = _decode_array(data, offset, tuple(s.shape), _np_dtype(s.dtype))
            out[name] = _tensor(a, s.dtype)
        if offset != len(data):
            raise ValueError(
                f"coded stream has {len(data) - offset} trailing bytes the "
                "schema does not account for"
            )
        return out


def coded_payload_nbytes(pipe, payload) -> int:
    """Coded wire bytes of a stacked payload under ``pipe``'s code stage —
    the raw actual bytes when the pipeline carries no code stage (so callers
    can ledger one 'coded' column unconditionally)."""
    code = getattr(pipe, "code_stage", None)
    if code is None:
        return payload.nbytes if meta_of(payload) is not None else sum(
            a.numel() * a.element_size() for a in arrays_of(payload).values()
        )
    return code.coded_nbytes_stacked(payload)
