"""A reader of the JAX package's checkpoints: flax `serialization.to_bytes`
output (gaddpg_tpu/train/checkpoints.py writes `agent_{surfix}.msgpack`)
decoded by hand into nested dicts of numpy arrays, without the msgpack
or flax packages.

The subset flax writes (https://github.com/msgpack/msgpack/blob/master/spec.md):
nil, booleans, integers, floats, strings, binary, arrays, maps, and two
extension types:

- 1, an ndarray: a nested msgpack array (shape, dtype name, C-order
  bytes); `bfloat16` (by name) is widened to float32, which is exact;
- 3, a numpy scalar, packed as a 0-d ndarray and returned as a 0-d array.

Maps come back as dicts and arrays as lists. Flax writes tuples as maps
keyed "0", "1", ... and named tuples (optax's states) as maps keyed by
field, and they stay so. A leaf over 2^30 bytes arrives as flax's
chunked-array map ({"__msgpack_chunked_array__": True, "shape", "chunks"})
and is joined back into one array. A truncated input, trailing bytes,
an unknown type byte or extension, or a malformed array raises
ValueError.
"""

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width items: type byte -> struct format (big-endian)
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# variable-length items: type byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_EXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16, 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos} of "
                             f"{len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.string(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.string(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        if b in _EXT:
            size = _EXT[b]
            n = size if isinstance(size, int) else self.unpack(size)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def string(self, n: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack string is not utf-8: {e}") from None

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, (dict, list)):
                raise ValueError(f"msgpack map key of type {type(key).__name__}")
            out[key] = self.value()
        return out


def _dtype(name: str):
    if name == "bfloat16":
        return None
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown ndarray dtype {name!r}") from None
    if dt.hasobject or dt.fields:
        raise ValueError(f"ndarray dtype {name!r} is not a plain number type")
    return dt


def _ext(code: int, payload: bytes):
    """An extension value: flax's ndarray (1) or numpy scalar (3)."""
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unknown msgpack extension type {code}")
    inner = _Reader(payload)
    item = inner.value()
    if inner.pos != len(payload) or not (isinstance(item, list) and len(item) == 3):
        raise ValueError("malformed ndarray extension: not (shape, dtype, bytes)")
    shape, name, buf = item
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)
            and isinstance(name, str) and isinstance(buf, bytes)):
        raise ValueError("malformed ndarray extension: not (shape, dtype, bytes)")
    count = int(np.prod(shape, dtype=np.int64))
    dt = _dtype(name)
    if dt is None:  # bfloat16: the high half of a float32, widened exactly
        if len(buf) != 2 * count:
            raise ValueError(f"ndarray of {shape} bfloat16 holds {len(buf)} bytes")
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        if len(buf) != dt.itemsize * count:
            raise ValueError(f"ndarray of {shape} {name} holds {len(buf)} bytes")
        arr = np.frombuffer(buf, dtype=dt).copy()
    return arr.reshape(shape)


def _unchunk(tree):
    """Flax's chunked-array maps joined back into arrays, everywhere in
    `tree`."""
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            try:
                shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
                chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
                return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"malformed chunked array: {e}") from None
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def loads(data: bytes):
    """The tree that flax's `msgpack_restore` gives for `data`: dicts,
    lists, Python scalars and numpy arrays. Raises ValueError on a
    truncated or malformed input."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load(path: str):
    """`loads` of the file at `path`."""
    with open(path, "rb") as f:
        return loads(f.read())
