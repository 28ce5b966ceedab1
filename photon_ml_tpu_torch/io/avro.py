"""Pure-Python Avro binary codec + object container file format (a copy of
``photon_ml_tpu/io/avro.py``; the same records give byte-identical files
in both packages).

The reference's external data contract is Avro-on-HDFS (SURVEY.md §3.4:
``TrainingExampleAvro``, ``BayesianLinearModelAvro``, ...); no Avro library
is available in this image, so this module implements the needed subset of
the Avro 1.x specification from scratch: zig-zag varint primitives, the
binary encoding of records/arrays/maps/unions/enums/fixed, and the object
container format (magic ``Obj\\x01``, metadata map with schema + codec,
sync-marker-delimited blocks, null and deflate codecs).

Supports the complete type surface our schemas use and round-trips files
that standard Avro tooling can read (spec-conformant encoding; deflate is
raw zlib per the spec).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator, List

MAGIC = b"Obj\x01"

PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}


# -- schema ----------------------------------------------------------------
def parse_schema(schema) -> Any:
    """Normalize a schema (JSON string or dict/list) to dict/list/str form,
    resolving named-type references within the document."""
    if isinstance(schema, str) and schema not in PRIMITIVES:
        schema = json.loads(schema)
    named: dict = {}
    return _resolve(schema, named)


def _resolve(schema, named):
    if isinstance(schema, str):
        if schema in PRIMITIVES:
            return schema
        if schema in named:
            return named[schema]
        raise ValueError(f"unknown type reference '{schema}'")
    if isinstance(schema, list):
        return [_resolve(s, named) for s in schema]
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            name = schema.get("name")
            if name:
                named[name] = schema
                ns = schema.get("namespace")
                if ns:
                    named[f"{ns}.{name}"] = schema
        if t == "record":
            for f in schema["fields"]:
                f["type"] = _resolve(f["type"], named)
        elif t in ("array",):
            schema["items"] = _resolve(schema["items"], named)
        elif t in ("map",):
            schema["values"] = _resolve(schema["values"], named)
        elif isinstance(t, (dict, list)):
            schema["type"] = _resolve(t, named)
        return schema
    raise ValueError(f"bad schema: {schema!r}")


def _schema_type(schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def dump_schema(schema) -> str:
    """Serialize a resolved schema to JSON, emitting a *name reference* for
    the second and later occurrences of each named type. ``parse_schema``
    aliases repeated references to one shared dict; naively json.dumps-ing
    that re-defines the named type, which the Avro spec forbids and standard
    tooling rejects ("Can't redefine")."""
    seen: set = set()

    def conv(s):
        if isinstance(s, str):
            return s
        if isinstance(s, list):
            return [conv(b) for b in s]
        t = s.get("type")
        if t in ("record", "enum", "fixed"):
            name = s["name"]
            full = f"{s['namespace']}.{name}" if s.get("namespace") else name
            if full in seen:
                return full
            seen.add(full)
            out = dict(s)
            if t == "record":
                out["fields"] = [dict(f, type=conv(f["type"])) for f in s["fields"]]
            return out
        out = dict(s)
        if t == "array":
            out["items"] = conv(s["items"])
        elif t == "map":
            out["values"] = conv(s["values"])
        elif isinstance(t, (dict, list)):
            out["type"] = conv(t)
        return out

    return json.dumps(conv(schema))


# -- binary primitives -----------------------------------------------------
def _write_long(out: BinaryIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zig-zag
    while (n & ~0x7F) != 0:
        out.write(bytes([(n & 0x7F) | 0x80]))
        n >>= 7
    out.write(bytes([n & 0x7F]))


def _read_long_or_eof(f: BinaryIO):
    """Read a zig-zag varint; None at clean EOF (zero bytes available).
    A partial varint still raises (truncation is corruption, not EOF)."""
    b = f.read(1)
    if not b:
        return None
    shift = 0
    acc = 0
    while True:
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
        b = f.read(1)
        if not b:
            raise EOFError("truncated varint")
    return (acc >> 1) ^ -(acc & 1)  # un-zig-zag


def _read_long(buf: io.BytesIO) -> int:
    v = _read_long_or_eof(buf)
    if v is None:
        raise EOFError("truncated varint")
    return v


# -- datum encode/decode ---------------------------------------------------
def write_datum(out: BinaryIO, datum, schema) -> None:
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if datum else b"\x00")
    elif t in ("int", "long"):
        _write_long(out, int(datum))
    elif t == "float":
        out.write(struct.pack("<f", float(datum)))
    elif t == "double":
        out.write(struct.pack("<d", float(datum)))
    elif t == "bytes":
        raw = bytes(datum)
        _write_long(out, len(raw))
        out.write(raw)
    elif t == "string":
        raw = str(datum).encode("utf-8")
        _write_long(out, len(raw))
        out.write(raw)
    elif t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if isinstance(datum, dict):
                if name in datum:
                    value = datum[name]
                elif "default" in f:
                    value = f["default"]
                else:
                    raise ValueError(f"record field '{name}' missing and no default")
            else:
                value = getattr(datum, name)
            write_datum(out, value, f["type"])
    elif t == "array":
        items = list(datum)
        if items:
            _write_long(out, len(items))
            for item in items:
                write_datum(out, item, schema["items"])
        _write_long(out, 0)
    elif t == "map":
        entries = dict(datum)
        if entries:
            _write_long(out, len(entries))
            for k, v in entries.items():
                write_datum(out, k, "string")
                write_datum(out, v, schema["values"])
        _write_long(out, 0)
    elif t == "union":
        idx = _union_branch(datum, schema)
        _write_long(out, idx)
        write_datum(out, datum, schema[idx])
    elif t == "enum":
        _write_long(out, schema["symbols"].index(datum))
    elif t == "fixed":
        raw = bytes(datum)
        if len(raw) != schema["size"]:
            raise ValueError(f"fixed size mismatch: {len(raw)} != {schema['size']}")
        out.write(raw)
    else:
        raise ValueError(f"unsupported schema type {t!r}")


def _union_branch(datum, union) -> int:
    """Pick the first matching branch (sufficient for our null|X unions)."""
    for i, branch in enumerate(union):
        bt = _schema_type(branch)
        if datum is None and bt == "null":
            return i
        if datum is None:
            continue
        if bt in ("int", "long") and isinstance(datum, int) and not isinstance(datum, bool):
            return i
        if bt in ("float", "double") and isinstance(datum, (int, float)) and not isinstance(datum, bool):
            return i
        if bt == "string" and isinstance(datum, str):
            return i
        if bt == "boolean" and isinstance(datum, bool):
            return i
        if bt == "bytes" and isinstance(datum, (bytes, bytearray)):
            return i
        if bt in ("record", "map") and isinstance(datum, dict):
            return i
        if bt == "array" and isinstance(datum, (list, tuple)):
            return i
        if bt == "enum" and isinstance(datum, str):
            return i
    raise ValueError(f"no union branch for {type(datum)} in {union}")


def read_datum(buf: io.BytesIO, schema):
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return buf.read(_read_long(buf))
    if t == "string":
        return buf.read(_read_long(buf)).decode("utf-8")
    if t == "record":
        return {f["name"]: read_datum(buf, f["type"]) for f in schema["fields"]}
    if t == "array":
        out: List = []
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:  # block with byte-size prefix
                count = -count
                _read_long(buf)
            for _ in range(count):
                out.append(read_datum(buf, schema["items"]))
        return out
    if t == "map":
        entries = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                count = -count
                _read_long(buf)
            for _ in range(count):
                k = read_datum(buf, "string")
                entries[k] = read_datum(buf, schema["values"])
        return entries
    if t == "union":
        return read_datum(buf, schema[_read_long(buf)])
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "fixed":
        return buf.read(schema["size"])
    raise ValueError(f"unsupported schema type {t!r}")


# -- object container files ------------------------------------------------
_META_SCHEMA = parse_schema({"type": "map", "values": "bytes"})


def write_avro_file(
    path: str,
    records: Iterable,
    schema,
    codec: str = "deflate",
    block_size: int = 4096,
) -> None:
    """Write an Avro object container file (records per schema)."""
    schema = parse_schema(schema)
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec '{codec}' (null|deflate)")
    # Deterministic sync marker (schema digest) instead of os.urandom:
    # readers never SCAN for the marker (blocks are length-prefixed; the
    # 16 bytes after each block are compared, not searched), so the only
    # property that matters is stability — and determinism makes two
    # saves of the same model byte-identical, which the registry's
    # per-artifact content fingerprints and delta diffing rely on.
    sync = hashlib.md5(dump_schema(schema).encode()).digest()
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {
            "avro.schema": dump_schema(schema).encode(),
            "avro.codec": codec.encode(),
        }
        write_datum(f, meta, _META_SCHEMA)
        f.write(sync)
        block: List[bytes] = []

        def flush():
            if not block:
                return
            payload = b"".join(block)
            if codec == "deflate":
                comp = zlib.compressobj(9, zlib.DEFLATED, -15)
                payload = comp.compress(payload) + comp.flush()
            _write_long(f, len(block))
            _write_long(f, len(payload))
            f.write(payload)
            f.write(sync)
            block.clear()

        for rec in records:
            buf = io.BytesIO()
            write_datum(buf, rec, schema)
            block.append(buf.getvalue())
            if len(block) >= block_size:
                flush()
        flush()


def _read_header(f: BinaryIO, path: str):
    """Read container-file magic + metadata -> (schema, codec, sync)."""
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta = read_datum(f, _META_SCHEMA)
    schema = parse_schema(json.loads(meta["avro.schema"].decode()))
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"{path}: unsupported codec '{codec}'")
    sync = f.read(16)
    return schema, codec, sync


def _iter_blocks(f: BinaryIO, path: str, schema, codec: str, sync: bytes) -> Iterator:
    """Yield records from a positioned container file, one block at a time."""
    while True:
        count = _read_long_or_eof(f)
        if count is None:
            return
        size = _read_long(f)
        payload = f.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        block = io.BytesIO(payload)
        for _ in range(count):
            yield read_datum(block, schema)
        if f.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")


def stream_avro_file(path: str) -> Iterator:
    """Yield records one sync-delimited block at a time — constant memory in
    the file size (one decompressed block resident at once)."""
    with open(path, "rb") as f:
        schema, codec, sync = _read_header(f, path)
        yield from _iter_blocks(f, path, schema, codec, sync)


def read_avro_schema(path: str):
    """Read just the schema from a container file's header."""
    with open(path, "rb") as f:
        return _read_header(f, path)[0]


def read_avro_file(path: str):
    """Read an Avro object container file -> (records, schema)."""
    with open(path, "rb") as f:
        schema, codec, sync = _read_header(f, path)
        records = list(_iter_blocks(f, path, schema, codec, sync))
    return records, schema


def iter_avro_records(paths: Iterable[str]) -> Iterator:
    """Stream records from one or more Avro files (directory ok),
    block-at-a-time — never materializes a whole file."""
    for path in _expand(paths):
        yield from stream_avro_file(path)


def _expand(paths) -> List[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = str(p)
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p)) if f.endswith(".avro")
            )
        else:
            out.append(p)
    return out
