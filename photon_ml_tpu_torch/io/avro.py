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

import collections
import concurrent.futures
import hashlib
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
_ONE_BYTE = [bytes([n]) for n in range(0x80)]


def _long_bytes(n: int) -> bytes:
    """The zig-zag varint encoding of ``n``."""
    n = (n << 1) ^ (n >> 63)  # zig-zag
    if n < 0x80:
        return _ONE_BYTE[n]
    out = bytearray()
    while (n & ~0x7F) != 0:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _write_long(out: BinaryIO, n: int) -> None:
    out.write(_long_bytes(n))


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


def _read_long(buf: BinaryIO) -> int:
    v = _read_long_or_eof(buf)
    if v is None:
        raise EOFError("truncated varint")
    return v


# -- datum encode/decode ---------------------------------------------------
# Each schema compiles once (``_encoder``, ``_decoder``), so a record's
# fields are not dispatched on their schema type again for every datum:
# records and arrays into generated straight-line functions (below), the
# other types into closures; the bytes are those of the Avro spec either
# way. Recursive named types compile through a forward reference.
def _encoder(schema, _memo=None):
    """``enc(datum) -> bytes`` for ``schema``."""
    memo = {} if _memo is None else _memo
    key = id(schema)
    if key in memo:
        cell = memo[key]
        return lambda d: cell[0](d)
    t = _schema_type(schema)
    if isinstance(t, (dict, list)):
        return _encoder(t, memo)
    if t == "null":
        return lambda d: b""
    if t == "boolean":
        return lambda d: b"\x01" if d else b"\x00"
    if t in ("int", "long"):
        return lambda d: _long_bytes(int(d))
    if t in ("float", "double"):
        pack = struct.Struct("<f" if t == "float" else "<d").pack
        return lambda d: pack(float(d))
    if t == "bytes":
        def enc_bytes(d):
            raw = bytes(d)
            return _long_bytes(len(raw)) + raw
        return enc_bytes
    if t == "string":
        def enc_string(d):
            raw = str(d).encode("utf-8")
            return _long_bytes(len(raw)) + raw
        return enc_string
    if t == "enum":
        symbols = schema["symbols"]
        return lambda d: _long_bytes(symbols.index(d))
    if t == "fixed":
        size = schema["size"]

        def enc_fixed(d):
            raw = bytes(d)
            if len(raw) != size:
                raise ValueError(f"fixed size mismatch: {len(raw)} != {size}")
            return raw
        return enc_fixed
    cell = [None]
    memo[key] = cell
    if t in ("record", "array"):
        enc = _compiled_encoder(schema, t, memo)
    elif t == "map":
        venc = _encoder(schema["values"], memo)
        kenc = _encoder("string", memo)

        def enc(d):
            entries = dict(d)
            if not entries:
                return b"\x00"
            return (_long_bytes(len(entries))
                    + b"".join(kenc(k) + venc(v) for k, v in entries.items())
                    + b"\x00")
    elif t == "union":
        branches = [_encoder(b, memo) for b in schema]

        def enc(d):
            idx = _union_branch(d, schema)
            return _long_bytes(idx) + branches[idx](d)
    else:
        raise ValueError(f"unsupported schema type {t!r}")
    cell[0] = enc
    return enc


# -- straight-line encoders ------------------------------------------------
# The mirror of the straight-line decoders below: a record (given as a
# dict) or an array writes its simple fields inline, and calls the
# encoder of any other field.
def _emit_put(lines, ind, schema, var, subs, memo):
    """Code that appends the encoding of ``var`` (of ``schema``)."""
    t = _simple_type(schema) if _schema_type(schema) != "union" else None
    if t == "null":
        return
    if t == "boolean":
        lines.append(f"{ind}add(b'\\x01' if {var} else b'\\x00')")
    elif t in ("int", "long"):
        lines.append(f"{ind}add(_lb(int({var})))")
    elif t in ("float", "double"):
        lines.append(f"{ind}add(_p{t[0]}(float({var})))")
    elif t in ("string", "bytes"):
        raw = (f"str({var}).encode('utf-8')" if t == "string"
               else f"bytes({var})")
        lines += [f"{ind}r = {raw}", f"{ind}add(_lb(len(r)))",
                  f"{ind}add(r)"]
    else:
        subs.append(_encoder(schema, memo))
        lines.append(f"{ind}add(_s{len(subs) - 1}({var}))")


def _emit_put_record(lines, ind, schema, var, subs, memo):
    for f in schema["fields"]:
        name = f["name"]
        if "default" in f:
            subs.append(f["default"])
            missing = f"_s{len(subs) - 1}"
        else:
            subs.append(name)
            missing = f"_missing(_s{len(subs) - 1})"
        lines.append(f"{ind}v = {var}[{name!r}] if {name!r} in {var} "
                     f"else {missing}")
        _emit_put(lines, ind, f["type"], "v", subs, memo)


def _missing(name):
    raise ValueError(f"record field '{name}' missing and no default")


def _compiled_encoder(schema, t, memo):
    subs: List = []
    lines = ["def enc(d):"]
    if t == "record":
        subs.append(None)  # _s0: the generic encoder, for non-dict data
        lines += ["    if not isinstance(d, dict):",
                  "        return _s0(d)",
                  "    parts = []", "    add = parts.append"]
        _emit_put_record(lines, "    ", schema, "d", subs, memo)
        lines.append("    return b''.join(parts)")
    else:
        items = schema["items"]
        lines += ["    items = list(d)", "    if not items:",
                  "        return b'\\x00'",
                  "    parts = [_lb(len(items))]", "    add = parts.append",
                  "    for item in items:"]
        if (_schema_type(items) == "record"
                and all(_is_simple(f["type"]) for f in items["fields"])):
            subs.append(_encoder(items, memo))
            lines += ["        if not isinstance(item, dict):",
                      f"            add(_s{len(subs) - 1}(item))",
                      "            continue"]
            _emit_put_record(lines, "        ", items, "item", subs, memo)
        else:
            _emit_put(lines, "        ", items, "item", subs, memo)
        lines += ["    add(b'\\x00')", "    return b''.join(parts)"]
    scope = {"_lb": _long_bytes, "_missing": _missing,
             "_pf": struct.Struct("<f").pack,
             "_pd": struct.Struct("<d").pack}
    scope.update((f"_s{i}", sub) for i, sub in enumerate(subs))
    if t == "record":
        scope["_s0"] = _generic_record_encoder(schema, memo)
    exec("\n".join(lines), scope)
    return scope["enc"]


def _generic_record_encoder(schema, memo):
    """A record given as an object: its fields by attribute."""
    fields = [(f["name"], _encoder(f["type"], memo))
              for f in schema["fields"]]
    return lambda d: b"".join(fenc(getattr(d, name))
                              for name, fenc in fields)


def write_datum(out: BinaryIO, datum, schema) -> None:
    out.write(_encoder(schema)(datum))


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


def _read_meta(f: BinaryIO) -> dict:
    """A container header's metadata, an Avro ``map<bytes>``, from a
    stream (the blocks' records go through ``_decoder``)."""
    meta = {}
    while True:
        count = _read_long(f)
        if count == 0:
            return meta
        if count < 0:  # block with byte-size prefix
            count = -count
            _read_long(f)
        for _ in range(count):
            key = f.read(_read_long(f)).decode("utf-8")
            meta[key] = f.read(_read_long(f))


def _read_long_at(buf: bytes, pos: int):
    """A zig-zag varint of ``buf`` at ``pos`` -> (value, next position)."""
    shift = 0
    acc = 0
    try:
        while True:
            byte = buf[pos]
            pos += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return (acc >> 1) ^ -(acc & 1), pos
            shift += 7
    except IndexError:
        raise EOFError("truncated varint") from None


def _take(buf: bytes, pos: int, n: int):
    end = pos + n
    if n < 0 or end > len(buf):
        raise EOFError("truncated datum")
    return buf[pos:end], end


def _decoder(schema, _memo=None):
    """``dec(buf, pos) -> (datum, next position)`` for ``schema``: the
    decoder of a container block's records."""
    memo = {} if _memo is None else _memo
    key = id(schema)
    if key in memo:
        cell = memo[key]
        return lambda buf, pos: cell[0](buf, pos)
    t = _schema_type(schema)
    if isinstance(t, (dict, list)):
        return _decoder(t, memo)
    if t == "null":
        return lambda buf, pos: (None, pos)
    if t == "boolean":
        def dec_bool(buf, pos):
            raw, pos = _take(buf, pos, 1)
            return raw == b"\x01", pos
        return dec_bool
    if t in ("int", "long"):
        return _read_long_at
    if t in ("float", "double"):
        fmt = struct.Struct("<f" if t == "float" else "<d")

        def dec_real(buf, pos):
            if pos + fmt.size > len(buf):
                raise EOFError("truncated datum")
            return fmt.unpack_from(buf, pos)[0], pos + fmt.size
        return dec_real
    if t == "bytes":
        def dec_bytes(buf, pos):
            n, pos = _read_long_at(buf, pos)
            return _take(buf, pos, n)
        return dec_bytes
    if t == "string":
        def dec_string(buf, pos):
            n, pos = _read_long_at(buf, pos)
            raw, pos = _take(buf, pos, n)
            return raw.decode("utf-8"), pos
        return dec_string
    if t == "enum":
        symbols = schema["symbols"]

        def dec_enum(buf, pos):
            i, pos = _read_long_at(buf, pos)
            return symbols[i], pos
        return dec_enum
    if t == "fixed":
        size = schema["size"]
        return lambda buf, pos: _take(buf, pos, size)
    cell = [None]
    memo[key] = cell
    if t in ("record", "array"):
        dec = _compiled_decoder(schema, t, memo)
    elif t == "map":
        vdec = _decoder(schema["values"], memo)
        kdec = _decoder("string", memo)

        def dec(buf, pos):
            out = {}
            while True:
                count, pos = _read_long_at(buf, pos)
                if count == 0:
                    return out, pos
                if count < 0:  # block with byte-size prefix
                    count = -count
                    _, pos = _read_long_at(buf, pos)
                for _ in range(count):
                    k, pos = kdec(buf, pos)
                    out[k], pos = vdec(buf, pos)
    elif t == "union":
        branches = [_decoder(b, memo) for b in schema]

        def dec(buf, pos):
            i, pos = _read_long_at(buf, pos)
            return branches[i](buf, pos)
    else:
        raise ValueError(f"unsupported schema type {t!r}")
    cell[0] = dec
    return dec


# -- straight-line decoders ------------------------------------------------
# A record or array decodes through one generated function: every field
# of a simple type (null, boolean, int, long, float, double, string,
# bytes, or a union of those) is read inline, with a one-byte varint read
# without a call; other fields call their own decoder. Truncated input
# raises EOFError.
_SIMPLE = {"null", "boolean", "int", "long", "float", "double", "string",
           "bytes"}


def _simple_type(schema):
    """``schema``'s primitive type name when it is simple, else None."""
    t = _schema_type(schema)
    if isinstance(t, (dict, list)):
        return _simple_type(t)
    return t if t in _SIMPLE else None


def _is_simple(schema) -> bool:
    if _schema_type(schema) == "union":
        return all(_simple_type(b) is not None for b in schema)
    return _simple_type(schema) is not None


def _emit_long(lines, ind, var):
    lines += [f"{ind}b = buf[pos]",
              f"{ind}if b < 0x80:",
              f"{ind}    {var} = (b >> 1) ^ -(b & 1)",
              f"{ind}    pos += 1",
              f"{ind}else:",
              f"{ind}    {var}, pos = _rl(buf, pos)"]


def _emit_simple(lines, ind, t, var):
    """Code that reads one datum of simple type ``t`` into ``var``."""
    if t == "null":
        lines.append(f"{ind}{var} = None")
    elif t == "boolean":
        lines += [f"{ind}if pos >= nbuf:",
                  f"{ind}    raise EOFError('truncated datum')",
                  f"{ind}{var} = buf[pos] == 1",
                  f"{ind}pos += 1"]
    elif t in ("int", "long"):
        _emit_long(lines, ind, var)
    elif t in ("float", "double"):
        size = 4 if t == "float" else 8
        lines += [f"{ind}if pos + {size} > nbuf:",
                  f"{ind}    raise EOFError('truncated datum')",
                  f"{ind}{var} = _u{t[0]}(buf, pos)[0]",
                  f"{ind}pos += {size}"]
    else:  # string, bytes
        _emit_long(lines, ind, "n")
        lines += [f"{ind}e = pos + n",
                  f"{ind}if n < 0 or e > nbuf:",
                  f"{ind}    raise EOFError('truncated datum')",
                  f"{ind}{var} = buf[pos:e]" + (".decode('utf-8')"
                                                if t == "string" else ""),
                  f"{ind}pos = e"]


def _emit_datum(lines, ind, schema, var, subs, memo):
    """Code that reads one datum of ``schema`` into ``var``."""
    if _schema_type(schema) == "union" and _is_simple(schema):
        _emit_long(lines, ind, "u")
        for i, branch in enumerate(schema):
            lines.append(f"{ind}{'if' if i == 0 else 'elif'} u == {i}:")
            _emit_simple(lines, ind + "    ", _simple_type(branch), var)
        lines += [f"{ind}else:",
                  f"{ind}    raise IndexError('union branch out of range')"]
    elif _simple_type(schema) is not None:
        _emit_simple(lines, ind, _simple_type(schema), var)
    else:
        subs.append(_decoder(schema, memo))
        lines.append(f"{ind}{var}, pos = _s{len(subs) - 1}(buf, pos)")


def _emit_record(lines, ind, schema, var, subs, memo):
    names = []
    for i, f in enumerate(schema["fields"]):
        _emit_datum(lines, ind, f["type"], f"v{i}", subs, memo)
        names.append(f"{f['name']!r}: v{i}")
    lines.append(f"{ind}{var} = {{{', '.join(names)}}}")


def _compiled_decoder(schema, t, memo):
    subs: List = []
    lines = ["def dec(buf, pos):", "    nbuf = len(buf)"]
    body: List[str] = []
    if t == "record":
        _emit_record(body, "    ", schema, "out", subs, memo)
        body.append("    return out, pos")
    else:
        items = schema["items"]
        body += ["    out = []", "    add = out.append", "    while True:"]
        _emit_long(body, "        ", "count")
        body += ["        if count == 0:",
                 "            return out, pos",
                 "        if count < 0:  # block with byte-size prefix",
                 "            count = -count",
                 "            _, pos = _rl(buf, pos)",
                 "        for _ in range(count):"]
        if (_schema_type(items) == "record"
                and all(_is_simple(f["type"]) for f in items["fields"])):
            _emit_record(body, "            ", items, "item", subs, memo)
        else:
            _emit_datum(body, "            ", items, "item", subs, memo)
        body.append("            add(item)")
    lines += ["    try:"] + ["    " + line for line in body]
    lines += ["    except IndexError:",
              "        raise EOFError('truncated datum') from None"]
    scope = {"_rl": _read_long_at, "_uf": struct.Struct("<f").unpack_from,
             "_ud": struct.Struct("<d").unpack_from}
    scope.update((f"_s{i}", sub) for i, sub in enumerate(subs))
    exec("\n".join(lines), scope)
    return scope["dec"]


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
        # a full block is compressed on a worker thread (zlib releases the
        # interpreter lock) while the next one is encoded; blocks are
        # written in order, so the file is the same bytes either way
        pending: "collections.deque" = collections.deque()
        pool = None

        def emit(count, payload):
            _write_long(f, count)
            _write_long(f, len(payload))
            f.write(payload)
            f.write(sync)

        def flush(block, last):
            nonlocal pool
            if block and codec == "deflate" and (pool is not None
                                                 or not last):
                if pool is None:
                    pool = concurrent.futures.ThreadPoolExecutor(
                        _DEFLATE_THREADS)
                pending.append((len(block),
                                pool.submit(_deflate, b"".join(block))))
            elif block:
                payload = b"".join(block)
                emit(len(block), _deflate(payload) if codec == "deflate"
                     else payload)
            while pending and (last or len(pending) > 2 * _DEFLATE_THREADS
                               or pending[0][1].done()):
                count, fut = pending.popleft()
                emit(count, fut.result())

        enc = _encoder(schema)
        block: List[bytes] = []
        try:
            for rec in records:
                block.append(enc(rec))
                if len(block) >= block_size:
                    flush(block, last=False)
                    block = []
            flush(block, last=True)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)


_DEFLATE_THREADS = max(1, min(8, os.cpu_count() or 1))


def _deflate(payload: bytes) -> bytes:
    """Raw deflate at level 9 (the spec's deflate codec)."""
    comp = zlib.compressobj(9, zlib.DEFLATED, -15)
    return comp.compress(payload) + comp.flush()


def _read_header(f: BinaryIO, path: str):
    """Read container-file magic + metadata -> (schema, codec, sync)."""
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta = _read_meta(f)
    schema = parse_schema(json.loads(meta["avro.schema"].decode()))
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"{path}: unsupported codec '{codec}'")
    sync = f.read(16)
    return schema, codec, sync


def _iter_blocks(f: BinaryIO, path: str, schema, codec: str, sync: bytes) -> Iterator:
    """Yield records from a positioned container file, one block at a time."""
    dec = _decoder(schema)
    while True:
        count = _read_long_or_eof(f)
        if count is None:
            return
        size = _read_long(f)
        payload = f.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        pos = 0
        for _ in range(count):
            rec, pos = dec(payload, pos)
            yield rec
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
