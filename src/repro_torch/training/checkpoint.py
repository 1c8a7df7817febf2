"""Tree checkpoints in the JAX package's file format
(``repro/training/checkpoint.py``).

A single file holds one MessagePack map ``{flat_key: {"d": dtype name,
"s": shape, "b": raw bytes}}``, the keys the tree's paths joined by "/"
in JAX's sorted order, bfloat16 stored as its bytes (a uint8 view in
JAX). The same tree gives the same bytes in both packages, and each reads
the other's files. The card's machine has no ``msgpack`` package, so the
subset of MessagePack this format uses (maps, strings, binaries, arrays of
integers, integers) is encoded and decoded here. ``restore`` puts the
tensors on the card unless asked for another device.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.training.tree import flatten, unflatten


# ------------------------------------------------------------ MessagePack
def _packb(obj, out: bytearray) -> None:
    """Append ``obj`` (dict, str, bytes, list/tuple, int) as MessagePack,
    in the smallest form, as the ``msgpack`` package writes it."""
    if isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, 0xDE, 0xDF)
        for k, v in obj.items():
            _packb(k, out)
            _packb(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xD9, n)
        else:
            _head(out, n, None, 0, 0xDA, 0xDB)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 1 << 8:
            out += struct.pack(">BB", 0xC4, n)
        else:
            _head(out, n, None, 0, 0xC5, 0xC6)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, 0xDC, 0xDD)
        for v in obj:
            _packb(v, out)
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        _int(out, int(obj))
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a "
                        f"checkpoint")


def _head(out, n, fix, fix_limit, code16, code32):
    """A container's header: the fix form below ``fix_limit``, else a
    16- or 32-bit length."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", code16, n)
    else:
        out += struct.pack(">BI", code32, n)


def _int(out, x):
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if x < lim:
                out += struct.pack(fmt, code, x)
                return
        raise OverflowError(x)
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                               (0xD2, ">Bi", 1 << 31),
                               (0xD3, ">Bq", 1 << 63)):
            if x >= -lim:
                out += struct.pack(fmt, code, x)
                return
        raise OverflowError(x)


def packb(obj) -> bytes:
    out = bytearray()
    _packb(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
        0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: memoryview, i: int):
    """(object, next offset) of the MessagePack value at ``buf[i]``, one
    of the types ``_packb`` writes."""
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if c in _LEN:
        fmt = _LEN[c]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        kind = ("bin" if c <= 0xC6 else "str" if c <= 0xDB else
                "array" if c <= 0xDD else "map")
    elif 0x80 <= c < 0x90:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c < 0xA0:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c < 0xC0:
        kind, n = "str", c & 0x1F
    else:
        raise ValueError(f"MessagePack type 0x{c:02x} is not used by "
                         f"checkpoints")
    if kind == "bin":
        return bytes(buf[i:i + n]), i + n
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the map")
    return obj


# ------------------------------------------------------------ save/restore
def _record(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, raw = str(arr.dtype), arr.tobytes()
    return {"d": name, "s": list(t.shape), "b": raw}


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts of tensors) to ``path``, through a
    temporary file replaced at the end."""
    payload = {k: _record(v) for k, v in flatten(tree).items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)


def _tensor(rec: dict, device) -> torch.Tensor:
    dt, shape = rec["d"], tuple(rec["s"])
    if dt == "bfloat16":
        arr = np.frombuffer(rec["b"], np.int16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(
            shape).to(device)
    arr = np.frombuffer(rec["b"], np.dtype(dt)).copy()
    return torch.from_numpy(arr).reshape(shape).to(device)


def restore(path: str, *, device=None) -> Any:
    """The tree saved at ``path``, its tensors on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    return unflatten({k: _tensor(rec, dev) for k, rec in payload.items()})
