"""Native codec loader: build-on-demand CPython extension + fallback hooks.

The wire format's reference implementation is the pure-Python
:mod:`serializer`; ``native/copycat_codec.c`` is a byte-identical C
walk of the same object graphs (the reference's serializer ran on the
JVM JIT — this is the equivalent native runtime component, SURVEY.md
§2.3 "serialization"). Loading degrades gracefully: no toolchain (or a
build failure) leaves ``codec()`` returning None and every caller on
the Python path.

The extension sees the LIVE registries from serializer.py (the
``@serialize_with`` decorator mutates them; C reads them per lookup),
plus two Python callbacks for classes with hand-written
write_object/read_object:

- ``encode_body(obj) -> bytes`` — the body after the 16+id tag;
- ``decode_body(cls, data, pos) -> (obj, new_pos)``.

Anything the C path can't express (ints beyond 64 bits, unregistered
types) raises ``Fallback`` and Serializer.write/read re-run pure
Python — the native path is an accelerator, never a semantic fork.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import pathlib
import shutil
import subprocess
from typing import Any

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_SO_PATH = _NATIVE_DIR / "copycat_codec.so"
#: the port loads its own copy of the built extension: the module keeps
#: the registries it is configured with in C statics, and a process that
#: holds both packages (their tests) must not let one package's
#: ``configure`` replace the other's registries (one shared object file
#: is one set of statics; a copy under another path is another)
_PORT_SO_PATH = (pathlib.Path(__file__).resolve().parents[1] / "_build"
                 / "copycat_codec.so")

_codec: Any = None
_codec_err: str | None = None


def _build_and_load() -> Any:
    src = _NATIVE_DIR / "copycat_codec.c"
    if (not _SO_PATH.exists()
            or _SO_PATH.stat().st_mtime < src.stat().st_mtime):
        subprocess.run(["make", "-C", str(_NATIVE_DIR), "copycat_codec.so"],
                       check=True, capture_output=True, timeout=120)
    if (not _PORT_SO_PATH.exists()
            or _PORT_SO_PATH.stat().st_mtime < _SO_PATH.stat().st_mtime):
        _PORT_SO_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = _PORT_SO_PATH.with_name(f".{_PORT_SO_PATH.name}.{os.getpid()}")
        shutil.copy2(_SO_PATH, tmp)
        os.replace(tmp, _PORT_SO_PATH)
    loader = importlib.machinery.ExtensionFileLoader(
        "copycat_codec", str(_PORT_SO_PATH))
    spec = importlib.util.spec_from_loader("copycat_codec", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _configure(mod: Any) -> None:
    from .buffer import BufferInput, BufferOutput
    from . import serializer as s

    default = s.Serializer()

    def encode_body(obj: Any) -> bytes:
        buf = BufferOutput()
        obj.write_object(buf, default)
        return buf.to_bytes()

    def decode_body(cls: type, data: bytes, pos: int):
        buf = BufferInput(data)
        buf._pos = pos
        obj = cls.__new__(cls)
        obj.read_object(buf, default)
        return obj, buf._pos

    mod.configure(s._ID_BY_TYPE, s._TYPE_REGISTRY, s._CODEC_FIELDS,
                  encode_body, decode_body, s._CODEC_OPTIONAL)


def codec() -> Any:
    """The configured extension module, or None when unavailable."""
    global _codec, _codec_err
    if _codec is not None or _codec_err is not None:
        return _codec
    try:
        mod = _build_and_load()
        _configure(mod)
        _codec = mod
    except Exception as exc:  # toolchain missing — degrade gracefully
        _codec_err = str(exc)
    return _codec


def codec_error() -> str | None:
    return _codec_err
