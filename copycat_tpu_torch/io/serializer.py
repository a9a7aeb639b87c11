"""Object serialization with a type-id registry (Catalyst ``Serializer`` equivalent).

The reference serializes every operation with ``@SerializeWith(id=...)`` classes
implementing ``CatalystSerializable.writeObject/readObject`` (SURVEY.md §2.3;
reference ids: 28-38 infra, 50-55 atomic, 60-105 collections, 85-89 + 110-127
coordination — the same id blocks are reused here for parity auditing).

Design differences from the reference (deliberate):

- Class-by-name serialization exists (``write_class``/``read_class``, used by
  the ``CreateResource`` catalog op per reference ``CreateResource.java:55-66``)
  but is restricted to registered resource/state-machine classes — no arbitrary
  ``Class.forName``.
- No serialized closures: the reference logs ``Runnable`` closures for group
  remote-execution (``MembershipGroupCommands.java:85``); here remote execution
  ships a registered callback id + args instead (see coordination/group.py).
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, Type, runtime_checkable

from .buffer import BufferInput, BufferOutput

# Built-in wire tags for primitives / containers (< 16 reserved).
_T_NULL = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_BYTES = 6
_T_LIST = 7
_T_DICT = 8
_T_TUPLE = 9
_T_SET = 10
_T_CLASS = 11  # registered class reference, by serialization id


@runtime_checkable
class CatalystSerializable(Protocol):
    """Objects that write/read themselves through typed buffers."""

    def write_object(self, buffer: BufferOutput, serializer: "Serializer") -> None: ...

    def read_object(self, buffer: BufferInput, serializer: "Serializer") -> None: ...


_TYPE_REGISTRY: dict[int, type] = {}
_ID_BY_TYPE: dict[type, int] = {}
#: type_id -> tuple of field names for classes whose write/read is the
#: GENERIC field-list form (both methods carry the ``_generic_fields``
#: marker set by protocol.messages.Message), else None. The native codec
#: (io/codec.py) serializes generic classes entirely in C; None means it
#: calls back into the class's custom write_object/read_object.
_CODEC_FIELDS: dict[int, tuple | None] = {}
#: type_id -> count of TRAILING fields that are wire-optional (a
#: trailing None run is omitted when writing; a reader at end-of-buffer
#: fills them with None). Mirrors ``Message._optional`` so the C walk
#: and the Python walk stay byte-identical; only meaningful for
#: top-level RPC messages (see protocol/messages.py).
_CODEC_OPTIONAL: dict[int, int] = {}


def _generic_fields(cls: type) -> tuple | None:
    w = getattr(cls, "write_object", None)
    r = getattr(cls, "read_object", None)
    if getattr(w, "_generic_fields", False) \
            and getattr(r, "_generic_fields", False):
        fields = getattr(cls, "_fields", None)
        if fields is not None:
            return tuple(fields)
    return None


def serialize_with(type_id: int) -> Callable[[type], type]:
    """Class decorator registering a serializable type under a stable id.

    Equivalent of the reference's ``@SerializeWith(id=...)`` annotation.
    """

    def register(cls: type) -> type:
        check = _TYPE_REGISTRY.get(type_id)
        if check is not None and check is not cls and check.__qualname__ != cls.__qualname__:
            raise ValueError(f"serialization id {type_id} already bound to {check!r}")
        _TYPE_REGISTRY[type_id] = cls
        _ID_BY_TYPE[cls] = type_id
        fields = _generic_fields(cls)
        _CODEC_FIELDS[type_id] = fields
        _CODEC_OPTIONAL[type_id] = (
            int(getattr(cls, "_optional", 0)) if fields is not None else 0)
        return cls

    return register


def registered_type(type_id: int) -> type | None:
    return _TYPE_REGISTRY.get(type_id)


class SerializationError(Exception):
    pass


def _native() -> Any:
    """Lazy import breaks the codec<->serializer import cycle."""
    from .codec import codec
    return codec()


class Serializer:
    """Writes/reads arbitrary object graphs of primitives + registered types.

    ``write``/``read`` prefer the native codec (io/codec.py, a
    byte-identical C walk of the same format) and fall back to the pure
    Python below on ``Fallback`` (>64-bit ints) or when the extension
    is unavailable. ``write_object``/``read_object`` ARE the format's
    reference implementation — custom-serialized classes re-enter
    through them from the native side too.
    """

    def write(self, obj: Any) -> bytes:
        c = _native()
        if c is not None:
            try:
                return c.encode(obj)
            except c.Fallback:
                pass
        buf = BufferOutput()
        self.write_object(obj, buf)
        return buf.to_bytes()

    def read(self, data: bytes) -> Any:
        c = _native()
        if c is not None:
            try:
                return c.decode(bytes(data))
            except c.Fallback:
                pass
        return self.read_object(BufferInput(data))

    # -- object graph ------------------------------------------------------

    def write_object(self, obj: Any, buf: BufferOutput) -> None:
        if obj is None:
            buf.write_varint(_T_NULL)
        elif obj is True:
            buf.write_varint(_T_TRUE)
        elif obj is False:
            buf.write_varint(_T_FALSE)
        elif isinstance(obj, int):
            buf.write_varint(_T_INT).write_varint(obj)
        elif isinstance(obj, float):
            buf.write_varint(_T_FLOAT).write_f64(obj)
        elif isinstance(obj, str):
            buf.write_varint(_T_STR).write_utf8(obj)
        elif isinstance(obj, (bytes, bytearray)):
            buf.write_varint(_T_BYTES).write_bytes(bytes(obj))
        elif isinstance(obj, list):
            buf.write_varint(_T_LIST).write_varint(len(obj))
            for item in obj:
                self.write_object(item, buf)
        elif isinstance(obj, tuple):
            buf.write_varint(_T_TUPLE).write_varint(len(obj))
            for item in obj:
                self.write_object(item, buf)
        elif isinstance(obj, (set, frozenset)):
            # Order by encoded bytes so the wire format is deterministic even
            # for registered objects (repr would embed memory addresses).
            buf.write_varint(_T_SET).write_varint(len(obj))
            for encoded in sorted(self.write(item) for item in obj):
                buf.write_raw(encoded)
        elif isinstance(obj, dict):
            buf.write_varint(_T_DICT).write_varint(len(obj))
            for key, value in obj.items():
                self.write_object(key, buf)
                self.write_object(value, buf)
        elif isinstance(obj, type):
            self.write_class(obj, buf)
        else:
            type_id = _ID_BY_TYPE.get(type(obj))
            if type_id is None:
                raise SerializationError(
                    f"unregistered type {type(obj).__qualname__}; decorate with @serialize_with(id)"
                )
            buf.write_varint(16 + type_id)
            obj.write_object(buf, self)

    def read_object(self, buf: BufferInput) -> Any:
        tag = buf.read_varint()
        if tag == _T_NULL:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            return buf.read_varint()
        if tag == _T_FLOAT:
            return buf.read_f64()
        if tag == _T_STR:
            return buf.read_utf8()
        if tag == _T_BYTES:
            return buf.read_bytes()
        if tag == _T_LIST:
            return [self.read_object(buf) for _ in range(buf.read_varint())]
        if tag == _T_TUPLE:
            return tuple(self.read_object(buf) for _ in range(buf.read_varint()))
        if tag == _T_SET:
            return {self.read_object(buf) for _ in range(buf.read_varint())}
        if tag == _T_DICT:
            n = buf.read_varint()
            return {self.read_object(buf): self.read_object(buf) for _ in range(n)}
        if tag == _T_CLASS:
            return self._read_class_body(buf)
        cls = _TYPE_REGISTRY.get(tag - 16)
        if cls is None:
            raise SerializationError(f"unknown serialization id {tag - 16}")
        obj = cls.__new__(cls)
        obj.read_object(buf, self)
        return obj

    # -- class references (for CreateResource-style catalog ops) ----------

    def write_class(self, cls: Type, buf: BufferOutput) -> None:
        type_id = _ID_BY_TYPE.get(cls)
        if type_id is None:
            raise SerializationError(
                f"class {cls.__qualname__} not registered; register with @serialize_with(id)"
            )
        buf.write_varint(_T_CLASS).write_varint(type_id)

    def _read_class_body(self, buf: BufferInput) -> Type:
        type_id = buf.read_varint()
        cls = _TYPE_REGISTRY.get(type_id)
        if cls is None:
            raise SerializationError(f"unknown class id {type_id}")
        return cls

    def clone(self, obj: Any) -> Any:
        """Round-trip an object through the wire format (used by LocalTransport)."""
        return self.read(self.write(obj))
