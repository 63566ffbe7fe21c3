"""Parquet footer parse → prune → re-serialize (host engine, CPU only).

The port's own copy of the JAX package's ``parquet/footer.py``: the same
capability surface and semantics as the reference's footer module
(``NativeParquetJni.cpp``), in plain Python.  Reference behaviors reproduced:

* column pruning against a Spark-side expected-schema tree with
  VALUE/STRUCT/LIST/MAP tags, case-(in)sensitive matching and subtree skip
  (``NativeParquetJni.cpp:101-437``), including the LIST layout rules
  (2-level legacy vs 3-level standard, ``:272-300``) and MAP
  MAP/MAP_KEY_VALUE with optional value (``:303-360``);
* row-group selection by split midpoint ∈ [part_offset, part_offset+len)
  with the PARQUET-2078 invalid-file_offset fallback (``:437-519``);
* column-chunk gather per surviving row group (``:552-560``);
* column_orders gathered by chunk map (``:606-613``); root num_children
  rewritten per surviving children (``:595-605``);
* re-serialization with full-file framing "PAR1" + thrift + len + "PAR1"
  (``:666-699``).

Unlike the reference (typed thrift codegen), pruning operates on a generic
field tree (see ``thrift.py``) so unknown/future footer fields survive
round trips untouched.
"""

from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Optional, Sequence

from ..faultinj.injector import fault_site
from .thrift import (CompactReader, CompactWriter, Field, ListValue, Struct,
                     ThriftError, TType, parse_struct, serialize_struct)

# -- field ids (public parquet.thrift definition) ---------------------------

class FMD:       # FileMetaData
    VERSION = 1
    SCHEMA = 2
    NUM_ROWS = 3
    ROW_GROUPS = 4
    KEY_VALUE_METADATA = 5
    CREATED_BY = 6
    COLUMN_ORDERS = 7


class SE:        # SchemaElement
    TYPE = 1
    TYPE_LENGTH = 2
    REPETITION_TYPE = 3
    NAME = 4
    NUM_CHILDREN = 5
    CONVERTED_TYPE = 6


class RG:        # RowGroup
    COLUMNS = 1
    TOTAL_BYTE_SIZE = 2
    NUM_ROWS = 3
    FILE_OFFSET = 5
    TOTAL_COMPRESSED_SIZE = 6


class CC:        # ColumnChunk
    FILE_PATH = 1
    FILE_OFFSET = 2
    META_DATA = 3


class CMD:       # ColumnMetaData
    TOTAL_COMPRESSED_SIZE = 7
    DATA_PAGE_OFFSET = 9
    DICTIONARY_PAGE_OFFSET = 11


CONVERTED_MAP = 1
CONVERTED_MAP_KEY_VALUE = 2
CONVERTED_LIST = 3
REPETITION_REPEATED = 2

MAGIC = b"PAR1"


# -- expected-schema DSL (ParquetFooter.java:35-93 analog) ------------------

TAG_VALUE, TAG_STRUCT, TAG_LIST, TAG_MAP = 0, 1, 2, 3


@dataclasses.dataclass
class SchemaNode:
    name: str
    tag: int
    children: list["SchemaNode"] = dataclasses.field(default_factory=list)

    def flatten_depth_first(self):
        """→ (names, num_children, tags) arrays, root excluded
        (ParquetFooter.java:136-185)."""
        names, num_children, tags = [], [], []

        def walk(node):
            for c in node.children:
                names.append(c.name)
                num_children.append(len(c.children))
                tags.append(c.tag)
                walk(c)

        walk(self)
        return names, num_children, tags


def ValueElement(name: str) -> SchemaNode:
    return SchemaNode(name, TAG_VALUE)


def StructElement(name: str, *children: SchemaNode) -> SchemaNode:
    return SchemaNode(name, TAG_STRUCT, list(children))


def ListElement(name: str, element: SchemaNode) -> SchemaNode:
    element = dataclasses.replace(element, name="element")
    return SchemaNode(name, TAG_LIST, [element])


def MapElement(name: str, key: SchemaNode, value: SchemaNode) -> SchemaNode:
    key = dataclasses.replace(key, name="key")
    value = dataclasses.replace(value, name="value")
    return SchemaNode(name, TAG_MAP, [key, value])


# -- pruner -----------------------------------------------------------------

class PruneError(ValueError):
    pass


@dataclasses.dataclass
class PruningMaps:
    schema_map: list[int]
    schema_num_children: list[int]
    chunk_map: list[int]


class ColumnPruner:
    """Expected-schema tree matcher (column_pruner, NativeParquetJni.cpp:112-437)."""

    def __init__(self, tag: int = TAG_STRUCT):
        self.tag = tag
        self.children: dict[str, "ColumnPruner"] = {}

    @classmethod
    def from_flat(cls, names: Sequence[str], num_children: Sequence[int],
                  tags: Sequence[int], parent_num_children: int,
                  fold_case: bool = False):
        """``fold_case`` lowercases the expected names so they can match the
        case-folded footer names — the reference folds both sides (the Java
        caller folds the expected names, the C++ side folds the footer's)."""
        root = cls(TAG_STRUCT)
        if parent_num_children == 0:
            return root
        stack = [(root, parent_num_children)]
        for name, n_c, t in zip(names, num_children, tags):
            if fold_case:
                name = name.lower()
            node = cls(t)
            stack[-1][0].children[name] = node
            if n_c > 0:
                stack.append((node, n_c))
            else:
                while stack:
                    parent, left = stack.pop()
                    if left - 1 > 0:
                        stack.append((parent, left - 1))
                        break
        if stack:
            raise ValueError("flattened schema arrays are inconsistent")
        return root

    @classmethod
    def from_tree(cls, root: SchemaNode, fold_case: bool = False):
        names, num_children, tags = root.flatten_depth_first()
        return cls.from_flat(names, num_children, tags, len(root.children),
                             fold_case)

    # -- matching -----------------------------------------------------------
    def filter_schema(self, schema: list[Struct], ignore_case: bool) -> PruningMaps:
        maps = PruningMaps([], [], [])
        state = [0, 0]  # schema index, chunk index
        self._filter(schema, ignore_case, state, maps)
        return maps

    # schema helpers
    @staticmethod
    def _name(elem: Struct, fold: bool) -> str:
        raw = elem.get(SE.NAME, b"")
        s = raw.decode("utf-8") if isinstance(raw, bytes) else raw
        return s.lower() if fold else s

    @staticmethod
    def _num_children(elem: Struct) -> int:
        return elem.get(SE.NUM_CHILDREN, 0) or 0

    @staticmethod
    def _is_leaf(elem: Struct) -> bool:
        return elem.has(SE.TYPE)

    def _skip(self, schema, state):
        """Skip current element + subtree, advancing the chunk counter for
        every leaf (NativeParquetJni.cpp:160-180)."""
        to_skip = 1
        while to_skip > 0 and state[0] < len(schema):
            elem = schema[state[0]]
            if self._is_leaf(elem):
                state[1] += 1
            to_skip += self._num_children(elem) - 1
            state[0] += 1

    def _filter(self, schema, ignore_case, state, maps):
        if self.tag == TAG_STRUCT:
            self._filter_struct(schema, ignore_case, state, maps)
        elif self.tag == TAG_VALUE:
            self._filter_value(schema, state, maps)
        elif self.tag == TAG_LIST:
            self._filter_list(schema, ignore_case, state, maps)
        elif self.tag == TAG_MAP:
            self._filter_map(schema, ignore_case, state, maps)
        else:
            raise PruneError(f"unexpected tag {self.tag}")

    def _filter_struct(self, schema, ignore_case, state, maps):
        elem = schema[state[0]]
        if self._is_leaf(elem):
            raise PruneError("found a leaf node, but expected a struct")
        n = self._num_children(elem)
        maps.schema_map.append(state[0])
        my_nc = len(maps.schema_num_children)
        maps.schema_num_children.append(0)
        state[0] += 1
        for _ in range(n):
            if state[0] >= len(schema):
                break
            child = schema[state[0]]
            name = self._name(child, ignore_case)
            found = self.children.get(name)
            if found is not None:
                maps.schema_num_children[my_nc] += 1
                found._filter(schema, ignore_case, state, maps)
            else:
                self._skip(schema, state)

    def _filter_value(self, schema, state, maps):
        elem = schema[state[0]]
        if not self._is_leaf(elem):
            raise PruneError("found a non-leaf entry when reading a leaf value")
        if self._num_children(elem) != 0:
            raise PruneError("found an entry with children when reading a leaf value")
        maps.schema_map.append(state[0])
        maps.schema_num_children.append(0)
        state[0] += 1
        maps.chunk_map.append(state[1])
        state[1] += 1

    def _filter_list(self, schema, ignore_case, state, maps):
        found = self.children["element"]
        elem = schema[state[0]]
        list_name = self._name(elem, False)
        if self._is_leaf(elem):
            raise PruneError("expected a list item, but found a single value")
        if elem.get(SE.CONVERTED_TYPE) != CONVERTED_LIST:
            raise PruneError("expected a list type, but it was not found")
        if self._num_children(elem) != 1:
            raise PruneError("the structure of the outer list group is not standard")
        maps.schema_map.append(state[0])
        maps.schema_num_children.append(1)
        state[0] += 1

        # Parquet LIST layout rules (NativeParquetJni.cpp:271-299): a
        # repeated group with one child not named "array"/"<list>_tuple" is
        # the standard 3-level form; anything else is the legacy 2-level form.
        rep = schema[state[0]]
        if rep.get(SE.REPETITION_TYPE) != REPETITION_REPEATED:
            raise PruneError("the structure of the list's child is not standard (non repeating)")
        rep_is_group = not self._is_leaf(rep)
        rep_nc = self._num_children(rep)
        rep_name = self._name(rep, False)
        if (rep_is_group and rep_nc == 1 and rep_name != "array"
                and rep_name != list_name + "_tuple"):
            maps.schema_map.append(state[0])
            maps.schema_num_children.append(1)
            state[0] += 1
            found._filter(schema, ignore_case, state, maps)
        else:
            found._filter(schema, ignore_case, state, maps)

    def _filter_map(self, schema, ignore_case, state, maps):
        key_found = self.children["key"]
        value_found = self.children["value"]
        elem = schema[state[0]]
        if self._is_leaf(elem):
            raise PruneError("expected a map item, but found a single value")
        if elem.get(SE.CONVERTED_TYPE) not in (CONVERTED_MAP,
                                               CONVERTED_MAP_KEY_VALUE):
            raise PruneError("expected a map type, but it was not found")
        if self._num_children(elem) != 1:
            raise PruneError("the structure of the outer map group is not standard")
        maps.schema_map.append(state[0])
        maps.schema_num_children.append(1)
        state[0] += 1

        rep = schema[state[0]]
        if rep.get(SE.REPETITION_TYPE) != REPETITION_REPEATED:
            raise PruneError("found non repeating map child")
        rep_nc = self._num_children(rep)
        if rep_nc not in (1, 2):
            raise PruneError("found map with wrong number of children")
        maps.schema_map.append(state[0])
        maps.schema_num_children.append(rep_nc)
        state[0] += 1
        key_found._filter(schema, ignore_case, state, maps)
        if rep_nc == 2:
            value_found._filter(schema, ignore_case, state, maps)


# -- row-group filtering ----------------------------------------------------

def _chunk_offset(chunk: Struct) -> int:
    """First-page offset of a column chunk (get_offset, NativeParquetJni.cpp:455-462)."""
    md = chunk.get(CC.META_DATA)
    off = md.get(CMD.DATA_PAGE_OFFSET, 0)
    dict_off = md.get(CMD.DICTIONARY_PAGE_OFFSET)
    if dict_off is not None and off > dict_off:
        off = dict_off
    return off


def _invalid_file_offset(start, pre_start, pre_size) -> bool:
    """PARQUET-2078 detection (NativeParquetJni.cpp:439-453)."""
    if pre_start == 0 and start != 4:
        return True
    return start < pre_start + pre_size


def filter_groups(meta: Struct, part_offset: int, part_length: int) -> list[Struct]:
    """Keep row groups whose midpoint falls in the split
    (filter_groups, NativeParquetJni.cpp:464-519)."""
    groups = meta.get(FMD.ROW_GROUPS)
    if groups is None or not len(groups):
        return []
    first_has_md = groups.values[0].get(RG.COLUMNS).values[0].has(CC.META_DATA)
    pre_start = 0
    pre_size = 0
    out = []
    for rg in groups.values:
        cols = rg.get(RG.COLUMNS)
        if first_has_md:
            start = _chunk_offset(cols.values[0])
        else:
            # file_offset of the first block holds the truth; later blocks
            # may not (PARQUET-2078)
            start = rg.get(RG.FILE_OFFSET, 0)
            if _invalid_file_offset(start, pre_start, pre_size):
                start = 4 if pre_start == 0 else pre_start + pre_size
            pre_start = start
            pre_size = rg.get(RG.TOTAL_COMPRESSED_SIZE, 0)
        total = rg.get(RG.TOTAL_COMPRESSED_SIZE)
        if total is None:
            total = sum(c.get(CC.META_DATA).get(CMD.TOTAL_COMPRESSED_SIZE, 0)
                        for c in cols.values)
        mid = start + total // 2
        if part_offset <= mid < part_offset + part_length:
            out.append(rg)
    return out


def filter_columns(groups: list[Struct], chunk_map: list[int]) -> None:
    """Gather surviving column chunks per row group
    (filter_columns, NativeParquetJni.cpp:552-560)."""
    for rg in groups:
        cols = rg.get(RG.COLUMNS)
        rg.get_field(RG.COLUMNS).value = ListValue(
            TType.STRUCT, [cols.values[i] for i in chunk_map])


# -- public API (ParquetFooter.java surface) --------------------------------

class ParquetFooter:
    """A parsed + filtered footer handle (ParquetFooter.java:27,95-130)."""

    def __init__(self, meta: Struct):
        self._meta = meta

    @property
    def num_rows(self) -> int:
        groups = self._meta.get(FMD.ROW_GROUPS)
        return sum(rg.get(RG.NUM_ROWS, 0) for rg in groups.values) if groups else 0

    @property
    def num_columns(self) -> int:
        schema = self._meta.get(FMD.SCHEMA)
        if schema is None or not len(schema):
            return 0
        return schema.values[0].get(SE.NUM_CHILDREN, 0) or 0

    def serialize_thrift_file(self) -> bytes:
        """"PAR1" + thrift + u32 length + "PAR1" (NativeParquetJni.cpp:666-699)."""
        body = serialize_struct(self._meta)
        return MAGIC + body + _struct.pack("<I", len(body)) + MAGIC


@fault_site("parquet_read_and_filter")
def read_and_filter(buf: bytes, part_offset: int, part_length: int,
                    schema: SchemaNode, ignore_case: bool = False) -> ParquetFooter:
    """Parse a raw footer thrift blob, prune columns, filter row groups.

    Mirrors ``Java_..._ParquetFooter_readAndFilter``
    (NativeParquetJni.cpp:568-626).  ``part_length < 0`` keeps all groups.
    """
    meta = parse_struct(buf)
    pruner = ColumnPruner.from_tree(schema, fold_case=ignore_case)
    schema_list = meta.get(FMD.SCHEMA)
    if schema_list is None:
        raise ValueError("footer has no schema")
    maps = pruner.filter_schema(schema_list.values, ignore_case)

    # gather + rewrite schema num_children
    new_schema = []
    for idx, n_c in zip(maps.schema_map, maps.schema_num_children):
        elem = schema_list.values[idx]
        if elem.has(SE.NUM_CHILDREN):
            elem.set(SE.NUM_CHILDREN, TType.I32, n_c)
        elif n_c:
            elem.set(SE.NUM_CHILDREN, TType.I32, n_c)
        new_schema.append(elem)
    meta.get_field(FMD.SCHEMA).value = ListValue(TType.STRUCT, new_schema)

    orders = meta.get(FMD.COLUMN_ORDERS)
    if orders is not None:
        meta.get_field(FMD.COLUMN_ORDERS).value = ListValue(
            orders.elem_type, [orders.values[i] for i in maps.chunk_map])

    groups_field = meta.get_field(FMD.ROW_GROUPS)
    if part_length >= 0 and groups_field is not None:
        kept = filter_groups(meta, part_offset, part_length)
        groups_field.value = ListValue(TType.STRUCT, kept)
    if groups_field is not None:
        filter_columns(groups_field.value.values, maps.chunk_map)
    return ParquetFooter(meta)


def extract_footer_bytes(file_bytes: bytes) -> bytes:
    """Pull the raw thrift footer out of a full parquet file."""
    if file_bytes[:4] != MAGIC or file_bytes[-4:] != MAGIC:
        raise ValueError("not a parquet file (missing PAR1 magic)")
    (length,) = _struct.unpack("<I", file_bytes[-8:-4])
    return file_bytes[-8 - length:-8]
