"""Parquet for the PyTorch port: footer parse and prune (host) and the
device scan (``device_scan.scan_table``)."""

from .footer import (  # noqa: F401
    ParquetFooter, StructElement, ValueElement, ListElement, MapElement,
    read_and_filter,
)
